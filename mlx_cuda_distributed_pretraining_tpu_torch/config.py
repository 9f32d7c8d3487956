"""The parts of the YAML config schema that serving reads.

Same section layout as the JAX package's ``config.py`` (``data`` / ``model``
plus ``name``); the training, logging and system sections are kept as raw
dicts because nothing in the port reads them yet. ``yaml`` is imported only
when a YAML path is given, so code that builds configs in Python needs no
PyYAML.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


def _get(d: Optional[Dict[str, Any]], key: str, default: Any = None) -> Any:
    if d is None:
        return default
    v = d.get(key, default)
    return default if v is None else v


@dataclass
class DataConfig:
    """Section ``data`` (only the tokenizer fields are read)."""

    input_file: Optional[str] = None
    preprocessing: Dict[str, Any] = field(default_factory=dict)
    tokenizer: Dict[str, Any] = field(default_factory=dict)
    tokenizer_path: Optional[str] = None
    validation_file: Optional[str] = None


@dataclass
class ModelConfig:
    """Section ``model``: the fields ``LlamaArgs.from_config`` reads."""

    architecture: str = "llama"
    dimensions: Dict[str, Any] = field(default_factory=dict)
    attention: Dict[str, Any] = field(default_factory=dict)
    normalization: Dict[str, Any] = field(default_factory=dict)
    rope: Dict[str, Any] = field(default_factory=dict)
    misc: Dict[str, Any] = field(default_factory=dict)
    moe: Dict[str, Any] = field(default_factory=dict)
    matmul_precision: Optional[str] = None

    @property
    def hidden_size(self) -> int:
        return int(_get(self.dimensions, "hidden_size", 128))

    @property
    def intermediate_size(self) -> int:
        return int(_get(self.dimensions, "intermediate_size",
                        4 * self.hidden_size))

    @property
    def num_layers(self) -> int:
        return int(_get(self.dimensions, "num_layers", 4))

    @property
    def num_heads(self) -> int:
        return int(_get(self.attention, "num_heads", 8))

    @property
    def num_kv_heads(self) -> int:
        return int(_get(self.attention, "num_kv_heads", self.num_heads))

    @property
    def head_dim(self) -> int:
        return int(_get(self.attention, "head_dim",
                        self.hidden_size // self.num_heads))


def _build_section(cls, raw: Optional[Dict[str, Any]]):
    """Known keys become fields; unknown ones are ignored (configs carry
    training-side keys the port does not read)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dict(raw or {}).items() if k in names})


@dataclass
class Config:
    """Top-level config: ``name``, ``data``, ``model``; other sections raw."""

    name: str
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    sections: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, config_dict: Dict[str, Any]) -> "Config":
        if "name" not in config_dict:
            raise ValueError("Config must specify a 'name' field at the top level")
        return cls(
            name=config_dict["name"],
            data=_build_section(DataConfig, config_dict.get("data")),
            model=_build_section(ModelConfig, config_dict.get("model")),
            sections={k: v for k, v in config_dict.items()
                      if k not in ("name", "data", "model")},
        )

    @classmethod
    def from_yaml(cls, yaml_path: str) -> "Config":
        import yaml

        with open(yaml_path, "r") as f:
            return cls.from_dict(yaml.safe_load(f))
