"""The YAML config schema: the sections serving and training read.

Same section layout and defaults as the JAX package's ``config.py``
(``data / model / training / logging / system / supervisor / resume`` plus ``name`` and
``overwrite``); keys a section does not know are kept beside it and written
back out, so a config passes through the port unchanged.

:meth:`Config.to_yaml` needs no PyYAML: it writes JSON, which is YAML, with
every float spelled with a dot (``1.0e-05``) because PyYAML's YAML 1.1
resolver reads ``1e-05`` as a string. :meth:`Config.from_yaml` tries JSON
first and imports ``yaml`` only for other files (``utils/yaml_lite.py``
where PyYAML is absent).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


def _get(d: Optional[Dict[str, Any]], key: str, default: Any = None) -> Any:
    if d is None:
        return default
    v = d.get(key, default)
    return default if v is None else v


@dataclass
class DataConfig:
    """Section ``data``."""

    input_file: Optional[str] = None
    preprocessing: Dict[str, Any] = field(default_factory=dict)
    tokenizer: Dict[str, Any] = field(default_factory=dict)
    tokenizer_path: Optional[str] = None
    validation_file: Optional[str] = None
    source: str = "jsonl"  # "jsonl" | "hf_stream" | "synthetic" | "webdataset" | "token_shards"
    streaming: Dict[str, Any] = field(default_factory=dict)
    # Batches kept on the device ahead of the step loop by
    # data/device_prefetch.py; 0 copies each batch inside the loop.
    prefetch_depth: int = 2

    @property
    def max_context_size(self) -> int:
        return int(_get(self.preprocessing, "max_context_size", 1024))

    @property
    def chunk_overlap(self) -> int:
        return int(_get(self.preprocessing, "chunk_overlap", 0))


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
    remat_policy: Optional[str] = None
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

    @property
    def attention_type(self) -> str:
        """"simple" | "flash" | "flex" | "ring", with the JAX package's
        precedence (ring > flex > flash > attention_type key)."""
        if _get(self.attention, "use_ring_attention", False):
            return "ring"
        if _get(self.attention, "use_flex_attention", False):
            return "flex"
        if _get(self.attention, "use_flash_attention", False):
            return "flash"
        return str(_get(self.attention, "attention_type", "simple"))


@dataclass
class TrainingConfig:
    """Section ``training``."""

    hyperparameters: Dict[str, Any] = field(default_factory=dict)
    scheduler: Dict[str, Any] = field(default_factory=dict)
    optimization: Dict[str, Any] = field(default_factory=dict)
    epochs: Optional[int] = None
    early_stopping: Dict[str, Any] = field(default_factory=dict)

    @property
    def batch_size(self) -> int:
        return int(_get(self.hyperparameters, "batch_size", 16))

    @property
    def learning_rate(self) -> float:
        return float(_get(self.hyperparameters, "learning_rate", 3e-4))

    @property
    def weight_decay(self) -> float:
        return float(_get(self.hyperparameters, "weight_decay", 0.0))

    @property
    def iters(self) -> Optional[int]:
        v = _get(self.hyperparameters, "iters", None)
        return None if v is None else int(v)

    @property
    def gradient_clip(self) -> Optional[float]:
        v = _get(self.hyperparameters, "gradient_clip", None)
        return None if v is None else float(v)

    @property
    def gradient_accumulation_steps(self) -> int:
        return int(_get(self.hyperparameters, "gradient_accumulation_steps", 1))

    @property
    def optimizer_name(self) -> str:
        return str(_get(self.optimization, "optimizer", "adamw")).lower()


@dataclass
class LoggingConfig:
    """Section ``logging``: intervals, checkpoint retention, samples and the
    telemetry keys, as the JAX package reads them.

    ``tensorboard`` / ``wandb`` (with ``wandb_project``, ``wandb_entity``):
    the logger's optional sinks, each gated on its import.
    ``profile_start`` / ``profile_stop``: a ``torch.profiler`` capture of
    steps [start, stop) into ``<run_dir>/profile/``. ``metrics_port``: the
    Prometheus exposition of the trainer's registry; 0 off. ``trace``:
    ``{enabled, sample, capacity, capture_steps}`` for the span tracer
    (``capture_steps`` sizes the SIGUSR2 window). ``profile_report``:
    ``{enabled, top_k}`` for the attribution at each capture's stop.
    ``events``: ``{max_bytes}``, the ``events.jsonl`` rotation bound (0:
    unbounded). ``metrics.stats_url``: a stats hub to publish to."""

    log_dir: str = "logs"
    checkpoint_dir: str = "checkpoints"
    steps: Dict[str, Any] = field(default_factory=dict)
    metrics: Dict[str, Any] = field(default_factory=dict)
    tensorboard: bool = False
    wandb: bool = False
    wandb_project: Optional[str] = None
    wandb_entity: Optional[str] = None
    log_gradient_norm: bool = False
    retention: Dict[str, Any] = field(default_factory=dict)
    log_samples: bool = False  # greedy samples at each validation step
    log_samples_count: int = 3
    profile_start: int = 0
    profile_stop: int = 0
    metrics_port: int = 0
    trace: Dict[str, Any] = field(default_factory=dict)
    profile_report: Dict[str, Any] = field(default_factory=dict)
    events: Dict[str, Any] = field(default_factory=dict)

    @property
    def events_max_bytes(self) -> int:
        return int(_get(self.events, "max_bytes", 0))

    @property
    def stats_url(self) -> Optional[str]:
        url = _get(self.metrics, "stats_url", None)
        return str(url) if url else None

    @property
    def profile_report_enabled(self) -> bool:
        return bool(_get(self.profile_report, "enabled", True))

    @property
    def profile_report_top_k(self) -> int:
        return int(_get(self.profile_report, "top_k", 12))

    @property
    def logging_interval(self) -> int:
        return int(_get(self.steps, "logging_interval", 1))

    @property
    def checkpoint_interval(self) -> int:
        return int(_get(self.steps, "checkpoint_interval", 1000))

    @property
    def validation_interval(self) -> int:
        return int(_get(self.steps, "validation_interval", 0))

    @property
    def keep_last(self) -> int:
        """Retention GC: keep the newest N manifested steps (0: keep all)."""
        return int(_get(self.retention, "keep_last", 0))

    @property
    def keep_every(self) -> int:
        """Retention GC: always keep steps divisible by M (0: off)."""
        return int(_get(self.retention, "keep_every", 0))


@dataclass
class SystemConfig:
    """Section ``system``: seed, precision, the device layout and the
    training-path switches.

    Only the keys the trainer reads are fields. Others (the reference's
    ``device``, ``precision``, ...) stay in ``_extras`` for the round trip:
    the device is the Trainer's ``device`` argument, not this section. The
    port trains on one device: the Trainer refuses a ``mesh`` (or legacy
    ``model_parallel``) that needs more."""

    seed: int = 42
    mesh: Dict[str, int] = field(default_factory=dict)
    model_parallel: bool = False
    model_parallel_size: int = 1
    mixed_precision: bool = False
    gradient_checkpointing: bool = False
    gradient_checkpointing_ratio: float = 0.5  # share of layers remat wraps
    remat: Optional[str] = None
    fused_ce_chunk: int = -1
    compute_dtype: Optional[str] = None
    scan_layers: bool = False
    overlap_gather: bool = False
    async_checkpointing: bool = True  # interval saves write in the background

    def __post_init__(self):
        if self.compute_dtype is None:
            self.compute_dtype = "bfloat16" if self.mixed_precision else "float32"
        else:
            norm = str(self.compute_dtype).lower()
            if norm in ("bfloat16", "bf16", "float16", "fp16", "half"):
                self.compute_dtype = "bfloat16"
            elif norm in ("float32", "fp32", "float"):
                self.compute_dtype = "float32"
            else:
                raise ValueError(
                    f"unknown system.compute_dtype: {self.compute_dtype!r} "
                    "(expected bfloat16/float16/float32)")


@dataclass
class SupervisorConfig:
    """Section ``supervisor``: the auto-resume supervisor's hang watchdog
    (``train/supervisor.py``). When the trainer's heartbeat makes no
    progress for ``hang_timeout_s`` seconds the child is SIGTERMed, then
    SIGKILLed after ``hang_kill_grace_s``, and restarted from the newest
    verified checkpoint; 0 disables the watchdog. ``barrier_timeout_s``
    bounds the multi-host generation barrier, which the port does not run
    (ROADMAP queue 1 item 10); it is kept for the round trip."""

    hang_timeout_s: float = 0.0
    hang_kill_grace_s: float = 20.0
    barrier_timeout_s: float = 300.0


@dataclass
class ResumeConfig:
    """Section ``resume``: ``checkpoint`` is a step tag, or "latest" for the
    newest verified one; ``strict`` raises where a checkpoint is missing or
    fails verification instead of falling back."""

    checkpoint: str = ""
    reset_optimizer: bool = False
    reset_training_state: bool = False
    strict: bool = False


_SECTION_TYPES = {
    "data": DataConfig,
    "model": ModelConfig,
    "training": TrainingConfig,
    "logging": LoggingConfig,
    "system": SystemConfig,
    "supervisor": SupervisorConfig,
}


def _build_section(cls, raw: Optional[Dict[str, Any]]):
    """Known keys become fields; unknown ones are kept in ``_extras`` and
    written back by :meth:`Config.to_dict`."""
    raw = dict(raw or {})
    names = {f.name for f in dataclasses.fields(cls)}
    obj = cls(**{k: v for k, v in raw.items() if k in names})
    extras = {k: v for k, v in raw.items() if k not in names}
    if extras:
        object.__setattr__(obj, "_extras", extras)
    return obj


def _yaml_safe_json(obj: Any, indent: str = "") -> str:
    """JSON text that PyYAML's safe_load reads back to the same values:
    floats always carry a dot before any exponent."""
    inner = indent + "  "
    if isinstance(obj, dict):
        if not obj:
            return "{}"
        items = [f"{inner}{json.dumps(str(k))}: {_yaml_safe_json(v, inner)}"
                 for k, v in obj.items()]
        return "{\n" + ",\n".join(items) + f"\n{indent}}}"
    if isinstance(obj, (list, tuple)):
        if not obj:
            return "[]"
        return ("[\n" + ",\n".join(inner + _yaml_safe_json(v, inner) for v in obj)
                + f"\n{indent}]")
    if isinstance(obj, float):
        if not math.isfinite(obj):
            raise ValueError(f"config value {obj!r} has no JSON spelling")
        text = repr(obj)
        mantissa, e, exp = text.partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        return mantissa + e + exp
    return json.dumps(obj)


@dataclass
class Config:
    """Top-level config."""

    name: str
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    system: SystemConfig = field(default_factory=SystemConfig)
    supervisor: SupervisorConfig = field(default_factory=SupervisorConfig)
    resume: Optional[ResumeConfig] = None
    overwrite: bool = False
    sections: Dict[str, Any] = field(default_factory=dict)  # others, raw

    @classmethod
    def from_dict(cls, config_dict: Dict[str, Any]) -> "Config":
        if "name" not in config_dict:
            raise ValueError("Config must specify a 'name' field at the top level")
        resume = None
        if config_dict.get("resume"):
            resume = _build_section(ResumeConfig, config_dict["resume"])
        return cls(
            name=config_dict["name"],
            overwrite=bool(config_dict.get("overwrite", False)),
            resume=resume,
            sections={k: v for k, v in config_dict.items()
                      if k not in _SECTION_TYPES
                      and k not in ("name", "overwrite", "resume")},
            **{key: _build_section(typ, config_dict.get(key))
               for key, typ in _SECTION_TYPES.items()},
        )

    @classmethod
    def from_yaml(cls, yaml_path: str) -> "Config":
        return cls.from_dict(read_config_dict(yaml_path))

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, "overwrite": self.overwrite}
        for key in _SECTION_TYPES:
            section = getattr(self, key)
            d = dataclasses.asdict(section)
            d.update(getattr(section, "_extras", {}))
            out[key] = d
        if self.resume is not None:
            out["resume"] = dataclasses.asdict(self.resume)
        out.update(self.sections)
        return out

    def to_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(_yaml_safe_json(self.to_dict()) + "\n")


def read_config_dict(path: str) -> Dict[str, Any]:
    """A config file as a dict: JSON when it parses as JSON, else YAML
    (through PyYAML, or ``utils/yaml_lite.py`` on a host without it)."""
    with open(path, "r") as f:
        text = f.read()
    try:
        return json.loads(text)
    except ValueError:
        pass
    try:
        import yaml
    except ImportError:
        from .utils.yaml_lite import safe_load

        return safe_load(text)
    return yaml.safe_load(text)


def apply_overrides(config_dict: Dict[str, Any],
                    overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Dotted-path overrides, e.g. ``{"training.hyperparameters.iters": 30}``."""
    out = dict(config_dict)
    for path, value in overrides.items():
        parts = path.split(".")
        node = out
        for p in parts[:-1]:
            nxt = node.get(p)
            node[p] = dict(nxt) if isinstance(nxt, dict) else {}
            node = node[p]
        node[parts[-1]] = value
    return out
