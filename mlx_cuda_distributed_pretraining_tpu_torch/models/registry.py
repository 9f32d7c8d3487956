"""Architecture registry: what ``model.architecture`` names.

The port's own copy of the JAX package's ``models/registry.py``, with the
same names, built-ins and error text. Every architecture provides
``(args_cls, init_params, forward, loss_fn)``; "llama_standard" is llama
with simple attention forced, "llama_flash" llama with flash attention
forced. The trainer resolves ``model.architecture`` here, so an unknown
name raises ``ValueError`` before any model is built.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple


class Architecture(NamedTuple):
    name: str
    args_cls: Any
    init_params: Callable
    forward: Callable
    loss_fn: Callable
    force_attention: str | None = None


_REGISTRY: Dict[str, Architecture] = {}


def register(arch: Architecture) -> None:
    _REGISTRY[arch.name] = arch


def resolve_architecture(name: str) -> Architecture:
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown architecture {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def _register_builtin() -> None:
    from . import llama

    base = Architecture("llama", llama.LlamaArgs, llama.init_params, llama.forward, llama.loss_fn)
    register(base)
    register(base._replace(name="llama_standard", force_attention="simple"))
    register(base._replace(name="llama_flash", force_attention="flash"))


_register_builtin()
