"""The current mesh: lets model code deep in the forward reach the mesh the
trainer built, as the JAX package's ``parallel/context.py`` does.

A long-lived *base* slot owned by whoever calls :func:`set_mesh` (the
trainer), and a scoped stack pushed by :func:`use_mesh` that shadows it.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

_BASE: list = [None]
_SCOPED: list = []


def current_mesh() -> Optional[Any]:
    return _SCOPED[-1] if _SCOPED else _BASE[0]


@contextlib.contextmanager
def use_mesh(mesh: Optional[Any]):
    _SCOPED.append(mesh)
    try:
        yield mesh
    finally:
        _SCOPED.pop()


def set_mesh(mesh: Optional[Any]) -> None:
    """The non-scoped slot, for the trainer's lifetime."""
    _BASE[0] = mesh
