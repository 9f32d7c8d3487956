"""Mask constants shared by the attention code (the JAX package's
``ops/masks.py`` also holds traceable mask programs; the serving path only
needs the fill value)."""

from __future__ import annotations

NEG_INF = -1e30  # large-but-finite: keeps softmax well-defined on fully-masked rows
