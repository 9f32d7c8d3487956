"""Nested-dict <-> flat-dict helpers used by checkpoint loading."""

from __future__ import annotations

from typing import Any, Dict


def flatten_dict(tree: Any, sep: str = ".", _prefix: str = "") -> Dict[str, Any]:
    """Flatten a nested dict/list tree into ``{"a.b.0.c": leaf}``."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {_prefix.rstrip(sep): tree} if _prefix else {"": tree}
    for k, v in items:
        key = f"{_prefix}{k}"
        if isinstance(v, (dict, list, tuple)) and len(v) > 0:
            out.update(flatten_dict(v, sep=sep, _prefix=key + sep))
        else:
            out[key] = v
    return out


def unflatten_dict(flat: Dict[str, Any], sep: str = ".") -> Dict[str, Any]:
    """Inverse of :func:`flatten_dict`. List nodes come back as dicts keyed
    by stringified indices (:func:`lists_from_index_dicts` restores them)."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(sep)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def lists_from_index_dicts(tree: Any) -> Any:
    """Turn every dict whose keys are exactly ``"0".."n-1"`` into a list
    (the ``layers`` node of an unflattened checkpoint)."""
    if not isinstance(tree, dict):
        return tree
    node = {k: lists_from_index_dicts(v) for k, v in tree.items()}
    if node and sorted(node) == sorted(str(i) for i in range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node
