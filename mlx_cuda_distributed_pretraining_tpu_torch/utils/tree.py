"""Nested dict/list trees: flat-dict conversion for checkpoints and
traversal in the JAX pytree order."""

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


def leaves_with_path(tree: Any, _path: tuple = ()) -> list:
    """``[(path, leaf)]`` in the JAX pytree order (dict keys sorted, lists in
    order); ``path`` is the tuple of keys, list indices as strings."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in leaves_with_path(tree[k], _path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in leaves_with_path(v, _path + (str(i),))]
    return [(_path, tree)]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict/list tree, or to the
    matching leaves of several trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)
