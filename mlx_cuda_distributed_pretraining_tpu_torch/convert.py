"""Carry parameters from the JAX package's layout into the port.

The port keeps the JAX layout exactly (``x @ W`` with ``W [in, out]``,
expert banks ``[E, in, out]``, the same nested names), so conversion is a
per-leaf copy with no transposes: a nested dict/list of numpy arrays (e.g.
``jax.tree_util.tree_map(np.asarray, params)``) or a flat safetensors dict
(``layers.3.feed_forward.experts.w_gate.weight``) becomes the port's nested
dict of tensors. :func:`opt_state_from_jax` does the same for an optimizer
state (any of the JAX states the port mirrors: the chains' lists, the
``{label: state}`` of a partition with ``None`` where another label owns a
parameter, Muon's ``mu``, Lion's ``mu``, Shampoo's statistics and roots,
the EMA shadow), keeping the step counters on the CPU as the port keeps
them; :func:`opt_state_to_jax` is its inverse.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .utils.tree import lists_from_index_dicts, unflatten_dict


def _to_tensor(leaf: Any, device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: carry the raw bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def params_from_jax(tree: Any, device="cuda") -> Any:
    """Nested dict/list tree of numpy arrays -> the same tree of tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _to_tensor(tree, device)


def params_from_flat(flat: Dict[str, Any], device="cuda") -> Any:
    """Flat ``{"layers.0.attention.wq.weight": array}`` (a checkpoint file's
    contents) -> nested params with ``layers`` as a list."""
    return params_from_jax(lists_from_index_dicts(unflatten_dict(flat)), device)


def opt_state_from_jax(state: Any, device="cuda") -> Any:
    """A JAX optimizer state as numpy (``jax.tree_util.tree_map(np.asarray,
    state)``) -> the port's: arrays become tensors on ``device``, except the
    0-dim integer step counters, which stay on the CPU; the empty states of
    stateless links stay ``{}``."""
    if isinstance(state, dict):
        return {k: opt_state_from_jax(v, device) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [opt_state_from_jax(v, device) for v in state]
    if state is None:  # a parameter another label of a partition owns
        return None
    arr = np.asarray(state)
    if arr.ndim == 0 and np.issubdtype(arr.dtype, np.integer):
        return torch.tensor(int(arr), dtype=torch.int32)
    return _to_tensor(arr, device)


def opt_state_to_jax(state: Any) -> Any:
    """The port's optimizer state -> the JAX package's as numpy (a
    ``jax.tree_util.tree_map(jnp.asarray, ...)`` away from a live JAX
    state): tensors become arrays (bf16 through their bits), the int32
    counters 0-dim int32 arrays, ``None`` and empty states stay."""
    if isinstance(state, dict):
        return {k: opt_state_to_jax(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [opt_state_to_jax(v) for v in state]
    if not isinstance(state, torch.Tensor):
        return state
    t = state.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # a JAX install has it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()
