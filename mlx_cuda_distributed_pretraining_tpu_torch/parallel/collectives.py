"""Shards and collectives over a :class:`~.mesh.Mesh` for the specs of
``sharding_rules``: a leaf's local shard, the full leaf gathered back, and
the sums over the axes a leaf is replicated on.

A tensor with spec ``P(None, "fsdp")`` on a mesh with fsdp 4 is held by
each rank as the ``[:, i*n/4:(i+1)*n/4]`` block, ``i`` its fsdp coordinate
(JAX's block layout). An axis of size 1 communicates nothing, so on a
one-rank mesh every function here is the identity and needs no process
group.

Tensor parallelism (``tp``) is written out Megatron style, as autograd
functions over the tp group (:class:`Tp`): ``copy`` (identity forward,
all-reduce backward) before a column-parallel projection, ``reduce``
(all-reduce forward, identity backward) after a row-parallel one, a
vocab-parallel embedding lookup, and two all-gathers: ``gather`` for a
tensor every tp rank then uses alike (the logits; its backward keeps this
rank's block of the gradient) and ``gather_sum`` for one each rank uses
its own part of (K/V heads that do not split over tp; its backward sums
the ranks' gradients and keeps this rank's block).

Expert parallelism (``ep``) exchanges rows with :func:`all_to_all`: an
equal-split exchange over one axis's group whose backward is the same
exchange of the gradients.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh


def spec_axes(spec) -> Tuple[Tuple[int, str], ...]:
    """``((dim, axis), ...)`` for every named entry of a spec (a tuple
    entry names several axes on one dim, major first)."""
    out = []
    for i, entry in enumerate(spec or ()):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out.append((i, a))
    return tuple(out)


def shard_of(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` (a view)."""
    x = full
    for d, a in spec_axes(spec):
        n = mesh.axis_size(a)
        if n > 1:
            size = x.shape[d] // n
            x = x.narrow(d, mesh.coord(a) * size, size)
    return x


def block_index(spec, shape, mesh) -> Tuple[slice, ...]:
    """The slices of a full ``shape`` that make this rank's block
    (:func:`shard_of`'s, as an index)."""
    start, size = [0] * len(shape), list(shape)
    for d, a in spec_axes(spec):
        n = mesh.axis_size(a)
        if n > 1:
            size[d] //= n
            start[d] += mesh.coord(a) * size[d]
    return tuple(slice(b, b + n) for b, n in zip(start, size))


def reduce_scatter_flat(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """Sum ``inp`` over ``group`` and keep this rank's ``out``-sized block
    (``reduce_scatter_single`` where this torch has it; its older name
    ``reduce_scatter_tensor`` warns that it is deprecated there)."""
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, inp, group=group)


def gather_dim(local: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """All-gather ``local`` along ``dim`` over ``group`` (blocks in rank
    order)."""
    local = local.contiguous()
    out = local.new_empty((n * local.numel(),))
    dist.all_gather_into_tensor(out, local.reshape(-1), group=group)
    out = out.view(n, *local.shape).movedim(0, dim)
    shape = list(local.shape)
    shape[dim] *= n
    return out.reshape(shape)


def gather_full(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's block (a collective over the axes
    of ``spec``); ``local`` itself when the spec splits nothing here."""
    x = local
    for d, a in reversed(spec_axes(spec)):
        n = mesh.axis_size(a)
        if n > 1:
            x = gather_dim(x, d, mesh.group(a), n)
    return x


def gather_to_chief(local: torch.Tensor, spec, mesh) -> Optional[torch.Tensor]:
    """The full tensor on rank 0 from every rank's block, None on the other
    ranks (a collective all ranks run): one gather over the world, each
    block placed at its rank's coordinates. A leaf the spec splits over no
    axis is whole on rank 0 already. On gloo a CUDA block travels through a
    host buffer."""
    split = [(d, a) for d, a in spec_axes(spec) if mesh.axis_size(a) > 1]
    if not split:
        return local if mesh.rank == 0 else None
    src = local.contiguous()
    if src.is_cuda and dist.get_backend() == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)] if mesh.rank == 0 else None
    dist.gather(src, parts, dst=0)
    if parts is None:
        return None
    shape = list(local.shape)
    for d, a in split:
        shape[d] *= mesh.axis_size(a)
    full = src.new_empty(shape)
    for r, part in enumerate(parts):
        full[block_index(spec, shape, Mesh(mesh.shape, rank=r))] = part
    return full.to(local.device)


def world_group(mesh, axes: Sequence[str]):
    """One group for a set of axes when it spans the whole mesh (the default
    group), else None."""
    if set(a for a in axes if mesh.axis_size(a) > 1) == set(mesh.active_axes()):
        return dist.group.WORLD
    return None


def all_reduce_axes(t: torch.Tensor, mesh, axes: Iterable[str]) -> torch.Tensor:
    """Sum ``t`` in place over the ranks of ``axes`` (one all-reduce when
    they span the mesh, else one per axis)."""
    axes = [a for a in axes if mesh.axis_size(a) > 1]
    if not axes:
        return t
    group = world_group(mesh, axes)
    if group is not None:
        dist.all_reduce(t, group=group)
    else:
        for a in axes:
            dist.all_reduce(t, group=mesh.group(a))
    return t


def all_reduce_bucketed(tensors: List[torch.Tensor], mesh, axes: Iterable[str]) -> None:
    """Sum a list of tensors in place over ``axes`` through one flat buffer
    per dtype."""
    axes = [a for a in axes if mesh.axis_size(a) > 1]
    if not axes or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_axes(flat, mesh, axes)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def is_representative(spec, mesh, axes: Optional[Sequence[str]] = None) -> bool:
    """True on the one rank of each replica set of a leaf with ``spec``:
    coordinate 0 on every axis (of ``axes``, all by default) the spec does
    not split. Summing a per-shard quantity over the ranks where this holds
    counts every element once."""
    split = {a for _, a in spec_axes(spec)}
    for a in (axes if axes is not None else mesh.axis_names):
        if a not in split and mesh.axis_size(a) > 1 and mesh.coord(a) != 0:
            return False
    return True


def sharded_sum_squares(leaves: Sequence[Tuple[torch.Tensor, Any]], mesh) -> torch.Tensor:
    """``sum(x**2)`` in fp32 over the full tensors behind ``[(local,
    spec)]``, the same on every rank: each rank adds the shards it
    represents, then one all-reduce over the mesh."""
    total = None
    for x, spec in leaves:
        if x is None:
            continue
        s = torch.sum(torch.square(x.float()))
        if not is_representative(spec, mesh):
            s = torch.zeros_like(s)
        total = s if total is None else total + s
    if total is None:
        total = torch.zeros((), dtype=torch.float32)
    return all_reduce_axes(total, mesh, mesh.axis_names)


# -- tensor parallelism -------------------------------------------------------------
class Tp:
    """The tp axis of a mesh (or another ``axis``): ``n`` ranks, this rank's
    ``coord``, the process ``group``."""

    def __init__(self, mesh, axis: str = "tp"):
        self.mesh = mesh
        self.n = mesh.axis_size(axis)
        self.coord = mesh.coord(axis)
        self.group = mesh.group(axis)

    def block(self, full: int) -> Tuple[int, int]:
        """``(start, size)`` of this rank's block of a dim of ``full``."""
        size = full // self.n
        return self.coord * size, size

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToTp.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromTp.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return _GatherTp.apply(x, dim % x.dim(), self, False)

    def gather_sum(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return _GatherTp.apply(x, dim % x.dim(), self, True)

    def embed(self, weight: torch.Tensor, ids: torch.Tensor,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Rows ``ids`` of a vocab-parallel table (this rank's ``[V/n, D]``
        block), cast to ``dtype`` after the lookup: each rank looks up the
        ids in its block, zeros elsewhere, then the sum over tp."""
        lo, size = self.block(weight.shape[0] * self.n)
        local = ids.long() - lo
        inside = (local >= 0) & (local < size)
        rows = weight[local.clamp(0, size - 1)].to(dtype or weight.dtype)
        return self.reduce(rows * inside[..., None].to(rows.dtype))


def tp_of(mesh) -> Optional[Tp]:
    """The mesh's tp axis, or None when it has one rank or less."""
    if mesh is None or mesh.axis_size("tp") <= 1:
        return None
    return Tp(mesh)


def _all_reduce_copy(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_copy(grad, ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_copy(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp, summed):
        ctx.dim, ctx.tp, ctx.summed = dim, tp, summed
        return gather_dim(x, dim, tp.group, tp.n)

    @staticmethod
    def backward(ctx, grad):
        tp, dim = ctx.tp, ctx.dim
        if ctx.summed:
            grad = _all_reduce_copy(grad, tp.group)
        lo, size = tp.block(grad.shape[dim])
        return grad.narrow(dim, lo, size).contiguous(), None, None, None


# -- expert parallelism -------------------------------------------------------------
# This process's all_to_all exchanges: calls, and bytes it sent (its own
# block included), forward and backward.
EXCHANGES = {"calls": 0, "bytes": 0}


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` with equal splits of dim 0: block i of this
    rank's ``x`` goes to rank i of ``group``, and block i of the result
    came from rank i. The bytes travel as ``uint8`` (any dtype, gloo's
    included). A CUDA tensor on a gloo group is staged through host
    buffers here (gloo runs its collectives on the host), so the exchange
    never turns into a gather of every rank's rows."""
    x = x.contiguous()
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    src = x.cpu() if staged else x
    raw = src.view(torch.uint8).reshape(src.shape[0], -1)
    out = torch.empty_like(raw)
    dist.all_to_all_single(out, raw, group=group)
    EXCHANGES["calls"] += 1
    EXCHANGES["bytes"] += raw.numel()
    return out.view(src.dtype).reshape(src.shape).to(x.device)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The equal-split exchange of ``x``'s dim 0 over the ranks of one mesh
    axis (JAX's ``all_to_all(x, axis, 0, 0, tiled=True)``), differentiable:
    its backward sends each gradient block back to the rank it came from.
    The identity on an axis of one rank."""
    if mesh is None or mesh.axis_size(axis) <= 1:
        return x
    return _AllToAll.apply(x, mesh.group(axis))
