"""The fsdp layer stack: each layer's shards gathered just before it runs,
its gradients reduce-scattered in the backward, and, with
``system.overlap_gather``, the next layer's gather in flight while this one
computes (the JAX package's ``parallel/overlap.py``).

- **Bucketed gather, one a layer.** A layer's fsdp-sharded leaves are packed
  into size-bounded flat buckets (:func:`bucket_layout`), so un-sharding a
  layer is a few large all-gathers; rebuilding the leaves from a gathered
  ``[n, bucket]`` buffer is a view, a ``movedim`` and a reshape.
- **The gather is an autograd function** (:class:`_BucketGather`):
  all-gather in the forward, reduce-scatter of the bucket's gradient in the
  backward, so each layer's gradients leave as soon as the backward
  reaches it, and the model's kernels only ever see plain full tensors.
- **Prefetch.** With ``overlap_gather`` (and :func:`can_overlap`), layer
  i+1's gather is issued (``async_op=True``; on CUDA from a side stream)
  before layer i computes and waited on just before layer i+1 runs: the
  consuming stream waits on the side stream and the gathered buffer is
  ``record_stream``'d onto it. Without it each layer's gather runs when
  the layer starts. The numbers are the same either way.
- **Beside tp.** The gather covers the fsdp dim only: a leaf tp also
  splits comes back as this rank's tp block, full along fsdp.
- **Remat.** Layers under a remat policy gather inside their checkpoint,
  so the backward gathers their shards again rather than keeping full
  weights alive, as JAX's checkpoint encloses its gather; they take no
  prefetch.

The train step (``train/train_step.py``) builds an :class:`FsdpPlan` from
the full shapes and activates it around the loss; ``models/llama.py``'s
forward runs its layers through the active plan.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.tree import leaves_with_path
from .collectives import reduce_scatter_flat, spec_axes
from .sharding_rules import param_pspec

# One bucket ~ 4 MiB of shard bytes: large enough to amortize a launch,
# small enough that a layer drains as several transfers.
DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024


def _axis_dim(spec, axis: str) -> Optional[int]:
    """The dim a spec splits over ``axis`` (None if none)."""
    for d, a in spec_axes(spec):
        if a == axis:
            return d
    return None


def _leaves(tree: Any) -> List[Tuple[str, Any]]:
    return [(".".join(p), x) for p, x in leaves_with_path(tree)]


def layer_gather_dims(layer: Any, mesh, axis: str = "fsdp") -> List[Optional[int]]:
    """For each leaf of one layer (full shapes, the JAX pytree order), the
    dim the fsdp rules split, or None; matched with a ``layers.0.`` prefix,
    as the rules are suffix regexes."""
    return [_axis_dim(param_pspec("layers.0." + k, tuple(x.shape), mesh), axis)
            for k, x in _leaves(layer)]


def _gathered_like(path: str, x: Any, mesh, axis: str) -> torch.Tensor:
    """A ``meta`` stand-in of what the gather over ``axis`` yields for the
    leaf at ``path`` (full shape ``x``): the full leaf, but for the dims
    another axis (tp) splits, which stay this rank's blocks."""
    shape = list(x.shape)
    for d, a in spec_axes(param_pspec(path, tuple(x.shape), mesh)):
        if a != axis:
            shape[d] //= mesh.axis_size(a)
    return torch.empty(shape, dtype=x.dtype, device="meta")


def can_overlap(mesh, layers: Sequence[Any], batch: int, axis: str = "fsdp") -> bool:
    """JAX's gate for the prefetch schedule: an fsdp axis > 1, every
    model-parallel axis trivial, a global batch the data axes divide,
    layers of one structure with no int8 leaf, and every split dim
    divisible by the axis."""
    if mesh is None or mesh.axis_size(axis) <= 1:
        return False
    for other in ("tp", "sp", "ep", "pp"):
        if mesh.axis_size(other) > 1:
            return False
    if batch % (mesh.axis_size("dp") * mesh.axis_size(axis)) != 0:
        return False
    if not layers:
        return False
    if len({tuple(k for k, _ in _leaves(layer)) for layer in layers}) != 1:
        return False
    n = mesh.axis_size(axis)
    for (_, x), d in zip(_leaves(layers[0]), layer_gather_dims(layers[0], mesh, axis)):
        if x.dtype == torch.int8:
            return False
        if d is not None and x.shape[d] % n != 0:
            return False
    return True


class _Bucket:
    """Sharded leaves gathered as ONE collective: ``entries`` =
    ``[(leaf_index, full_shape, shard_dim)]``."""

    __slots__ = ("entries", "dtype", "shard_elems")

    def __init__(self, dtype):
        self.entries: List[Tuple[int, Tuple[int, ...], int]] = []
        self.dtype = dtype
        self.shard_elems = 0


def bucket_layout(leaves: Sequence[Any], dims: Sequence[Optional[int]], n: int,
                  bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> List[_Bucket]:
    """Greedy size-bounded bucketing of the split leaves (full shapes), by
    dtype."""
    buckets: List[_Bucket] = []
    open_by_dtype = {}
    for i, (leaf, d) in enumerate(zip(leaves, dims)):
        if d is None:
            continue
        shard_elems = leaf.numel() // n
        b = open_by_dtype.get(leaf.dtype)
        if (b is None or ((b.shard_elems + shard_elems) * leaf.element_size()
                          > bucket_bytes and b.entries)):
            b = _Bucket(leaf.dtype)
            buckets.append(b)
            open_by_dtype[leaf.dtype] = b
        b.entries.append((i, tuple(leaf.shape), d))
        b.shard_elems += shard_elems
    return buckets


class _Pending:
    """A bucket gather in flight: ``wait()`` returns the gathered buffer,
    ready for the current stream."""

    def __init__(self, out: torch.Tensor, work, stream, keep: torch.Tensor):
        self.out, self.work, self.stream, self.keep = out, work, stream, keep

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        if self.stream is not None:
            cur = torch.cuda.current_stream(self.out.device)
            cur.wait_stream(self.stream)
            self.out.record_stream(cur)
        self.keep = None
        return self.out


def _issue(shards: Sequence[torch.Tensor], group, n: int, async_op: bool,
           stream=None) -> _Pending:
    """Start the all-gather of the flat concatenation of ``shards``."""
    ctx = contextlib.nullcontext()
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        ctx = torch.cuda.stream(stream)
    with ctx, torch.no_grad():
        flat = torch.cat([s.detach().reshape(-1) for s in shards])
        out = flat.new_empty((n * flat.numel(),))
        work = dist.all_gather_into_tensor(out, flat, group=group, async_op=async_op)
    return _Pending(out, work if async_op else None, stream, flat)


class _BucketGather(torch.autograd.Function):
    """Shards -> the gathered flat bucket ``[n * shard_elems]`` (rank
    major); the backward reduce-scatters the bucket's gradient back into
    one gradient per shard."""

    @staticmethod
    def forward(ctx, group, n, pending, *shards):
        ctx.group, ctx.n = group, n
        ctx.shapes = [s.shape for s in shards]
        if pending is None:
            pending = _issue(shards, group, n, async_op=False)
        return pending.wait()

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        shard = grad.new_empty((grad.numel() // ctx.n,))
        reduce_scatter_flat(shard, grad, ctx.group)
        out, off = [], 0
        for shape in ctx.shapes:
            size = math.prod(shape)
            out.append(shard[off:off + size].view(shape))
            off += size
        return (None, None, None, *out)


def _gather_layer(shards: List[torch.Tensor], dims: Sequence[Optional[int]],
                  buckets: List[_Bucket], n: int, group,
                  pending: Optional[List[_Pending]] = None) -> List[torch.Tensor]:
    """Full leaves of one layer from its local leaves (unsplit leaves pass
    through): one :class:`_BucketGather` a bucket, then views."""
    out = list(shards)
    for bi, b in enumerate(buckets):
        gathered = _BucketGather.apply(group, n, None if pending is None else pending[bi],
                                       *[shards[i] for i, _, _ in b.entries])
        rows = gathered.view(n, -1)
        off = 0
        for i, full_shape, d in b.entries:
            shard_shape = list(full_shape)
            shard_shape[d] //= n
            size = math.prod(shard_shape)
            seg = rows[:, off:off + size].reshape(n, *shard_shape)
            out[i] = seg.movedim(0, d).reshape(full_shape)
            off += size
    return out


class FsdpPlan:
    """How the fsdp-split params of a model are gathered: for the layers
    (one bucket layout a layer, from the full shapes) and for the
    top-level leaves (embeddings, final norm, output)."""

    def __init__(self, params_like: Any, mesh, axis: str = "fsdp",
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES):
        self.mesh, self.axis = mesh, axis
        self.n = mesh.axis_size(axis)
        self.group = mesh.group(axis)
        self.layers_like = list(params_like.get("layers", []))
        self.layer_keys, self.layer_dims, self.layer_buckets = [], [], []
        for layer in self.layers_like:
            leaves = _leaves(layer)
            dims = layer_gather_dims(layer, mesh, axis)
            self.layer_keys.append([k for k, _ in leaves])
            self.layer_dims.append(dims)
            self.layer_buckets.append(bucket_layout(
                [_gathered_like("layers.0." + k, x, mesh, axis) for k, x in leaves], dims,
                self.n, bucket_bytes))
        top = {k: v for k, v in params_like.items() if k != "layers"}
        self.top_leaves = _leaves(top)
        self.top_dims = [_axis_dim(param_pspec(k, tuple(x.shape), mesh), axis)
                         for k, x in self.top_leaves]
        self.top_buckets = bucket_layout(
            [_gathered_like(k, x, mesh, axis) for k, x in self.top_leaves], self.top_dims,
            self.n, bucket_bytes)
        self._stream = None

    def can_overlap(self, local_batch: int) -> bool:
        data = self.mesh.axis_size("dp") * self.n
        return can_overlap(self.mesh, self.layers_like, local_batch * data, self.axis)

    def gather_top(self, params: Any) -> Any:
        """``params`` with its top-level leaves full (``layers`` untouched)."""
        top = {k: v for k, v in params.items() if k != "layers"}
        local = [x for _, x in _leaves(top)]
        full = _gather_layer(local, self.top_dims, self.top_buckets, self.n, self.group)
        out = dict(params)
        for (key, _), x in zip(self.top_leaves, full):
            node, parts = out, key.split(".")
            for p in parts[:-1]:
                node[p] = dict(node[p])
                node = node[p]
            node[parts[-1]] = x
        return out

    @staticmethod
    def _layer_tree(layer: Any, full: List[torch.Tensor]) -> Any:
        """``layer``'s structure with the leaves of ``full`` (sorted-key order)."""
        it = iter(full)

        def rebuild(node):
            if isinstance(node, dict):
                return {k: rebuild(node[k]) for k in sorted(node)}
            if isinstance(node, (list, tuple)):
                return [rebuild(v) for v in node]
            return next(it)

        return rebuild(layer)

    def _side_stream(self, device: torch.device):
        if device.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def run_layers(self, layers: Sequence[Any], x: torch.Tensor,
                   body: Callable[[Any, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
                   wrap: Optional[Callable] = None, n_wrapped: int = 0,
                   prefetch: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x`` through the layer stack: ``body(full_layer, x) -> (x,
        aux)`` computes one layer from full params. The first ``n_wrapped``
        layers run under ``wrap`` (a remat checkpoint) with their gather
        inside; the rest gather outside, with layer i+1's gather issued
        before layer i computes when ``prefetch``. Returns ``(x, aux_sum)``."""
        L = len(layers)
        aux_total = torch.zeros((), device=x.device)

        def locals_of(i):
            return [t for _, t in _leaves(layers[i])]

        def gathered_body(i, h, *shards):
            full = _gather_layer(list(shards), self.layer_dims[i], self.layer_buckets[i],
                                 self.n, self.group)
            return body(self._layer_tree(layers[i], full), h)

        def issue(i):
            stream = self._side_stream(x.device)
            shards = locals_of(i)
            return [_issue([shards[j] for j, _, _ in b.entries], self.group, self.n,
                           async_op=True, stream=stream)
                    for b in self.layer_buckets[i]]

        n_ck = n_wrapped if wrap is not None else 0
        for i in range(min(n_ck, L)):
            x, aux = wrap(gathered_body, i, x, *locals_of(i))
            aux_total = aux_total + aux
        pending = issue(n_ck) if (prefetch and n_ck < L) else None
        for i in range(n_ck, L):
            current = pending
            pending = issue(i + 1) if (prefetch and i + 1 < L) else None
            full = _gather_layer(locals_of(i), self.layer_dims[i], self.layer_buckets[i],
                                 self.n, self.group, pending=current)
            x, aux = body(self._layer_tree(layers[i], full), x)
            aux_total = aux_total + aux
        return x, aux_total


_ACTIVE: list = []


def active_plan() -> Optional[FsdpPlan]:
    """The plan of the train step running now (None outside one)."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def use_plan(plan: Optional[FsdpPlan]):
    _ACTIVE.append(plan)
    try:
        yield plan
    finally:
        _ACTIVE.pop()
