"""The rank mesh: the JAX package's ``parallel/mesh.py`` over
``torch.distributed``.

One process drives one device (a rank); the ranks of a run are laid out
row-major over named axes in :data:`AXIS_ORDER`, as ``jax.sharding.Mesh``
lays out devices, and each axis gets its process groups from a
``DeviceMesh``:

- ``pp``   pipeline parallel (ROADMAP queue 1 item 10d);
- ``dp``   data parallel: the batch is split, gradients are all-reduced;
- ``fsdp`` fully-sharded data parallel: params and optimizer state are
           sharded, the batch is split along it too;
- ``ep``   expert parallel (item 10b);
- ``sp``   sequence parallel, ring attention (item 10c);
- ``tp``   tensor parallel (item 10a).

``-1`` on one axis means "all remaining ranks". The trainer acts on dp,
fsdp and tp; the other axes are resolved here as JAX resolves them, so a
config's mesh reads the same in both packages, and the trainer refuses
them. tp is the innermost axis, so the ranks of one tp group are adjacent,
as JAX's device order puts them.
"""

from __future__ import annotations

import math
import warnings
from types import SimpleNamespace
from typing import Any, Dict, Optional, Sequence, Tuple, Union

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# Axes the serving mesh may use (the JAX package's); the port serves over tp
# (its dp axis is ROADMAP queue 1 item 10a-dp).
SERVE_AXES = ("dp", "tp")


def mesh_axis_sizes(system_cfg: Any, n_devices: Optional[int] = None) -> Dict[str, int]:
    """``system.mesh`` (or the legacy ``model_parallel`` flags) resolved
    on ``n_devices`` ranks (the world size when None): the JAX package's
    rules, errors and "STRANDED" warning included."""
    n = n_devices if n_devices is not None else world_size()
    sizes = {k: int(v) for k, v in (getattr(system_cfg, "mesh", None) or {}).items()}
    if not sizes:
        # legacy flags: model_parallel -> a tp axis
        if getattr(system_cfg, "model_parallel", False):
            tp = max(1, int(getattr(system_cfg, "model_parallel_size", 1)))
            sizes = {"dp": -1, "tp": tp}
        else:
            sizes = {"dp": -1}
    unknown = set(sizes) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; valid: {AXIS_ORDER}")
    fixed = math.prod(v for v in sizes.values() if v > 0) if sizes else 1
    for k, v in sizes.items():
        if v == -1:
            if n % fixed != 0:
                raise ValueError(f"device count {n} not divisible by fixed axes {fixed}")
            sizes[k] = n // fixed
    total = math.prod(sizes.values())
    if total > n:
        raise ValueError(f"mesh {sizes} needs {total} devices, have {n}")
    if total < n:
        warnings.warn(
            f"mesh {sizes} covers {total} of {n} devices — "
            f"{n - total} device(s) STRANDED (idle). Use -1 on one axis to "
            f"absorb the remainder, or shrink the visible device set.",
            RuntimeWarning,
            stacklevel=2,
        )
    return {a: sizes.get(a, 1) for a in AXIS_ORDER if sizes.get(a, 1) > 1 or a in sizes}


def mesh_device_count(sizes: Dict[str, int]) -> int:
    return math.prod(sizes.values()) if sizes else 1


def world_size() -> int:
    """Ranks of the default process group (1 when none is initialized)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def world_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """Named axes over the ranks of a run, row-major in :data:`AXIS_ORDER`.

    ``shape`` maps each axis to its size (the axes of the resolved sizes,
    in order), ``axis_names`` lists them, ``rank`` is this process's rank.
    ``coord(axis)`` is this rank's index along an axis and ``group(axis)``
    its process group there (None for an axis of size 1, where nothing is
    communicated). ``device_mesh`` is the ``torch.distributed`` DeviceMesh
    the groups come from (None when the mesh covers one rank, or for an
    abstract mesh built for the sharding rules alone)."""

    def __init__(self, sizes: Dict[str, int], rank: int = 0, device_mesh: Any = None):
        self.shape: Dict[str, int] = {a: int(sizes[a]) for a in sizes}
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.rank = int(rank)
        self.size = mesh_device_count(self.shape)
        self.device_mesh = device_mesh
        strides, s = {}, 1
        for a in reversed(self.axis_names):
            strides[a] = s
            s *= self.shape[a]
        self._strides = strides

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        if axis not in self.shape:
            return 0
        return (self.rank // self._strides[axis]) % self.shape[axis]

    def group(self, axis: str):
        if self.axis_size(axis) <= 1:
            return None
        if self.device_mesh is None:
            raise RuntimeError(f"mesh axis {axis!r} has {self.axis_size(axis)} ranks "
                               "but no process group: build the mesh with build_mesh "
                               "inside an initialized torch.distributed world")
        return self.device_mesh.get_group(axis)

    def active_axes(self) -> Tuple[str, ...]:
        """The axes with more than one rank."""
        return tuple(a for a in self.axis_names if self.shape[a] > 1)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def data_coords(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """``(index, count)`` of this rank's rows among the data axes (dp,
    fsdp, ep; major first, as ``batch_pspec`` splits the batch): the ranks
    of one tp group share an index. A rank and the world without a mesh."""
    if mesh is None:
        return world_rank(), world_size()
    index, count = 0, 1
    for a in ("dp", "fsdp", "ep"):
        index = index * mesh.axis_size(a) + mesh.coord(a)
        count *= mesh.axis_size(a)
    return index, count


def abstract_mesh(sizes: Dict[str, int], rank: int = 0) -> Mesh:
    """A mesh of the given axis sizes with no process groups: what the
    sharding rules and the shard arithmetic read (tests, planning)."""
    return Mesh(sizes, rank=rank)


def build_mesh(system_cfg: Any, devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of ``system.mesh`` over the ranks of the initialized world
    (one device a rank; one rank when no process group is up). Unlike a
    JAX device list, a rank outside the mesh would be a whole process with
    nothing to do, so a mesh must cover every rank. ``devices`` is
    accepted for the JAX signature and must be None."""
    import torch.distributed as dist

    if devices is not None:
        raise ValueError("the port's mesh spans the ranks of the process group; "
                         "pass no device list")
    n = world_size()
    sizes = mesh_axis_sizes(system_cfg, n)
    if mesh_device_count(sizes) != n:
        raise ValueError(f"mesh {sizes} covers {mesh_device_count(sizes)} of {n} "
                         "ranks; every rank must be on the mesh (use -1 on one axis)")
    if n == 1:
        return Mesh(sizes, rank=0)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, tuple(sizes.values()),
                          mesh_dim_names=tuple(sizes.keys()))
    return Mesh(sizes, rank=dist.get_rank(), device_mesh=dm)


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """Parse a CLI mesh spec like ``"tp=2"`` or ``"tp=2,dp=2"`` into axis sizes."""
    sizes: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad mesh spec segment {part!r}; expected axis=N")
        axis, _, val = part.partition("=")
        try:
            sizes[axis.strip()] = int(val)
        except ValueError:
            raise ValueError(f"bad mesh axis size {val!r} in {spec!r}") from None
    return sizes


def build_serve_mesh(mesh_sizes: Union[None, str, Dict[str, int]],
                     devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """The serving mesh over ``tp`` x ``dp``: None for an empty or all-ones
    spec (the one-device engine). A ``{tp: N}`` mesh spans the N ranks of a
    launched world (``parallel.launch --nproc-per-node N``, one device a
    rank); outside one it raises, naming the launcher, as JAX raises when it
    lacks the devices. A ``dp`` axis above 1 is ROADMAP queue 1 item
    10a-dp. ``devices`` is accepted for the JAX signature and must be
    None."""
    sizes = serve_mesh_sizes(mesh_sizes)
    return None if sizes is None else build_mesh(SimpleNamespace(mesh=sizes), devices)


def serve_mesh_sizes(mesh_sizes: Union[None, str, Dict[str, int]]
                     ) -> Optional[Dict[str, int]]:
    """:func:`build_serve_mesh`'s checks and resolved axis sizes, without
    building process groups (None for the one-device engine)."""
    if isinstance(mesh_sizes, str):
        mesh_sizes = parse_mesh_spec(mesh_sizes)
    sizes = {k: int(v) for k, v in (mesh_sizes or {}).items()}
    bad = set(sizes) - set(SERVE_AXES)
    if bad:
        raise ValueError(
            f"serving mesh supports axes {SERVE_AXES}, got {sorted(bad)}; "
            f"pp/fsdp/ep/sp are trainer-only"
        )
    if not sizes or all(v == 1 for v in sizes.values()):
        return None
    if sizes.get("dp", 1) > 1:
        refuse_serve_dp(sizes)
    n = world_size()
    fixed = math.prod(v for v in sizes.values() if v > 0)
    if fixed > n:
        raise ValueError(
            f"serving mesh {sizes} needs {fixed} ranks and this process is a world "
            f"of {n}: start one rank a device with parallel.launch --nproc-per-node "
            f"{fixed} (python -m mlx_cuda_distributed_pretraining_tpu_torch.parallel."
            "launch --module ...infer.server -- --mesh ...)")
    sizes = mesh_axis_sizes(SimpleNamespace(mesh=sizes), n)
    if sizes.get("dp", 1) > 1:
        refuse_serve_dp(sizes)
    return sizes


def refuse_serve_dp(sizes) -> None:
    """A serving mesh's dp axis above 1: ROADMAP queue 1 item 10a-dp."""
    raise NotImplementedError(
        f"serving mesh {sizes}: the dp axis is not ported (ROADMAP queue 1 item "
        "10a-dp: data-parallel serving replicas in one mesh); tp serves")


def refuse_unported_axes(sizes: Dict[str, int]) -> None:
    """Raise for an axis the trainer does not act on yet (size > 1),
    naming its ROADMAP item."""
    items = {"ep": "10b: expert parallelism",
             "sp": "10c: sequence parallelism and ring attention",
             "pp": "10d: pipeline parallelism"}
    for axis, item in items.items():
        if sizes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"mesh {sizes}: the {axis!r} axis is not ported "
                f"(ROADMAP queue 1 item {item}); dp, fsdp and tp train")
