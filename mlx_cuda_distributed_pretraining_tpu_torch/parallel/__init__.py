"""Data and fully-sharded parallelism over ``torch.distributed``: the
rank mesh, the partition rules, the rendezvous and launcher, and the fsdp
layer gather (the JAX package's ``parallel/``, for the parts ported)."""

from .elastic import BarrierTimeoutError, RendezvousError, process_barrier, rendezvous
from .mesh import build_mesh, build_serve_mesh, mesh_axis_sizes, parse_mesh_spec
from .sharding_rules import batch_pspec, param_pspec, state_sharding, tree_pspecs

__all__ = [
    "build_mesh", "build_serve_mesh", "mesh_axis_sizes", "parse_mesh_spec",
    "batch_pspec", "param_pspec", "state_sharding", "tree_pspecs",
    "BarrierTimeoutError", "RendezvousError", "process_barrier", "rendezvous",
]
