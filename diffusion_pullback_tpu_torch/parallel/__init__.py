"""The device mesh over torch.distributed: the probe-sharded pullback and
the dp sweep, Megatron tensor parallelism, ring attention and the
differentiable collectives they run on."""

from .collectives import all_reduce, copy_to_region, gather, ring_shift, shard
from .mesh import axis_size, make_mesh, mesh_shape_for
from .ring_attention import get_ring_mesh, ring_attention, set_ring_mesh
from .sharded_pullback import dp_vmap, make_sharded_pullback, sharded_local_pullback
from .tp import tp_param_specs, tp_shard_params, tp_sharded_leaf_count

__all__ = [
    "all_reduce",
    "axis_size",
    "copy_to_region",
    "dp_vmap",
    "gather",
    "get_ring_mesh",
    "make_mesh",
    "make_sharded_pullback",
    "mesh_shape_for",
    "ring_attention",
    "ring_shift",
    "set_ring_mesh",
    "shard",
    "sharded_local_pullback",
    "tp_param_specs",
    "tp_shard_params",
    "tp_sharded_leaf_count",
]
