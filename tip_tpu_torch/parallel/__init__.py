"""Sharded training over ``torch.distributed`` (port of tip_tpu/parallel/:
mesh, sharded, ring, and ep, the relation-partitioned layout)."""

from tip_tpu_torch.parallel.mesh import (
    EDGE_AXIS,
    RING_AXIS,
    Mesh,
    make_mesh,
    make_mesh2,
    mesh_axes,
)
from tip_tpu_torch.parallel.ep import (
    RelationPartition,
    ep_param_specs,
    ep_params,
    ep_shard_graph,
    gather_params,
    partition_relations,
    shard_params,
    unep_params,
)
from tip_tpu_torch.parallel.ring import add_ring_pp, build_ring_pp
from tip_tpu_torch.parallel.sharded import (
    make_sharded_train_step,
    place_graph,
    shard_graph,
)

__all__ = [
    "EDGE_AXIS", "RING_AXIS", "Mesh", "make_mesh", "make_mesh2", "mesh_axes",
    "add_ring_pp", "build_ring_pp", "make_sharded_train_step", "place_graph",
    "shard_graph", "RelationPartition", "ep_param_specs", "ep_params",
    "ep_shard_graph", "gather_params", "partition_relations", "shard_params",
    "unep_params",
]
