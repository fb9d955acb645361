"""Parallelism over ``torch.distributed`` (``ampnet_tpu/parallel/`` in
torch): the rank mesh, data parallelism, the edge-partitioned graph with
halo exchange, tensor parallelism over heads. One process per rank; the
JAX package's exported names."""
from ampnet_tpu_torch.parallel.mesh import (
    make_mesh,
    auto_mesh_shape,
    initialize_distributed,
    replicated,
    data_sharded,
)
from ampnet_tpu_torch.parallel.data_parallel import (
    stack_graphs,
    shard_batch,
    make_dp_train_step,
)
from ampnet_tpu_torch.parallel.head_parallel import (
    shard_mha_params,
    head_sharded_amp_edge_attention,
    head_sharded_apply,
    tp_shard_params,
    tp_unshard_params,
    amp_gcn_forward_heads,
    make_tp_train_step,
    make_dp_tp_train_step,
)
from ampnet_tpu_torch.parallel.edge_partition import (
    PartitionedGraph,
    ShardLayout,
    HaloPlan,
    partition_graph,
    partition_layouts,
    build_halo_plan,
    common_halo_meta,
    halo_exchange,
    amp_gcn_forward_local,
    make_partitioned_train_step,
    make_dp_partitioned_train_step,
    stack_partitioned,
    stack_layouts,
    stack_halos,
)

__all__ = [
    "make_mesh",
    "auto_mesh_shape",
    "initialize_distributed",
    "replicated",
    "data_sharded",
    "stack_graphs",
    "shard_batch",
    "make_dp_train_step",
    "PartitionedGraph",
    "ShardLayout",
    "HaloPlan",
    "partition_layouts",
    "build_halo_plan",
    "common_halo_meta",
    "halo_exchange",
    "stack_layouts",
    "stack_halos",
    "make_dp_partitioned_train_step",
    "stack_partitioned",
    "partition_graph",
    "amp_gcn_forward_local",
    "make_partitioned_train_step",
    "shard_mha_params",
    "head_sharded_amp_edge_attention",
    "head_sharded_apply",
    "tp_shard_params",
    "tp_unshard_params",
    "amp_gcn_forward_heads",
    "make_tp_train_step",
    "make_dp_tp_train_step",
]
