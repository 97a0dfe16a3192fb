"""Distribution: the logical-axis partitioner's rule tables and the routing
of row-sharded SpMV onto a ``DeviceMesh`` axis."""
from repro_torch.sharding.partitioner import (  # noqa: F401
    Partitioner,
    ShardingRules,
    SERVE_RULES,
    TRAIN_RULES,
    mesh_signature,
    resolve_spmv_shard_axis,
)
