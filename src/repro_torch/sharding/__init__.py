"""Distribution: the logical-axis partitioner (rule tables, parameter,
optimizer, batch, cache and logits shardings, the row-sharded SpMV route)
and the DTensor layouts and collectives of sharded training."""
from repro_torch.sharding import layout  # noqa: F401
from repro_torch.sharding.partitioner import (  # noqa: F401
    NamedSharding,
    Partitioner,
    ShardingRules,
    SERVE_RULES,
    TRAIN_RULES,
    mesh_signature,
    resolve_spmv_shard_axis,
)
