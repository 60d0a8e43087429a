from multimodal_flows.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicated_sharding,
    shard_coupling,
)

__all__ = ["make_mesh", "batch_sharding", "replicated_sharding", "shard_coupling"]
