from frn_tpu_torch.parallel.mesh import (
    Mesh,
    World,
    all_reduce_mean_,
    broadcast_value,
    init_distributed,
    is_main,
    launched,
    make_mesh,
    replicate,
    row_blocks,
    shard_batch,
    world,
)

__all__ = [
    "Mesh",
    "World",
    "all_reduce_mean_",
    "broadcast_value",
    "init_distributed",
    "is_main",
    "launched",
    "make_mesh",
    "replicate",
    "row_blocks",
    "shard_batch",
    "world",
]
