from tpuimg_torch.parallel.sharding import (
    Mesh,
    Sharded,
    clahe_sharded,
    enhance_sharded,
    guided_filter_sharded,
    hist_equalize_sharded,
    integral_sharded,
    make_mesh,
    shard_batch,
    shard_rows,
    stencil_sharded,
)

__all__ = [
    "Mesh", "Sharded", "clahe_sharded", "enhance_sharded",
    "guided_filter_sharded", "hist_equalize_sharded", "integral_sharded",
    "make_mesh", "shard_batch", "shard_rows", "stencil_sharded",
]
