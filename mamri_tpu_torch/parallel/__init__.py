from mamri_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    run_sharded_batched,
    sharded_batched_pipeline,
)
from mamri_tpu_torch.parallel.shard_seg import segment_volume_sharded

__all__ = [
    "make_mesh",
    "batch_sharding",
    "run_sharded_batched",
    "sharded_batched_pipeline",
    "segment_volume_sharded",
]
