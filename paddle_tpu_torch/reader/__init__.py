"""The data pipeline's device side (counterpart: `paddle_tpu/reader/`):
the device prefetcher (`prefetcher`) and the elastic per-rank sample
assignment (`resharding`). The reference's classic reader decorators
(`cache`, `shuffle`, `buffered`, `xmap_readers`, ...) come with ROADMAP
Queue 1 #8."""
from .prefetcher import (  # noqa: F401
    DevicePrefetcher, RowShard, device_put_batch, is_donatable,
    is_on_device, mark_donatable, prefetch_to_device, rows_of,
)
from .resharding import (  # noqa: F401
    rank_slice, resume_sample_offset, shard_batch, shard_batches,
    skip_steps, survivor_rank,
)

__all__ = [
    "prefetch_to_device", "DevicePrefetcher", "RowShard",
    "device_put_batch", "is_on_device", "mark_donatable", "is_donatable",
    "rows_of", "rank_slice", "shard_batch", "shard_batches",
    "resume_sample_offset", "skip_steps", "survivor_rank",
]
