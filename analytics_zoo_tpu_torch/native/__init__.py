"""Native host runtime and host-to-device plane (counterpart of
``analytics_zoo_tpu/native``): the g++-built runtime (allocator, token
queue, shuffle, gather, padding, bf16 rounding), the pinned staging ring
and side-stream copies, and the infeed pump. ``sharded_put`` waits for
data parallelism across processes (ROADMAP A10)."""

from .infeed import InfeedPump, PipelineStats
from .runtime import (Arena, NativeQueue, available, f32_to_bf16_bits,
                      gather_rows, load, pad_sequences, shuffled_indices,
                      version)
from .transfer import (StagingPool, narrow_wire, narrows_to, put_tree,
                       staging_enabled, wire_nbytes)

__all__ = ["Arena", "InfeedPump", "NativeQueue", "PipelineStats",
           "StagingPool", "available", "f32_to_bf16_bits", "gather_rows",
           "load", "narrow_wire", "narrows_to", "pad_sequences", "put_tree",
           "shuffled_indices", "staging_enabled", "version", "wire_nbytes"]
