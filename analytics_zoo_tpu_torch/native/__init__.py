"""Native host runtime and host-to-device plane (counterpart of
``analytics_zoo_tpu/native``): the g++-built runtime's shuffle and gather,
the pinned staging ring and side-stream copies, and the infeed pump."""

from .infeed import InfeedPump, PipelineStats
from .runtime import available, gather_rows, load, shuffled_indices
from .transfer import (StagingPool, narrow_wire, narrows_to, put_tree,
                       wire_nbytes)

__all__ = ["InfeedPump", "PipelineStats", "StagingPool", "available",
           "gather_rows", "load", "narrow_wire", "narrows_to", "put_tree",
           "shuffled_indices", "wire_nbytes"]
