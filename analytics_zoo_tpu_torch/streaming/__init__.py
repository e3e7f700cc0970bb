"""Streaming plane — online learning on the request stream, hot-reloaded
into serving (counterpart of ``analytics_zoo_tpu/streaming``).

The loop, end to end on one card:

    producer XADD -> StreamingXShards (windowed ChunkedArray
    micro-batches over the Redis/RESP2 transport) -> StreamingTrainer
    (incremental ``TPUEstimator.fit`` a window; with a pinned
    ``steps_per_dispatch`` one CUDA graph captured in window 1 and
    replayed after) -> CheckpointPlane commit (stream cursor + trace
    token in the manifest) -> StreamingReloader (CheckpointWatcher
    hot-swap into a live InferenceModel) -> fresher predictions, in
    seconds.

At fleet scale the single trainer becomes a
:class:`~analytics_zoo_tpu_torch.streaming.fleet.StreamingFleet`:
records carry a partition key (``encode_record(key=...)``), the stream
shards into keyed sub-streams (``?partitions=N``), N shared-nothing
trainer processes each run the loop above on their shard, and
:class:`~analytics_zoo_tpu_torch.streaming.fleet.FleetReloaders` adopts
each partition's freshest committed step — optionally through a
:class:`~analytics_zoo_tpu_torch.streaming.guardrail.GuardrailEvaluator`
that scores every commit on a holdout window and rejects regressions
before they reach traffic.

Records, windows, cursors and checkpoints are the JAX package's, byte
for byte: a streaming checkpoint either package committed resumes in the
other with its cursor (weights through ``interop``).
"""

from .fleet import FleetReloaders, StreamingFleet          # noqa: F401
from .guardrail import (GuardrailEvaluator,                # noqa: F401
                        GuardrailRejected, module_loss_scorer)
from .records import (decode_record, decode_ref,           # noqa: F401
                      encode_record, partition_for, record_key, seq_id)
from .serve import StreamingReloader                       # noqa: F401
from .source import (StreamCursor, StreamingXShards,       # noqa: F401
                     Window)
from .stats import StreamingStats                          # noqa: F401
from .trainer import StreamingTrainer                      # noqa: F401

__all__ = ["encode_record", "decode_record", "decode_ref", "seq_id",
           "record_key", "partition_for", "StreamCursor", "Window",
           "StreamingXShards", "StreamingTrainer", "StreamingReloader",
           "StreamingStats", "StreamingFleet", "FleetReloaders",
           "GuardrailEvaluator", "GuardrailRejected", "module_loss_scorer"]
