"""Streaming plane (counterpart of ``analytics_zoo_tpu/streaming``). Only
the record wire format is ported: :mod:`.records` encodes training
records and routes keyed records onto partitions, which the partitioned
serving broker (``serving/queue_api.PartitionedBroker``) uses. The
trainer, source, reloader, fleet and guardrail are not ported yet."""

from .records import (decode_record, decode_ref, encode_record,
                      partition_for, record_key, seq_id)

__all__ = ["encode_record", "decode_record", "decode_ref", "seq_id",
           "record_key", "partition_for"]
