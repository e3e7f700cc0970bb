"""Checkpoint plane (counterpart of ``analytics_zoo_tpu/ckpt``): async,
atomic, content-addressed checkpointing in the on-disk format
``zoo-ckpt-v1`` that the JAX package writes and reads.

* **Format** (:mod:`.format`): per-leaf blobs addressed by the sha256 of
  their bytes, plus a JSON manifest; the same numpy leaves give the same
  blobs in both packages. The reader maps the JAX package's pickled names
  (its ``_LeafRef``, optax's state namedtuples) to plain stand-ins without
  importing them.
* **Atomicity**: tmp dir -> fsync -> rename -> ``COMMIT``; the loader
  skips uncommitted dirs and falls back past checksum mismatches.
* **Async saves** (:class:`.plane.CheckpointPlane`): the loop pays the
  device-to-host snapshot; a writer thread hashes and writes behind it.
* **Retention and encryption at rest** as in the JAX package.
* **Serving hot-reload** (:class:`.watch.CheckpointWatcher`): watch a
  checkpoint root and hand each newly committed step to a live
  ``InferenceModel``.
"""

from .format import (is_committed, is_plane_dir, load_checkpoint_dir,
                     read_manifest)
from .plane import CheckpointPlane, parse_step
from .stats import CkptStats
from .watch import CheckpointWatcher

__all__ = ["CheckpointPlane", "CheckpointWatcher", "CkptStats",
           "is_committed", "is_plane_dir", "load_checkpoint_dir",
           "parse_step", "read_manifest"]
