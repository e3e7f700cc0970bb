"""Zero-copy shared-memory object plane.

``BlobArena`` + ``ObjectRef`` descriptors let the serving, streaming and
checkpoint fleets move tensors between host processes by reference
instead of by copy (``docs/performance_notes.md``). Gated by
``ZOO_SHM``; off, every wire stays byte-identical to the inline formats.
"""

from .arena import (ArenaFull, BlobArena, ObjectRef, StaleObjectRef,
                    arena_for, arena_root_for, default_control_root,
                    shm_available)
from .wire import (arena_for_spec, envelope_key, is_envelope, min_shm_bytes,
                   peek_refs, publish_blob, resolve_blob,
                   shm_enabled_for_spec, sweep_spec, unwrap, wrap_inline,
                   wrap_ref)

__all__ = [
    "ArenaFull", "BlobArena", "ObjectRef", "StaleObjectRef",
    "arena_for", "arena_root_for", "default_control_root", "shm_available",
    "arena_for_spec", "envelope_key", "is_envelope", "min_shm_bytes",
    "peek_refs",
    "publish_blob", "resolve_blob", "shm_enabled_for_spec", "sweep_spec",
    "unwrap", "wrap_inline", "wrap_ref",
]
