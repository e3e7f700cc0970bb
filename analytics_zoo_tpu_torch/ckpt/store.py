"""Content-addressed blob store with mark-and-sweep GC (a copy of
``analytics_zoo_tpu/ckpt/store.py``).

``<root>/blobs/<sha256-of-plaintext>`` (``.enc`` suffix for sealed blobs).
The digest addresses the *content*, so:

* a leaf unchanged between step N and N+1 is written once — the second
  save's ``put`` sees the file and counts a dedup hit;
* an ASHA rung of trials sharing frozen embeddings shares those blobs
  across every trial's manifests;
* GC is reference counting by construction — :meth:`gc` marks every
  digest reachable from any manifest under the root (committed, legacy,
  even mid-write tmp dirs) and sweeps the rest, so retention deleting a
  checkpoint never takes a still-referenced blob with it.

Writes are atomic (tmp + fsync + ``os.replace``) and idempotent: a crash
mid-``put`` leaves only a ``.tmp-*`` file the next GC removes.
"""

from __future__ import annotations

import json
import logging
import os
import time
import uuid
from typing import Optional, Set, Tuple

from ..resilience import faults as _faults
from .format import MANIFEST_NAME

logger = logging.getLogger("analytics_zoo_tpu_torch")


class BlobStore:
    def __init__(self, blob_dir: str):
        self.dir = blob_dir

    def _name(self, digest: str, encrypted: bool) -> str:
        return digest + (".enc" if encrypted else "")

    def path(self, digest: str, encrypted: bool = False) -> str:
        return os.path.join(self.dir, self._name(digest, encrypted))

    def has(self, digest: str, encrypted: bool = False) -> bool:
        return os.path.exists(self.path(digest, encrypted))

    def put(self, digest: str, data: bytes, encrypted: bool = False,
            passphrase: Optional[str] = None, fsync: bool = True) -> bool:
        """Store ``data`` (plaintext) under its plaintext digest. Returns
        True when bytes were actually written, False on a dedup hit."""
        _faults.fire("ckpt.blob_io")     # chaos hook: model a failing disk
        final = self.path(digest, encrypted)
        if os.path.exists(final):
            # bump mtime: the blob is "in use" again, which keeps another
            # instance's GC grace window (see :meth:`gc`) from sweeping it
            # before this writer's manifest lands on disk
            try:
                os.utime(final, None)
            except OSError:         # pragma: no cover — raced delete
                pass
            return False
        os.makedirs(self.dir, exist_ok=True)
        if encrypted:
            from ..utils.crypto import encrypt_bytes
            data = encrypt_bytes(data, passphrase)
        tmp = os.path.join(self.dir, f".tmp-{digest[:16]}-{uuid.uuid4().hex}")
        with open(tmp, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, final)
        return True

    def get(self, digest: str, encrypted: bool = False,
            passphrase: Optional[str] = None) -> bytes:
        with open(self.path(digest, encrypted), "rb") as f:
            raw = f.read()
        if encrypted:
            from ..utils.crypto import decrypt_bytes
            raw = decrypt_bytes(raw, passphrase)
        return raw

    def map(self, digest: str):
        """Map an UNENCRYPTED blob read-only (mmap) instead of reading it
        into a heap copy — the hot-reload path decodes leaves straight
        over the page cache, so N serving processes adopting the same
        checkpoint share one physical copy. The mapping stays valid while
        any view holds it (numpy keeps the mmap object referenced);
        content-addressed blobs are never rewritten in place, so a mapped
        view cannot change under the reader."""
        import mmap
        with open(self.path(digest, False), "rb") as f:
            return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)

    # --- GC -----------------------------------------------------------------
    def _live_names(self, root: str) -> Set[str]:
        """Every blob filename referenced by any manifest under ``root``
        (tmp dirs included: a manifest mid-write by another plane instance
        must keep its blobs alive)."""
        live: Set[str] = set()
        for dirpath, _dirnames, filenames in os.walk(root):
            if os.path.abspath(dirpath) == os.path.abspath(self.dir):
                continue
            if MANIFEST_NAME not in filenames:
                continue
            try:
                with open(os.path.join(dirpath, MANIFEST_NAME),
                          encoding="utf-8") as f:
                    doc = json.load(f)
            except Exception:       # noqa: BLE001 — torn manifest: no refs
                continue
            enc = bool(doc.get("encrypted"))
            recs = [doc.get("skeleton") or {}] + list(doc.get("leaves") or [])
            for rec in recs:
                d = rec.get("digest")
                if d:
                    live.add(self._name(d, enc))
        return live

    def gc(self, root: str, grace_s: float = 120.0) -> Tuple[int, int]:
        """Mark-and-sweep: remove blobs (and stale tmp files) no manifest
        under ``root`` references. Returns (files_removed, bytes_removed).

        ``grace_s`` protects recently written/touched blobs: a concurrent
        plane instance writes all its blobs BEFORE its manifest exists, so
        an unreferenced-right-now blob younger than the grace window may
        be a checkpoint mid-commit (``put`` bumps mtime on dedup hits for
        the same reason). Only blobs both unreferenced and idle are swept.
        """
        if not os.path.isdir(self.dir):
            return 0, 0
        live = self._live_names(root)
        removed, freed = 0, 0
        cutoff = time.time() - max(grace_s, 0.0)
        for name in os.listdir(self.dir):
            if name in live:
                continue
            path = os.path.join(self.dir, name)
            try:
                if os.path.getmtime(path) > cutoff:
                    continue        # inside the grace window: maybe
                    # referenced by a manifest still being committed
                freed += os.path.getsize(path)
                os.remove(path)
                removed += 1
            except OSError:         # pragma: no cover — raced/locked file
                pass
        return removed, freed
