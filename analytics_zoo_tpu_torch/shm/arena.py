"""Ref-counted shared-memory object plane (the host-side zero-copy tier).

The reference stack rides Ray's object store so tensors move between
processes by reference; our fleet hops (frontend -> broker -> worker,
producer -> trainer, checkpoint -> reloader) still ship payload *bytes*
through the broker, copying each request several times on the host before
it reaches HBM. This module is the missing plane: a :class:`BlobArena`
carves named ``multiprocessing.shared_memory`` segments into aligned
slabs, producers ``put`` payload bytes once, and everything after that
moves an :class:`ObjectRef` descriptor (segment/offset/length/dtype/
shape/generation) — consumers map the slab read-only and feed the view
straight to batch assembly / ``sharded_put``.

Crash-safe ref-counting, no daemon:

* every pin lives in the pinning process's **lease file**
  (``leases/<pid>-<uuid>.json``). A SIGKILL cannot unwind Python, but it
  also cannot keep a lease file relevant: :meth:`BlobArena.sweep` drops
  leases whose pid is gone, so the fleet supervisors reclaim a dead
  worker's pins on reap and a killed consumer leaks zero segments;
* an allocation is freed when it has been **consumed** (a consumer
  called :meth:`BlobArena.done` after acking it) and no lease pins it.
  A producer that releases right after enqueue therefore keeps the blob
  alive until a consumer really finished with it — and a *reclaimed*
  broker delivery (PEL replay) re-resolves the same generation-checked
  slab bytes;
* every allocation carries a **generation** from a monotonic arena
  counter. Mapping a freed (or reused) slab raises a typed
  :class:`StaleObjectRef`, never returns garbage.

All metadata mutations serialize through one ``flock`` per arena; the
index is a small JSON document rewritten atomically, so any process (or
the ``zoo-shm`` CLI) can inspect and repair an arena after a crash.
"""

from __future__ import annotations

import contextlib
import errno
import hashlib
import json
import logging
import os
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["ObjectRef", "StaleObjectRef", "ArenaFull", "BlobArena",
           "arena_root_for", "arena_for", "shm_available",
           "default_control_root"]

_MAX_SEGMENTS = 8


class StaleObjectRef(Exception):
    """The descriptor's generation no longer matches the slab: the blob
    was freed (and possibly reused) after the descriptor was minted."""


class ArenaFull(Exception):
    """No contiguous slab run satisfies the allocation and the arena is
    at its segment cap — callers fall back to the inline wire."""


@dataclass(frozen=True)
class ObjectRef:
    """Descriptor of one blob in a :class:`BlobArena`: everything a
    consumer needs to map it, nothing that requires the producer to stay
    alive. ``dtype``/``shape`` are optional tensor semantics — set, the
    checkout returns a shaped ndarray view; unset, a flat byte view."""
    segment: str
    offset: int
    length: int
    generation: int
    dtype: Optional[str] = None
    shape: Optional[Tuple[int, ...]] = None

    @property
    def key(self) -> str:
        return f"{self.segment}:{self.offset}"

    def to_dict(self) -> Dict:
        d = {"seg": self.segment, "off": self.offset, "len": self.length,
             "gen": self.generation}
        if self.dtype is not None:
            d["dtype"] = self.dtype
        if self.shape is not None:
            d["shape"] = list(self.shape)
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "ObjectRef":
        return cls(segment=str(d["seg"]), offset=int(d["off"]),
                   length=int(d["len"]), generation=int(d["gen"]),
                   dtype=d.get("dtype"),
                   shape=(tuple(int(s) for s in d["shape"])
                          if d.get("shape") is not None else None))


def shm_available() -> bool:
    """POSIX shared memory usable on this host?"""
    if os.name != "posix":
        return False
    try:
        from multiprocessing import shared_memory  # noqa: F401
    except ImportError:         # pragma: no cover — stdlib since 3.8
        return False
    return True


def default_control_root() -> str:
    """Directory arenas keep their control plane (index/lock/leases)
    under. ``/dev/shm`` when writable — metadata updates are on the
    message hot path and tmpfs keeps them off the disk — else tmpdir."""
    if os.path.isdir("/dev/shm") and os.access("/dev/shm", os.W_OK):
        return "/dev/shm/zoo_shm"
    return os.path.join(tempfile.gettempdir(), "zoo_shm")


def arena_root_for(key: str) -> str:
    """Deterministic control-dir path for a logical arena key (e.g. a
    broker spec's base) — every process that shares the key shares the
    arena without any rendezvous beyond the string itself."""
    digest = hashlib.sha1(key.encode("utf-8")).hexdigest()[:12]
    return os.path.join(default_control_root(), digest)


def _untrack(seg) -> None:
    # resource_tracker would unlink every attached segment when the FIRST
    # attaching process exits, yanking live slabs out from under the rest
    # of the fleet (and spamming "leaked shared_memory" warnings for
    # segments the arena owns deliberately). Lifetime is the arena
    # index's job; 3.13's track=False is not available on 3.10.
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(seg._name, "shared_memory")
    except Exception as e:  # noqa: BLE001 — tracker internals shifted; the
        # worst case is a spurious "leaked shared_memory" warning at exit
        logger.debug("shm: resource_tracker unregister failed: %s", e)


def _counters():
    """Lazy obs handles (import cycles: obs.registry is leaf-safe but
    keep the arena importable before the registry configures)."""
    global _C
    if _C is None:
        from ..obs.registry import REGISTRY
        _C = {
            "put": REGISTRY.counter(
                "zoo_shm_bytes_put_total",
                "payload bytes copied INTO arena slabs by producers "
                "(the one copy the descriptor wire pays)"),
            "mapped": REGISTRY.counter(
                "zoo_shm_bytes_mapped_total",
                "payload bytes resolved as zero-copy slab mappings by "
                "consumers (bytes the inline wire would have copied)"),
            "inline": REGISTRY.counter(
                "zoo_shm_bytes_inline_total",
                "payload bytes that fell back to the inline wire "
                "(arena full / oversized / shm unavailable)"),
            "allocs": REGISTRY.counter(
                "zoo_shm_allocs_total", "arena slab allocations"),
            "stale": REGISTRY.counter(
                "zoo_shm_stale_total",
                "descriptor checkouts rejected by the generation check "
                "(StaleObjectRef raised instead of returning garbage)"),
            "swept": REGISTRY.counter(
                "zoo_shm_leases_swept_total",
                "dead-process lease files swept by supervisors/gc"),
            "live": REGISTRY.gauge(
                "zoo_shm_slabs_live", "slabs currently allocated",
                labelnames=("arena",)),
        }
    return _C


_C = None


class BlobArena:
    """One shared-memory arena: N named segments, each carved into
    ``slab_bytes`` slabs; allocation = a contiguous slab run.

    Thread-safe within a process and crash-safe across processes: all
    index/lease mutations run under the arena's ``flock``.
    """

    def __init__(self, root: str, *, slab_bytes: int = 1 << 20,
                 segment_bytes: int = 64 << 20, create: bool = True):
        if slab_bytes <= 0 or segment_bytes < slab_bytes:
            raise ValueError(
                f"need segment_bytes >= slab_bytes > 0, got "
                f"{segment_bytes}/{slab_bytes}")
        self.root = root
        self.slab_bytes = int(slab_bytes)
        self.segment_bytes = (int(segment_bytes) // self.slab_bytes
                              * self.slab_bytes)
        self._seg_name_base = "zooshm_" + hashlib.sha1(
            os.path.abspath(root).encode()).hexdigest()[:10]
        self._segs: Dict[str, object] = {}     # name -> SharedMemory
        self._pins: Dict[str, int] = {}        # "seg:off:gen" -> count
        self._lock = threading.Lock()
        self._lease_path = None
        self._closed = False
        if create:
            os.makedirs(os.path.join(root, "leases"), exist_ok=True)

    # --- index / lock plumbing ---------------------------------------------
    @property
    def _index_path(self) -> str:
        return os.path.join(self.root, "index.json")

    @contextlib.contextmanager
    def _flock(self):
        import fcntl
        os.makedirs(self.root, exist_ok=True)
        fd = os.open(os.path.join(self.root, "lock"),
                     os.O_CREAT | os.O_RDWR, 0o666)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)    # releases the flock

    def _load_index(self) -> Dict:
        try:
            with open(self._index_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {"gen": 0, "segments": [], "allocs": {}}

    def _save_index(self, idx: Dict) -> None:
        tmp = self._index_path + f".tmp-{uuid.uuid4().hex[:8]}"
        with open(tmp, "w") as f:
            json.dump(idx, f)
        os.replace(tmp, self._index_path)

    # --- lease (per-process pin) file --------------------------------------
    def _write_lease(self) -> None:
        lease_dir = os.path.join(self.root, "leases")
        if self._lease_path is None:
            os.makedirs(lease_dir, exist_ok=True)
            self._lease_path = os.path.join(
                lease_dir, f"{os.getpid()}-{uuid.uuid4().hex[:8]}.json")
        tmp = self._lease_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"pid": os.getpid(), "pins": self._pins}, f)
        os.replace(tmp, self._lease_path)
        if not self._pins:
            with contextlib.suppress(OSError):
                os.unlink(self._lease_path)
            self._lease_path = None

    def _pin(self, tag: str) -> None:
        self._pins[tag] = self._pins.get(tag, 0) + 1
        self._write_lease()

    def _unpin(self, tag: str) -> bool:
        n = self._pins.get(tag, 0)
        if n <= 1:
            self._pins.pop(tag, None)
        else:
            self._pins[tag] = n - 1
        self._write_lease()
        return tag not in self._pins

    def _pinned_anywhere(self, tag: str) -> bool:
        lease_dir = os.path.join(self.root, "leases")
        try:
            names = os.listdir(lease_dir)
        except OSError:
            return False
        for n in names:
            if n.endswith(".tmp"):
                continue
            try:
                with open(os.path.join(lease_dir, n)) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            if int(doc.get("pins", {}).get(tag, 0)) > 0:
                return True
        return False

    # --- segments -----------------------------------------------------------
    def _attach(self, name: str, create: bool = False):
        from multiprocessing import shared_memory
        seg = self._segs.get(name)
        if seg is None:
            if create:
                try:
                    seg = shared_memory.SharedMemory(
                        name=name, create=True, size=self.segment_bytes)
                except FileExistsError:
                    seg = shared_memory.SharedMemory(name=name)
            else:
                seg = shared_memory.SharedMemory(name=name)
            _untrack(seg)
            self._segs[name] = seg
        return seg

    @property
    def _slabs_per_seg(self) -> int:
        return self.segment_bytes // self.slab_bytes

    def _find_run(self, idx: Dict, need: int) -> Optional[Tuple[str, int]]:
        """First contiguous free run of ``need`` slabs, growing the
        segment list up to the cap when every existing one is packed."""
        for seg in idx["segments"]:
            used = [False] * self._slabs_per_seg
            for key, rec in idx["allocs"].items():
                s, off = key.rsplit(":", 1)
                if s != seg:
                    continue
                first = int(off) // self.slab_bytes
                for i in range(first, first + int(rec["slabs"])):
                    used[i] = True
            run = 0
            for i, u in enumerate(used):
                run = 0 if u else run + 1
                if run == need:
                    return seg, (i - need + 1) * self.slab_bytes
        if need <= self._slabs_per_seg \
                and len(idx["segments"]) < _MAX_SEGMENTS:
            name = f"{self._seg_name_base}_{len(idx['segments'])}"
            self._attach(name, create=True)
            idx["segments"].append(name)
            return name, 0
        return None

    # --- public API ---------------------------------------------------------
    def put(self, data, *, dtype: Optional[str] = None,
            shape: Optional[Tuple[int, ...]] = None) -> ObjectRef:
        """Copy ``data`` (any buffer) into the arena once and pin it in
        this process's lease. Raises :class:`ArenaFull` when no slab run
        fits — callers fall back to the inline wire."""
        view = memoryview(data).cast("B")
        length = view.nbytes
        need = max(1, -(-length // self.slab_bytes))
        with self._lock, self._flock():
            idx = self._load_index()
            spot = self._find_run(idx, need)
            if spot is None:
                raise ArenaFull(
                    f"{length} B needs {need} contiguous slabs; arena at "
                    f"segment cap ({len(idx['segments'])})")
            seg_name, offset = spot
            idx["gen"] = gen = int(idx["gen"]) + 1
            idx["allocs"][f"{seg_name}:{offset}"] = {
                "gen": gen, "slabs": need, "len": length,
                "consumed": False, "t": round(time.time(), 3)}
            self._save_index(idx)
            seg = self._attach(seg_name)
            seg.buf[offset:offset + length] = view
            self._pin(f"{seg_name}:{offset}:{gen}")
            c = _counters()
            c["put"].inc(length)
            c["allocs"].inc()
            c["live"].labels(arena=self._seg_name_base).set(
                sum(int(r["slabs"]) for r in idx["allocs"].values()))
        return ObjectRef(segment=seg_name, offset=offset, length=length,
                         generation=gen, dtype=dtype, shape=shape)

    def _validate(self, idx: Dict, ref: ObjectRef) -> None:
        rec = idx["allocs"].get(ref.key)
        if rec is None or int(rec["gen"]) != ref.generation:
            _counters()["stale"].inc()
            raise StaleObjectRef(
                f"{ref.key} gen {ref.generation} is "
                f"{'freed' if rec is None else 'reused (gen %d)' % rec['gen']}")

    def checkout(self, ref: ObjectRef, *, pin: bool = True):
        """Map the blob read-only. Returns a C-contiguous numpy view
        (shaped when the descriptor carries dtype/shape, else uint8) —
        zero copy; the view stays valid while the pin holds. Raises
        :class:`StaleObjectRef` on a freed/reused generation."""
        import numpy as np
        with self._lock, self._flock():
            self._validate(self._load_index(), ref)
            if pin:
                self._pin(f"{ref.key}:{ref.generation}")
        seg = self._attach(ref.segment)
        arr = np.frombuffer(seg.buf, dtype=np.uint8, count=ref.length,
                            offset=ref.offset)
        if ref.dtype is not None:
            arr = arr.view(np.dtype(ref.dtype))
            if ref.shape is not None:
                arr = arr.reshape(ref.shape)
        arr.flags.writeable = False
        _counters()["mapped"].inc(ref.length)
        return arr

    def _maybe_free(self, idx: Dict, ref: ObjectRef) -> bool:
        rec = idx["allocs"].get(ref.key)
        if rec is None or int(rec["gen"]) != ref.generation:
            return False
        if rec.get("consumed") \
                and not self._pinned_anywhere(f"{ref.key}:{ref.generation}"):
            del idx["allocs"][ref.key]
            return True
        return False

    def release(self, ref: ObjectRef) -> None:
        """Drop this process's pin (producer done handing off, or a
        consumer abandoning an unacked claim). Idempotent; frees the
        slabs when the blob is both consumed and unpinned."""
        with self._lock, self._flock():
            self._unpin(f"{ref.key}:{ref.generation}")
            idx = self._load_index()
            if self._maybe_free(idx, ref):
                self._save_index(idx)

    def done(self, ref: ObjectRef) -> None:
        """Consumer finished with the blob (data copied out / result
        published / entry acked): unpin AND mark consumed, freeing the
        slabs once every other pin is gone. Idempotent — a double ack or
        an already-freed blob is a no-op."""
        with self._lock, self._flock():
            self._unpin(f"{ref.key}:{ref.generation}")
            idx = self._load_index()
            rec = idx["allocs"].get(ref.key)
            if rec is not None and int(rec["gen"]) == ref.generation:
                rec["consumed"] = True
                self._maybe_free(idx, ref)
                self._save_index(idx)

    def sweep(self, dead_pids: Optional[List[int]] = None) -> Dict:
        """Crash recovery: drop lease files of dead processes (the given
        pids, else every lease whose pid no longer exists), then free
        allocations that became consumed-and-unpinned. Fleet supervisors
        call this when they reap a worker; ``zoo-shm gc`` calls it for
        orphaned arenas."""
        swept = freed = 0
        with self._lock, self._flock():
            lease_dir = os.path.join(self.root, "leases")
            try:
                names = os.listdir(lease_dir)
            except OSError:
                names = []
            for n in names:
                if n.endswith(".tmp"):
                    continue
                path = os.path.join(lease_dir, n)
                try:
                    with open(path) as f:
                        pid = int(json.load(f).get("pid", -1))
                except (OSError, ValueError):
                    continue
                dead = pid in dead_pids if dead_pids is not None \
                    else not _pid_alive(pid)
                if dead:
                    with contextlib.suppress(OSError):
                        os.unlink(path)
                    swept += 1
            idx = self._load_index()
            for key in list(idx["allocs"]):
                rec = idx["allocs"][key]
                if rec.get("consumed") and not self._pinned_anywhere(
                        f"{key}:{rec['gen']}"):
                    del idx["allocs"][key]
                    freed += 1
            self._save_index(idx)
            if swept:
                _counters()["swept"].inc(swept)
            _counters()["live"].labels(arena=self._seg_name_base).set(
                sum(int(r["slabs"]) for r in idx["allocs"].values()))
        return {"leases_swept": swept, "freed": freed}

    def gc(self, grace_s: float = 300.0) -> Dict:
        """:meth:`sweep` plus: free *unconsumed* allocations older than
        ``grace_s`` with no live pin anywhere — blobs whose producer died
        before any consumer saw them (nothing will ever consume these)."""
        out = self.sweep()
        orphans = 0
        now = time.time()
        with self._lock, self._flock():
            idx = self._load_index()
            for key in list(idx["allocs"]):
                rec = idx["allocs"][key]
                if not rec.get("consumed") \
                        and now - float(rec.get("t", 0)) >= grace_s \
                        and not self._pinned_anywhere(f"{key}:{rec['gen']}"):
                    del idx["allocs"][key]
                    orphans += 1
            self._save_index(idx)
        out["orphans_freed"] = orphans
        return out

    def stats(self) -> Dict:
        with self._lock, self._flock():
            idx = self._load_index()
            live = sum(int(r["slabs"]) for r in idx["allocs"].values())
            leases = [n for n in os.listdir(os.path.join(
                self.root, "leases"))] if os.path.isdir(
                os.path.join(self.root, "leases")) else []
            return {
                "segments": len(idx["segments"]),
                "slabs_total": len(idx["segments"]) * self._slabs_per_seg,
                "slabs_live": live,
                "allocs_live": len(idx["allocs"]),
                "bytes_live": sum(int(r["len"])
                                  for r in idx["allocs"].values()),
                "leases": len([n for n in leases
                               if not n.endswith(".tmp")]),
                "gen": int(idx["gen"])}

    def close(self) -> None:
        """Graceful per-process detach: drop this process's pins (their
        lease file with them), free what that makes freeable, and close
        the local segment mappings. The arena itself survives for the
        other processes."""
        if self._closed:
            return
        self._closed = True
        with self._lock, self._flock():
            self._pins.clear()
            self._write_lease()     # pins now empty -> unlinks the file
            idx = self._load_index()
            changed = False
            for key in list(idx["allocs"]):
                rec = idx["allocs"][key]
                if rec.get("consumed") and not self._pinned_anywhere(
                        f"{key}:{rec['gen']}"):
                    del idx["allocs"][key]
                    changed = True
            if changed:
                self._save_index(idx)
        for seg in self._segs.values():
            with contextlib.suppress(Exception):
                seg.close()
        self._segs.clear()

    def destroy(self) -> int:
        """Unlink every segment and remove the control dir — the
        ``zoo-shm gc`` end state for a dead arena. Returns the number of
        segments unlinked."""
        n = 0
        with self._lock, self._flock():
            idx = self._load_index()
            for name in idx["segments"]:
                seg = self._segs.pop(name, None)
                if seg is not None:
                    # live numpy views keep the mmap exported; the views
                    # die with the process, the name must die now
                    with contextlib.suppress(BufferError, Exception):
                        seg.close()
                try:
                    _shm_unlink(name)
                    n += 1
                except FileNotFoundError:
                    pass
        self._segs.clear()
        self._closed = True
        import shutil
        shutil.rmtree(self.root, ignore_errors=True)
        return n


def _shm_unlink(name: str) -> None:
    """Remove a segment NAME without routing through resource_tracker
    (we unregistered at attach; SharedMemory.unlink would ping the
    tracker about a name it no longer knows)."""
    try:
        import _posixshmem
        _posixshmem.shm_unlink("/" + name)
    except ImportError:     # pragma: no cover — non-CPython fallback
        from multiprocessing import shared_memory
        seg = shared_memory.SharedMemory(name=name)
        seg.close()
        seg.unlink()


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:     # exists, owned by someone else
        return True
    except OSError as e:        # pragma: no cover — exotic kernels
        return e.errno != errno.ESRCH
    return True


_ARENAS: Dict[str, BlobArena] = {}
_ARENAS_LOCK = threading.Lock()


def arena_for(key: str, *, slab_bytes: Optional[int] = None,
              segment_bytes: Optional[int] = None) -> BlobArena:
    """Process-cached arena for a logical key (one per broker spec base).
    Sizing comes from ``ZOO_SHM_SLAB_MB`` / ``ZOO_SHM_ARENA_MB`` unless
    overridden."""
    from ..common import knobs
    root = arena_root_for(key)
    with _ARENAS_LOCK:
        a = _ARENAS.get(root)
        if a is None or a._closed:
            a = BlobArena(
                root,
                slab_bytes=int(slab_bytes if slab_bytes is not None
                               else knobs.get("ZOO_SHM_SLAB_MB") * (1 << 20)),
                segment_bytes=int(
                    segment_bytes if segment_bytes is not None
                    else knobs.get("ZOO_SHM_ARENA_MB") * (1 << 20)))
            _ARENAS[root] = a
        return a
