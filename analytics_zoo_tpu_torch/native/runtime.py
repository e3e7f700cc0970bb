"""ctypes bindings for the native host runtime (counterpart of
``analytics_zoo_tpu/native/runtime.py``): :func:`load`, :func:`version`,
the aligned bump allocator :class:`Arena`, the blocking token queue
:class:`NativeQueue`, :func:`shuffled_indices`, :func:`gather_rows`,
:func:`pad_sequences` and :func:`f32_to_bf16_bits`.

``zoo_runtime.cc`` beside this file is the JAX package's source, unchanged
but for comments. It is built with the same g++ command at first use into
``native/build/`` and loaded with ctypes. If the build fails, a warning is
logged and each call uses its numpy fallback, as in the JAX package: the
shuffle then is ``np.random.RandomState(seed).permutation(n)``, which
differs from the native xoshiro Fisher-Yates order. Both packages decide
this the same way in the same environment, so with the native library
built in both, a shuffled epoch visits the rows in the same order, and
the padded sequences and bf16 bit patterns are the same bits.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
import time
import weakref
from typing import Optional

import numpy as np

logger = logging.getLogger("analytics_zoo_tpu_torch")

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, "zoo_runtime.cc")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_SO = os.path.join(_BUILD_DIR, "libzoo_runtime.so")

_lib = None
_lib_lock = threading.Lock()


def _build() -> Optional[str]:
    """g++ into a file of this process, renamed over the library when it
    is complete: another process never loads a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        os.replace(tmp, _SO)
        return _SO
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        logger.warning("native runtime build failed (%s); using numpy "
                       "fallbacks", e)
        return None


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib if _lib is not False else None
        path = _SO
        if not os.path.exists(path) or (
                os.path.getmtime(_SRC) > os.path.getmtime(path)):
            path = _build()
        if path is None:
            _lib = False
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            logger.warning("native runtime load failed: %s", e)
            _lib = False
            return None
        lib.za_arena_create.restype = ctypes.c_void_p
        lib.za_arena_create.argtypes = [ctypes.c_size_t]
        lib.za_arena_alloc.restype = ctypes.c_void_p
        lib.za_arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                       ctypes.c_size_t]
        lib.za_arena_used.restype = ctypes.c_size_t
        lib.za_arena_used.argtypes = [ctypes.c_void_p]
        lib.za_arena_capacity.restype = ctypes.c_size_t
        lib.za_arena_capacity.argtypes = [ctypes.c_void_p]
        lib.za_arena_reset.argtypes = [ctypes.c_void_p]
        lib.za_arena_destroy.argtypes = [ctypes.c_void_p]
        lib.za_queue_create.restype = ctypes.c_void_p
        lib.za_queue_create.argtypes = [ctypes.c_size_t]
        lib.za_queue_push.restype = ctypes.c_int
        lib.za_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int]
        lib.za_queue_pop.restype = ctypes.c_int
        lib.za_queue_pop.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.c_int]
        lib.za_queue_size.restype = ctypes.c_size_t
        lib.za_queue_size.argtypes = [ctypes.c_void_p]
        lib.za_queue_close.argtypes = [ctypes.c_void_p]
        lib.za_queue_destroy.argtypes = [ctypes.c_void_p]
        lib.za_pad_sequences_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)]
        lib.za_f32_to_bf16.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int64]
        lib.za_version.restype = ctypes.c_char_p
        lib.za_shuffled_indices.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.za_gather_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
        _lib = lib
        return lib


def available() -> bool:
    return load() is not None


def version() -> str:
    lib = load()
    return lib.za_version().decode() if lib else "numpy-fallback"


class Arena:
    """Aligned bump allocator for host buffers.

    ``reset()`` makes earlier arrays' memory reusable by later allocations:
    callers must not hold views across a reset. The native block is freed
    only once ``close()`` (or the Arena's collection) was requested and no
    ``alloc_array`` view is alive: each returned array's base buffer pins
    the Arena and carries a finalizer, and ``close()`` defers
    ``za_arena_destroy`` to the last view's death. After ``close()`` no
    allocation is made.
    """

    def __init__(self, capacity: int):
        self._lib = load()
        self.capacity = capacity
        self._live_views = 0
        self._close_requested = False
        # RLock: the cyclic GC can run a view's finalizer (_on_view_dead)
        # in this thread while it holds the lock inside alloc_array
        self._state_lock = threading.RLock()
        if self._lib:
            self._h = self._lib.za_arena_create(capacity)
            if not self._h:
                raise MemoryError(f"arena of {capacity} bytes")
        else:
            self._h = None

    def alloc_array(self, shape, dtype=np.float32, align: int = 64
                    ) -> np.ndarray:
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        if not self._lib:
            return np.empty(shape, dtype)
        with self._state_lock:
            if self._close_requested or self._h is None:
                raise RuntimeError("arena is closed")
            ptr = self._lib.za_arena_alloc(self._h, nbytes, align)
            if not ptr:
                raise MemoryError("arena exhausted")
            self._live_views += 1
        # the Python objects are built outside the lock (building them can
        # run the GC, hence finalizers); the count is already reserved, so
        # a concurrent close() stays deferred
        fin = None
        try:
            buf = (ctypes.c_char * nbytes).from_address(ptr)
            buf._zoo_arena = self       # the view's .base chain pins us
            fin = weakref.finalize(buf, self._on_view_dead)
            return np.frombuffer(buf, dtype=dtype).reshape(shape)
        except BaseException:
            # detach first, so the reservation is given back only once
            if fin is not None:
                fin.detach()
            self._on_view_dead()
            raise

    def _on_view_dead(self):
        with self._state_lock:
            self._live_views -= 1
            do_free = self._close_requested and self._live_views == 0
        if do_free:
            self._destroy()

    @property
    def used(self) -> int:
        return self._lib.za_arena_used(self._h) if self._lib else 0

    def reset(self):
        if self._lib:
            self._lib.za_arena_reset(self._h)

    def _destroy(self):
        with self._state_lock:
            h, self._h = self._h, None
        if h:
            self._lib.za_arena_destroy(h)

    def close(self):
        """Request teardown: frees at once if no view is alive, else when
        the last view is collected."""
        if self._lib and self._h:
            with self._state_lock:
                self._close_requested = True
                do_free = self._live_views == 0
            if do_free:
                self._destroy()

    def __del__(self):
        try:
            self.close()
        except (OSError, RuntimeError, AttributeError):
            # interpreter shutdown: the library or our attributes may be gone
            pass


def shuffled_indices(n: int, seed: int = 0) -> np.ndarray:
    """A permutation of ``range(n)`` as int64, a function of ``seed``."""
    lib = load()
    out = np.empty(n, np.int64)
    if lib and n:
        lib.za_shuffled_indices(
            ctypes.c_uint64(seed),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n)
        return out
    return np.random.RandomState(seed).permutation(n).astype(np.int64)


def gather_rows(src: np.ndarray, idx: np.ndarray, num_threads: int = 4,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """``out[i] = src[idx[i]]``: a threaded memcpy batch assembly. ``out``
    (C-contiguous, the gather's shape and dtype) lets a caller gather
    straight into a reused buffer, such as a pinned staging tensor's numpy
    view."""
    lib = load()
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, np.int64)
    shape = (len(idx),) + src.shape[1:]
    if out is not None and (out.shape != shape or out.dtype != src.dtype
                            or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous {shape} {src.dtype}, "
                         f"got {out.shape} {out.dtype}")
    if lib is None:
        if out is None:
            return src[idx]
        np.take(src, idx, axis=0, out=out)
        return out
    if out is None:
        out = np.empty(shape, src.dtype)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], initial=1))
    lib.za_gather_rows(
        src.ctypes.data_as(ctypes.c_char_p), row_bytes,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
        out.ctypes.data_as(ctypes.c_char_p), num_threads)
    return out


def pad_sequences(seqs, max_len: int, pad_value: int = 0,
                  return_mask: bool = True):
    """Ragged int sequences -> ``(n, max_len)`` int32, truncated at the
    end, with an f32 mask of the real positions."""
    lib = load()
    n = len(seqs)
    if lib is None:
        out = np.full((n, max_len), pad_value, np.int32)
        mask = np.zeros((n, max_len), np.float32)
        for i, s in enumerate(seqs):
            k = min(len(s), max_len)
            out[i, :k] = np.asarray(s[:k], np.int32)
            mask[i, :k] = 1.0
        return (out, mask) if return_mask else out
    flat = np.concatenate([np.asarray(s, np.int32) for s in seqs]) \
        if n else np.zeros(0, np.int32)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    out = np.empty((n, max_len), np.int32)
    mask = np.empty((n, max_len), np.float32) if return_mask else None
    lib.za_pad_sequences_i32(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, max_len, pad_value,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if return_mask else None)
    return (out, mask) if return_mask else out


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16 bit pattern (uint16)."""
    lib = load()
    x = np.ascontiguousarray(x, np.float32)
    if lib is None:
        bits = x.view(np.uint32)
        rounding = 0x7FFF + ((bits >> 16) & 1)
        return ((bits + rounding) >> 16).astype(np.uint16)
    out = np.empty(x.shape, np.uint16)
    lib.za_f32_to_bf16(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), x.size)
    return out


class NativeQueue:
    """Blocking MPMC queue of tokens: the payloads stay in a Python dict,
    and only their integer tokens cross the ABI, in order."""

    def __init__(self, capacity: int = 8):
        self._lib = load()
        self._store = {}
        self._next = 1
        self._plock = threading.Lock()
        self._closed = threading.Event()
        if self._lib:
            self._q = self._lib.za_queue_create(capacity)
        else:
            import queue
            self._q = queue.Queue(maxsize=capacity)

    def put(self, item, timeout_ms: int = -1) -> bool:
        if self._lib:
            with self._plock:
                token = self._next
                self._next += 1
                self._store[token] = item
            ok = self._lib.za_queue_push(self._q, ctypes.c_void_p(token),
                                         timeout_ms)
            if not ok:
                with self._plock:
                    self._store.pop(token, None)
            return bool(ok)
        # fallback: poll in short slices so close() can unblock a waiter
        import queue as _queue
        deadline = (None if timeout_ms < 0
                    else time.monotonic() + timeout_ms / 1000)
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except _queue.Full:
                if deadline is not None and time.monotonic() > deadline:
                    return False
        return False

    def get(self, timeout_ms: int = -1):
        if self._lib:
            out = ctypes.c_void_p()
            ok = self._lib.za_queue_pop(self._q, ctypes.byref(out),
                                        timeout_ms)
            if not ok:
                return None
            with self._plock:
                return self._store.pop(out.value)
        import queue as _queue
        deadline = (None if timeout_ms < 0
                    else time.monotonic() + timeout_ms / 1000)
        while True:
            try:
                return self._q.get(timeout=0.05)
            except _queue.Empty:
                if self._closed.is_set():
                    return None
                if deadline is not None and time.monotonic() > deadline:
                    return None

    def qsize(self) -> int:
        if self._lib:
            return self._lib.za_queue_size(self._q)
        return self._q.qsize()

    def close(self):
        self._closed.set()
        if self._lib and self._q:
            self._lib.za_queue_close(self._q)

    def destroy(self):
        if self._lib and self._q:
            self._lib.za_queue_destroy(self._q)
            self._q = None
