"""ctypes bindings for the native host runtime (counterpart of
``analytics_zoo_tpu/native/runtime.py``), for the parts the input path
needs: :func:`load`, :func:`shuffled_indices` and :func:`gather_rows`.

``zoo_runtime.cc`` beside this file is the JAX package's source, unchanged
but for comments. It is built with the same g++ command at first use into
``native/build/`` and loaded with ctypes. If the build fails, a warning is
logged and each call uses its numpy fallback, as in the JAX package: the
shuffle then is ``np.random.RandomState(seed).permutation(n)``, which
differs from the native xoshiro Fisher-Yates order. Both packages decide
this the same way in the same environment, so with the native library
built in both, a shuffled epoch visits the rows in the same order.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
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
        lib.za_shuffled_indices.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.za_gather_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
        _lib = lib
        return lib


def available() -> bool:
    return load() is not None


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
