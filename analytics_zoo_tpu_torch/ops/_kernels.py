"""Builder and loader of the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``. A
library is keyed by a hash of the sources (``csrc/*.cu`` and ``*.cuh``) and
of the flags, and built at first use into ``analytics_zoo_tpu_torch/build/``;
``build_all`` starts one ``nvcc`` per source, all at once. A failed build
raises with nvcc's output, a failed launch with the CUDA error string:
nothing falls back to the plain versions. ptxas's resource report
(registers, spills of every kernel instance) is kept beside each library
and read by ``ptxas_report``; ``occupancy`` asks a built library for a
kernel's shared memory and CTAs per SM on the current device.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v"]

_c_p, _c_i, _c_ll, _c_f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float)
# C signature of each kernel library's launcher, by source name
_SIGNATURES = {
    "flash_fwd": ("zoo_flash_fwd",
                  [_c_p, _c_p, _c_p, _c_p, _c_p,          # q k v o lse
                   _c_i, _c_i, _c_i, _c_i, _c_i, _c_i,    # dtype B H Sq Sk D
                   _c_ll, _c_ll, _c_ll, _c_ll, _c_ll, _c_ll,
                   _c_ll, _c_ll, _c_ll, _c_ll, _c_ll, _c_ll,  # b/s/h strides
                   _c_f, _c_i, _c_p]),                    # scale2 causal stream
    # q k v o g lse delta dq | dtype B H Sq Sk D | b/s/h strides of q k v
    # o g dq | scale2 sm_scale causal stream
    "flash_bwd_dq": ("zoo_flash_bwd_dq",
                     [_c_p] * 8 + [_c_i] * 6 + [_c_ll] * 18
                     + [_c_f, _c_f, _c_i, _c_p]),
    # q k v g lse delta dk dv | dtype B H Sq Sk D | b/s/h strides of q k v
    # g dk(=dv) | scale2 1/log2(e) causal stream
    "flash_bwd_dkv": ("zoo_flash_bwd_dkv",
                      [_c_p] * 8 + [_c_i] * 6 + [_c_ll] * 15
                      + [_c_f, _c_f, _c_i, _c_p]),
}
# libraries that answer occupancy queries: (dtype, D, int[2] out)
_OCCUPANCY = {"flash_fwd": "zoo_flash_fwd_occupancy",
              "flash_bwd_dq": "zoo_flash_bwd_dq_occupancy",
              "flash_bwd_dkv": "zoo_flash_bwd_dkv_occupancy"}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for path in [os.path.join(CSRC, name + ".cu")] + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_digest(name)}.so")


def _log_path(name: str) -> str:
    return library_path(name)[:-3] + ".ptxas.txt"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp, final) or None
    when the library is already built."""
    final = library_path(name)
    if os.path.exists(final):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{final}.{os.getpid()}.tmp"
    cmd = ([_nvcc()] + NVCC_FLAGS + ["-I", CSRC, "-o", tmp,
                                      os.path.join(CSRC, name + ".cu")])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final, cmd


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, final, cmd = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name} "
                           f"(rc={proc.returncode}):\n{' '.join(cmd)}\n{out}")
    with open(f"{tmp}.log", "w") as f:
        f.write(out)
    os.replace(f"{tmp}.log", final[:-3] + ".ptxas.txt")
    os.replace(tmp, final)       # atomic: a reader never sees half a file


def build_all(names=None) -> Dict[str, str]:
    """Build every kernel library (one nvcc per source, in parallel).
    Returns {name: library path}."""
    names = list(sources() if names is None else names)
    with _lock:
        started = [(n, _start_build(n)) for n in names]
        for n, s in started:
            _finish_build(n, s)
    return {n: library_path(n) for n in names}


def entry_point(name: str) -> str:
    """The name of ``csrc/<name>.cu``'s C launcher."""
    return _SIGNATURES[name][0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(library_path(name))
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            lib.zoo_cuda_error_string.argtypes = [ctypes.c_int]
            lib.zoo_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_INSTANCE = re.compile(
    r"([a-z][a-z_]*?)_kernelI(f|13__nv_bfloat16)Li(\d+)E")
_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                     r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(name: str) -> List[Dict]:
    """ptxas's report for each kernel instance of a built library:
    [{"kernel", "dtype", "head_dim", "registers", "stack_bytes",
    "spill_store_bytes", "spill_load_bytes"}]."""
    with open(_log_path(name)) as f:
        text = f.read()
    out: List[Dict] = []
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            inst = _INSTANCE.search(m.group(1))
            if inst is None:
                out.append(None)
                continue
            out.append({"kernel": inst.group(1),
                        "dtype": "f32" if inst.group(2) == "f" else "bf16",
                        "head_dim": int(inst.group(3))})
        elif out and out[-1] is not None:
            m = _SPILLS.search(line)
            if m:
                out[-1].update(stack_bytes=int(m.group(1)),
                               spill_store_bytes=int(m.group(2)),
                               spill_load_bytes=int(m.group(3)))
            m = _REGS.search(line)
            if m:
                out[-1]["registers"] = int(m.group(1))
    return [r for r in out if r is not None]


def occupancy(name: str, dtype_code: int, head_dim: int) -> Dict[str, int]:
    """Dynamic shared memory per CTA and CTAs per SM of one instance of a
    kernel, from the CUDA runtime on the current device."""
    lib = load(name)
    fn = getattr(lib, _OCCUPANCY[name])
    fn.argtypes = [_c_i, _c_i, ctypes.POINTER(_c_i)]
    fn.restype = ctypes.c_int
    info = (_c_i * 2)()
    check(lib, fn(dtype_code, head_dim, info), f"{name} occupancy")
    return {"smem_bytes": info[0], "ctas_per_sm": info[1]}


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        msg = lib.zoo_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err}: {msg}")
