"""Build and load the hand-written CUDA kernels (``paddle_tpu_torch/csrc``).

Each source is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which is
loaded with ``ctypes``.  Libraries land in ``paddle_tpu_torch/_build/``,
named by a hash of the source and the flags, so an edited source builds
anew and an unchanged one is reused.  Nothing here runs at import: the
CPU tests import every module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# one library per source file; each entry lists the C functions it
# exports with their ctypes signature (c_void_p for every pointer and the
# stream, or ctypes would pass them as 32-bit ints)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SOURCES: Dict[str, Dict[str, list]] = {
    # tensors (the output last), then B*N, N, S, H, dtype, stream
    "flash_decode": {
        "flash_decode_launch": [_P] * 6 + [_I] * 5 + [_P],
        "flash_decode_quant_launch": [_P] * 8 + [_I] * 5 + [_P],
    },
    # tensors, then the int64 dims array, scale, causal, dtype, stream
    "flash_attention": {
        "flash_attn_fwd_launch": [_P] * 7 + [_F, _I, _I, _P],
        "flash_attn_dq_launch": [_P] * 9 + [_F, _I, _I, _P],
        "flash_attn_dkv_launch": [_P] * 10 + [_F, _I, _I, _P],
    },
    # tensors, then M, C, (relu,) dtype, stream; bn_chunks sizes the
    # partials buffers of the two reductions
    "fused_bn": {
        "bn_chunks": [_L, _I, _I],
        "bn_stats_launch": [_P] * 5 + [_L, _I, _I, _P],
        "bn_apply_launch": [_P] * 4 + [_L, _I, _I, _I, _P],
        "bn_bwd_reduce_launch": [_P] * 8 + [_L, _I, _I, _I, _P],
        "bn_bwd_dx_launch": [_P] * 8 + [_L, _I, _I, _I, _P],
    },
    # tensors, the int64 dims array, dtype, stream; conv_tiles sizes the
    # partials buffers
    "fused_conv": {
        "conv_tiles": [_L],
        "conv_stats_launch": [_P] * 8 + [_I, _P],
    },
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}       # guarded-by: _LOCK


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels of paddle_tpu_torch build on first use on a machine "
            "with the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, every header of
    ``csrc`` (a source may include any of them) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, path), "rb") as f:
            h.update(path.encode() + b"\0" + f.read())
    digest = h.hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}_{digest[:12]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: {"seconds": s, "log": compiler output, "cached": bool}}``
    and raises if any compile fails."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, report = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            report[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log,
                        "cached": False}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)        # atomic: a concurrent loader never
    if failed:                      # sees a half-written library
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if missing, with
    ``argtypes``/``restype`` set for every exported function."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            for fn, argtypes in SOURCES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
