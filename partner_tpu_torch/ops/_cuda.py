"""Builds and loads the hand-written CUDA kernels of ``partner_tpu_torch/csrc``.

Build model (the shape of ``partner_tpu/native/__init__.py``): every
``csrc/*.cu`` is compiled by one ``nvcc`` call into a shared library with a
plain C interface, cached in ``partner_tpu_torch/.build/`` under a hash of
the sources and flags, and loaded with ``ctypes``. Nothing is built at
import: the first CUDA call of a kernel wrapper builds it, so CPU-only
hosts (no ``nvcc``) import every module freely.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an error.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, ".build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
_SIGNATURES = {
    # x, mask, w1, a1, b1, w2, a2, b2, out, B, P, stream
    "ptt_stem2_bf16": [_P] * 9 + [_I, _I, _P],
    # q, k, v, pos, mask|NULL, w1, b1, w2, b2, tau, out, nW, nh, nW_mask,
    # stream
    "ptt_swin_attn_bf16": [_P] * 11 + [_I, _I, _I, _P],
}


class KernelLibrary:
    """The loaded library plus what its build took (``build_seconds`` is
    0.0 when a cached library was reused, ``ptxas_log`` holds nvcc's
    per-kernel register and shared-memory report)."""

    def __init__(self, lib, so_path, build_seconds, ptxas_log):
        self.lib = lib
        self.so_path = so_path
        self.build_seconds = build_seconds
        self.ptxas_log = ptxas_log


_LOCK = threading.Lock()
_LIBRARY = None


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of partner_tpu_torch "
                       "are built with nvcc at first use")


def _build_and_load():
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    os.makedirs(_BUILD, exist_ok=True)
    so_path = os.path.join(_BUILD, f"partner_kernels_{h.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(so_path):
        tmp = f"{so_path}.tmp{os.getpid()}"
        t0 = time.perf_counter()
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
                             capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, so_path)  # atomic for concurrent processes
    lib = ctypes.CDLL(so_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib, so_path, seconds, log)


def library():
    """The kernel library, built on first call."""
    global _LIBRARY
    with _LOCK:
        if _LIBRARY is None:
            _LIBRARY = _build_and_load()
    return _LIBRARY


def check(err, name):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device):
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(cond, msg):
    if not cond:
        raise ValueError(msg)
