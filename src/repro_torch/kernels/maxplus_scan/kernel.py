"""Build, bind and launch the hand-written CUDA (max,+) scan.

The kernel (``csrc/maxplus_scan.cu``) replaces the Pallas TPU kernel
`repro.kernels.maxplus_scan.kernel.maxplus_scan_pallas`.  It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use, cached under ``_build/`` beside this file by a
hash of the source and flags, and called through ctypes on PyTorch's
current stream.  Nothing is compiled or loaded at import.

``launches`` counts the kernel launches this process made; it is the
evidence that a run went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Optional

import torch

Tensor = torch.Tensor

_HERE = pathlib.Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "maxplus_scan.cu",)
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = 0          # kernel launches in this process
build_log = ""        # nvcc's output for the last build (ptxas -v report)
build_seconds: Optional[float] = None

_lib: Optional[ctypes.CDLL] = None
_ENTRY = {torch.float32: "maxplus_scan_f32", torch.float64: "maxplus_scan_f64"}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the (max,+) scan "
                       "kernel is built from source at first use")


def load_library() -> ctypes.CDLL:
    """Build the kernel library if needed and load it (once per process)."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libmaxplus_scan-{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
            capture_output=True, text=True, check=False)
        build_seconds = time.perf_counter() - t0
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(lib_path))
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64,
                                               ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check_carry(c: Optional[Tensor], a: Tensor, name: str) -> None:
    if c is None:
        return
    if (c.device != a.device or c.dtype != a.dtype
            or c.shape != a.shape[:1] or not c.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {a.dtype} tensor of shape "
            f"({a.shape[0]},) on {a.device}; got {c.dtype} "
            f"{tuple(c.shape)} on {c.device}")


def maxplus_scan_cuda(a: Tensor, b: Tensor,
                      carry_a: Optional[Tensor] = None,
                      carry_b: Optional[Tensor] = None
                      ) -> tuple[Tensor, Tensor]:
    """Launch the kernel on (rows, len) CUDA tensors; returns (out_a, out_b).

    ``carry_a`` / ``carry_b`` are optional (rows,) seeds; a missing one is
    the identity (-inf, 0).  Raises on anything the kernel does not take:
    no conversion, no fallback.
    """
    global launches
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"the CUDA scan needs CUDA tensors; got "
                         f"{a.device} and {b.device}")
    if a.dtype not in _ENTRY or b.dtype != a.dtype:
        raise TypeError(f"the CUDA scan takes float32 or float64 a and b of "
                        f"one dtype; got {a.dtype} and {b.dtype}")
    if a.ndim != 2 or b.shape != a.shape:
        raise ValueError(f"a and b must be (rows, len) of one shape; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    _check_carry(carry_a, a, "carry_a")
    _check_carry(carry_b, a, "carry_b")
    rows, length = a.shape
    if rows >= 2 ** 31:
        raise ValueError(f"at most 2**31 - 1 rows; got {rows}")
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b)
    if a.numel() == 0:
        return out_a, out_b
    fn = getattr(load_library(), _ENTRY[a.dtype])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(),
                 None if carry_a is None else carry_a.data_ptr(),
                 None if carry_b is None else carry_b.data_ptr(),
                 out_a.data_ptr(), out_b.data_ptr(), rows, length, stream)
    if err != 0:
        raise RuntimeError(f"maxplus_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out_a, out_b
