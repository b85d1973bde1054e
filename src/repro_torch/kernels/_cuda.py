"""Build and load the port's hand-written CUDA kernels; pick a path.

Each kernel source (``csrc/<name>.cu`` in its package) is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface at
first use, cached under the package's ``_build/`` by a hash of the
sources and flags, and called through ctypes on PyTorch's current
stream.  One `CudaLibrary` per source, so the libraries build
independently (and, from several threads, in parallel).  Nothing is
compiled or loaded at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Optional, Sequence

import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

IMPLS = ("auto", "torch", "cuda")
ENCODE_ERROR = 100000   # hop::kEncodeError: + the CUresult of a failed
                        # cuTensorMapEncodeTiled (csrc/hopper.cuh)


def resolve_impl(impl: str = "auto",
                 device: DeviceLike = DEFAULT_DEVICE, *,
                 what: str = "scan") -> str:
    """"auto" -> "cuda" for a CUDA device, "torch" otherwise."""
    if impl not in IMPLS:
        raise ValueError(f"unknown {what} impl {impl!r}; choose one of "
                         f"{IMPLS}")
    if impl != "auto":
        return impl
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


class CudaLibrary:
    """One kernel source built into one shared library, loaded once.

    ``entries`` maps each exported C function to its ctypes argument
    types; every entry returns ``int`` (the ``cudaGetLastError()`` after
    its launch, or ENCODE_ERROR + a CUresult).  ``headers`` are the local
    headers the source includes: they enter the cache key.
    """

    def __init__(self, source: pathlib.Path, entries: dict[str, Sequence],
                 headers: Sequence[pathlib.Path] = ()):
        self.source = source
        self.headers = tuple(headers)
        self.entries = dict(entries)
        self.build_dir = source.parent.parent / "_build"
        self.build_log = ""      # nvcc's output (the ptxas -v report)
        self.build_seconds: Optional[float] = None
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    @property
    def name(self) -> str:
        return self.source.stem

    def load(self) -> ctypes.CDLL:
        """Build the library if needed and load it (once per process)."""
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
            return self._lib

    def _build_and_load(self) -> ctypes.CDLL:
        digest = hashlib.sha256()
        for path in (self.source, *self.headers):
            digest.update(path.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        lib_path = (self.build_dir
                    / f"lib{self.name}-{digest.hexdigest()[:16]}.so")
        if not lib_path.exists():
            self.build_dir.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                capture_output=True, text=True, check=False)
            self.build_seconds = time.perf_counter() - t0
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"({proc.returncode}):\n{self.build_log}")
            os.replace(tmp, lib_path)  # atomic: concurrent builds agree
        lib = ctypes.CDLL(str(lib_path))
        for fn_name, argtypes in self.entries.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        return lib

    def call(self, fn_name: str, device: torch.device, *args) -> None:
        """Launch ``fn_name(*args, stream)`` on ``device``'s current stream;
        raise if the launch reports a CUDA error."""
        fn = getattr(self.load(), fn_name)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err >= ENCODE_ERROR:
            raise RuntimeError(f"{fn_name}: a TMA tensor map could not be "
                               f"encoded (CUresult {err - ENCODE_ERROR})")
        if err != 0:
            raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device pointer for ctypes; None stays a null pointer."""
    return None if t is None else t.data_ptr()


def int64_array(values: Sequence[int]) -> ctypes.Array:
    """Host int64 array for an entry point's ``const int64_t*`` argument
    (the kernels read it before they launch)."""
    return (ctypes.c_int64 * len(values))(*values)


def check_rows16(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t``'s last axis is contiguous and every row of it
    starts on 16 bytes (the attention kernels load 16 B a lane)."""
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            s % vec for s in t.stride()[:-1]):
        raise ValueError(f"{name} needs a contiguous last axis and "
                         f"16-byte aligned rows (strides {t.stride()} of "
                         f"{t.dtype})")


def all_libraries() -> tuple[CudaLibrary, ...]:
    """Every kernel library of the port, so that a caller can build them
    all at once (`chip_smoke.py` builds them in parallel)."""
    from repro_torch.kernels.cin_fuse import kernel as cin
    from repro_torch.kernels.decode_attention import kernel as decode
    from repro_torch.kernels.embedding_bag import kernel as bag
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.fleet_scan import kernel as fleet
    from repro_torch.kernels.hopper import TILE_LIB
    from repro_torch.kernels.jsq_route import kernel as jsq
    from repro_torch.kernels.maxplus_scan import kernel as scan
    from repro_torch.kernels.service_sample import kernel as sample
    return (scan.SCAN_LIB, scan.SEGMENT_LIB, jsq.LIB, flash.LIB, decode.LIB,
            bag.LIB, cin.LIB, fleet.LIB, sample.LIB, TILE_LIB)
