"""Bind and launch the hand-written CUDA (max,+) scans.

Two kernels, each in its own source and library:

* ``csrc/maxplus_scan.cu`` replaces the Pallas TPU kernel
  `repro.kernels.maxplus_scan.kernel.maxplus_scan_pallas`;
* ``csrc/maxplus_segment_scan.cu`` replaces
  `repro.kernels.maxplus_scan.kernel.maxplus_segment_scan_pallas`.

Both are built by `repro_torch.kernels._cuda.CudaLibrary` at first use.
``launches`` and ``segment_launches`` count the launches this process
made; they are the evidence that a run went through the kernels.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import torch

from repro_torch.kernels._cuda import NVCC_FLAGS, CudaLibrary, ptr

Tensor = torch.Tensor

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_HEADERS = (_CSRC / "maxplus_common.cuh",)
_P = ctypes.c_void_p
_I = ctypes.c_int64

SCAN_LIB = CudaLibrary(
    _CSRC / "maxplus_scan.cu",
    {name: [_P] * 6 + [_I, _I, _P]
     for name in ("maxplus_scan_f32", "maxplus_scan_f64")},
    headers=_HEADERS)
SEGMENT_LIB = CudaLibrary(
    _CSRC / "maxplus_segment_scan.cu",
    {name: [_P] * 5 + [_I, _I, _I, _P]
     for name in ("maxplus_segment_scan_f32", "maxplus_segment_scan_f64")},
    headers=_HEADERS)
SOURCES = (SCAN_LIB.source, SEGMENT_LIB.source)

__all__ = ["NVCC_FLAGS", "SCAN_LIB", "SEGMENT_LIB", "SOURCES",
           "maxplus_scan_cuda", "maxplus_segment_scan_cuda"]

launches = 0          # plain-scan kernel launches in this process
segment_launches = 0  # segmented-scan kernel launches in this process

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check_pair(a: Tensor, b: Tensor, what: str) -> None:
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"the CUDA {what} needs CUDA tensors; got "
                         f"{a.device} and {b.device}")
    if a.dtype not in _SUFFIX or b.dtype != a.dtype:
        raise TypeError(f"the CUDA {what} takes float32 or float64 a and b "
                        f"of one dtype; got {a.dtype} and {b.dtype}")
    if a.ndim != 2 or b.shape != a.shape:
        raise ValueError(f"a and b must be (rows, len) of one shape; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if a.shape[0] >= 2 ** 31:
        raise ValueError(f"at most 2**31 - 1 rows; got {a.shape[0]}")


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
                      carry_b: Optional[Tensor] = None, *,
                      with_b: bool = True
                      ) -> tuple[Tensor, Optional[Tensor]]:
    """Launch the scan on (rows, len) CUDA tensors; returns (out_a, out_b).

    ``carry_a`` / ``carry_b`` are optional (rows,) seeds; a missing one is
    the identity (-inf, 0).  With ``with_b=False`` the kernel writes out_a
    only and out_b is None (the simulator's FCFS queues read out_a
    alone).  Raises on anything the kernel does not take: no conversion,
    no fallback.
    """
    global launches
    _check_pair(a, b, "scan")
    _check_carry(carry_a, a, "carry_a")
    _check_carry(carry_b, a, "carry_b")
    rows, length = a.shape
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b) if with_b else None
    if a.numel() == 0:
        return out_a, out_b
    SCAN_LIB.call(f"maxplus_scan_{_SUFFIX[a.dtype]}", a.device,
                  ptr(a), ptr(b), ptr(carry_a), ptr(carry_b), ptr(out_a),
                  ptr(out_b), rows, length)
    launches += 1
    return out_a, out_b


def maxplus_segment_scan_cuda(a: Tensor, b: Tensor, f: Tensor, *,
                              with_b: bool = True
                              ) -> tuple[Tensor, Optional[Tensor]]:
    """Launch the segmented scan; returns (out_a, out_b).

    ``a`` and ``b`` are (rows, len); ``f`` is (flag_rows, len) ``uint8``
    reset flags with ``rows`` a multiple of ``flag_rows``: row ``i`` reads
    flag row ``i // (rows // flag_rows)``.  With ``with_b=False`` the
    kernel writes out_a only and out_b is None (the simulator reads
    out_a alone).  Raises on anything the kernel does not take.
    """
    global segment_launches
    _check_pair(a, b, "segmented scan")
    if (f.device != a.device or f.dtype != torch.uint8 or f.ndim != 2
            or f.shape[1] != a.shape[1] or not f.is_contiguous()):
        raise ValueError(f"f must be a contiguous uint8 (flag_rows, "
                         f"{a.shape[1]}) tensor on {a.device}; got "
                         f"{f.dtype} {tuple(f.shape)} on {f.device}")
    rows, length = a.shape
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b) if with_b else None
    if a.numel() == 0:
        return out_a, out_b
    if f.shape[0] == 0 or rows % f.shape[0]:
        raise ValueError(f"{rows} rows do not split evenly over "
                         f"{f.shape[0]} flag rows")
    SEGMENT_LIB.call(f"maxplus_segment_scan_{_SUFFIX[a.dtype]}", a.device,
                     ptr(a), ptr(b), ptr(f), ptr(out_a), ptr(out_b), rows,
                     length, rows // f.shape[0])
    segment_launches += 1
    return out_a, out_b
