"""Bind and launch the hand-written CUDA join-shortest-queue router.

``csrc/jsq_route.cu`` runs the reference's per-query JSQ recurrence
(`repro.core.simulator._jsq_route`, a `lax.scan`; no Pallas kernel) as one
launch per chunk.  It is built by `repro_torch.kernels._cuda.CudaLibrary`
at first use.  ``launches`` counts the launches this process made.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels._cuda import CudaLibrary, ptr

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int64

LIB = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "jsq_route.cu",
    {name: [_P] * 6 + [_I] * 4 + [_P]
     for name in ("jsq_route_f32", "jsq_route_f64")})
MAX_REPLICAS = 16                  # kMaxR in the source
_TILE_STRIDE = 33                  # kStride in the source
_MAX_SHARED = 232_448              # bytes a block may use on Hopper

__all__ = ["LIB", "MAX_REPLICAS", "jsq_route_cuda"]

launches = 0          # kernel launches in this process

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def jsq_route_cuda(w: Tensor, gaps: Tensor, services: Tensor, live: Tensor
                   ) -> tuple[Tensor, Tensor]:
    """Launch the router; returns (choice (S, n) int64, w_new (S, r, p)).

    w: (S, r, p); gaps, live: (S, n); services: (S, p, n); all contiguous
    CUDA tensors of one float dtype.  Raises on anything the kernel does
    not take: no conversion, no fallback.
    """
    global launches
    tensors = (w, gaps, services, live)
    if any(t.device.type != "cuda" or t.device != w.device for t in tensors):
        raise ValueError("the CUDA JSQ router needs CUDA tensors on one "
                         f"device; got {[str(t.device) for t in tensors]}")
    if w.dtype not in _SUFFIX or any(t.dtype != w.dtype for t in tensors):
        raise TypeError("the CUDA JSQ router takes float32 or float64 "
                        f"tensors of one dtype; got "
                        f"{[t.dtype for t in tensors]}")
    if w.ndim != 3 or gaps.ndim != 2:
        raise ValueError(f"w must be (S, r, p) and gaps (S, n); got "
                         f"{tuple(w.shape)} and {tuple(gaps.shape)}")
    n_scen, r, p = w.shape
    n = gaps.shape[1]
    if (gaps.shape != (n_scen, n) or live.shape != (n_scen, n)
            or services.shape != (n_scen, p, n)):
        raise ValueError(f"shapes disagree: w {tuple(w.shape)}, gaps "
                         f"{tuple(gaps.shape)}, services "
                         f"{tuple(services.shape)}, live "
                         f"{tuple(live.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("w, gaps, services and live must be contiguous")
    if not 1 <= r <= MAX_REPLICAS:
        raise ValueError(f"the CUDA JSQ router takes 1..{MAX_REPLICAS} "
                         f"replicas; got r={r}")
    smem = (r * p + 2 * p * _TILE_STRIDE) * w.element_size()
    if smem > _MAX_SHARED:
        raise ValueError(f"r={r}, p={p} needs {smem} B of shared memory; "
                         f"a block has {_MAX_SHARED}")
    choice = torch.empty((n_scen, n), dtype=torch.int64, device=w.device)
    w_new = torch.empty_like(w)
    if n_scen == 0 or p == 0:
        return choice.zero_(), w_new.copy_(w)
    LIB.call(f"jsq_route_{_SUFFIX[w.dtype]}", w.device, ptr(w), ptr(gaps),
             ptr(services), ptr(live), ptr(choice), ptr(w_new), n_scen, r, p,
             n)
    launches += 1
    return choice, w_new
