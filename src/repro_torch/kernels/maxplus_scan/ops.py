"""Public wrappers for the (max,+) scans: any leading shape, seeded or not,
plain or segmented.

``impl`` picks the path: ``"cuda"`` launches the hand-written kernel
(`repro_torch.kernels.maxplus_scan.kernel`), ``"torch"`` runs the plain
version (`ref`), and ``"auto"`` takes the kernel for a CUDA tensor and
the plain version for a CPU tensor.  A CUDA tensor under
``"auto"`` or ``"cuda"`` launches the kernel or raises; nothing falls
back.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.kernels._cuda import IMPLS as SCAN_IMPLS
from repro_torch.kernels._cuda import resolve_impl
from repro_torch.kernels.maxplus_scan import kernel, ref

Tensor = torch.Tensor

__all__ = ["SCAN_IMPLS", "resolve_scan_impl", "maxplus_scan",
           "maxplus_scan_seeded", "maxplus_segment_scan", "launch_count",
           "reset_launch_count", "segment_launch_count",
           "reset_segment_launch_count"]


def resolve_scan_impl(impl: str = "auto",
                      device: DeviceLike = DEFAULT_DEVICE) -> str:
    """"auto" -> "cuda" for a CUDA device, "torch" otherwise."""
    return resolve_impl(impl, device)


def launch_count() -> int:
    """Plain-scan kernel launches made by this process so far."""
    return kernel.launches


def reset_launch_count() -> None:
    kernel.launches = 0


def segment_launch_count() -> int:
    """Segmented-scan kernel launches made by this process so far."""
    return kernel.segment_launches


def reset_segment_launch_count() -> None:
    kernel.segment_launches = 0


def _rows(x: Tensor, shape: torch.Size) -> Tensor:
    """(..., n) -> contiguous (rows, n); broadcast views are materialized."""
    return x.expand(shape).reshape(math.prod(shape[:-1]), shape[-1]
                                   ).contiguous()


def _scan_cuda(a: Tensor, b: Tensor, carry_a: Optional[Tensor],
               carry_b: Optional[Tensor], with_b: bool
               ) -> tuple[Tensor, Optional[Tensor]]:
    shape = torch.broadcast_shapes(a.shape, b.shape)
    rows_shape = shape[:-1]

    def seed(c):
        if c is None:
            return None
        return c.to(a.dtype).expand(rows_shape).reshape(-1).contiguous()

    out_a, out_b = kernel.maxplus_scan_cuda(
        _rows(a, shape), _rows(b, shape), seed(carry_a), seed(carry_b),
        with_b=with_b)
    return out_a.reshape(shape), (out_b.reshape(shape) if with_b else None)


def maxplus_scan(a: Tensor, b: Tensor, *, impl: str = "auto",
                 with_b: bool = True) -> tuple[Tensor, Optional[Tensor]]:
    """Inclusive (max, +) scan along the last axis; any leading shape.

    ``with_b=False`` returns ``(out_a, None)``: the kernel then neither
    allocates nor writes out_b (the plain version computes it and drops
    it)."""
    if resolve_scan_impl(impl, a.device) == "torch":
        out_a, out_b = ref.maxplus_scan_ref(a, b)
        return out_a, (out_b if with_b else None)
    return _scan_cuda(a, b, None, None, with_b)


def maxplus_scan_seeded(
    a: Tensor,
    b: Tensor,
    carry_a: Union[Tensor, float],
    carry_b: Union[Tensor, float, None] = None,
    *,
    impl: str = "auto",
    with_b: bool = True,
) -> tuple[Tensor, Optional[Tensor]]:
    """Inclusive (max, +) scan seeded by the carry of everything earlier.

    The streaming simulator's chunk entry point: ``(carry_a, carry_b)`` is
    the composed map of all previous chunks (for FCFS chaining,
    ``carry_a`` is the last completion time and ``carry_b`` defaults to 0)
    and broadcasts against ``a.shape[:-1]``.  The result is the seed
    composed before the scan:

        out_a' = max(out_a, carry_a + out_b),   out_b' = carry_b + out_b

    The plain path post-composes exactly so; the kernel starts its
    running carry at the seed instead.  ``with_b=False`` returns
    ``(out_a, None)``, as `maxplus_scan`.
    """
    carry_a = torch.as_tensor(carry_a, dtype=a.dtype, device=a.device)
    if carry_b is not None:
        carry_b = torch.as_tensor(carry_b, dtype=a.dtype, device=a.device)
    if resolve_scan_impl(impl, a.device) == "cuda":
        return _scan_cuda(a, b, carry_a, carry_b, with_b)
    out_a, out_b = ref.maxplus_scan_ref(a, b)
    if carry_b is None:
        carry_b = torch.zeros_like(carry_a)
    out_a = torch.maximum(out_a, carry_a[..., None] + out_b)
    out_b = carry_b[..., None] + out_b
    return out_a, (out_b if with_b else None)


def _flag_rows(f: Tensor, shape: torch.Size) -> Tensor:
    """Reset flags as a contiguous (flag_rows, n) uint8 tensor.

    Where ``f`` varies only along a prefix of the leading axes (the
    simulator's (S, 1, chunk) flags against (S, p, chunk) servers), the
    broadcast trailing axes become the kernel's rows per flag row and no
    full-size flag tensor is built; any other broadcast is materialized.
    """
    lead = shape[:-1]
    fs = (1,) * (len(shape) - f.ndim) + tuple(f.shape)
    k = next((k for k in range(len(lead), -1, -1)
              if fs[:k] == tuple(lead[:k]) and all(d == 1 for d in fs[k:-1])),
             len(lead))
    if fs[-1] != shape[-1]:
        k = len(lead)
    flags = ref._cut(f).reshape(fs).expand(tuple(lead[:k]) + fs[k:-1]
                                           + (shape[-1],))
    return flags.reshape(math.prod(lead[:k]), shape[-1]).contiguous().view(
        torch.uint8)


def maxplus_segment_scan(a: Tensor, b: Tensor, f: Tensor, *,
                         impl: str = "auto", with_b: bool = True
                         ) -> tuple[Tensor, Optional[Tensor]]:
    """Segmented inclusive (max, +) scan along the last axis.

    ``f`` holds reset flags (bool, integer or float 0/1; nonzero starts a
    new segment) and broadcasts against ``a``: the scan never looks back
    across a flagged element.  Any leading shape.  ``with_b=False``
    returns ``(out_a, None)``: the kernel then neither allocates nor
    writes out_b (the plain version computes it and drops it).
    """
    if resolve_scan_impl(impl, a.device) == "torch":
        out_a, out_b = ref.maxplus_segment_scan_ref(a, b, f)
        return out_a, (out_b if with_b else None)
    shape = torch.broadcast_shapes(a.shape, b.shape, f.shape)
    out_a, out_b = kernel.maxplus_segment_scan_cuda(
        _rows(a, shape), _rows(b, shape), _flag_rows(f, shape),
        with_b=with_b)
    return out_a.reshape(shape), (out_b.reshape(shape) if with_b else None)
