"""Plain PyTorch versions of the (max,+) scan.

The FCFS recurrence C_i = max(a_i, C_{i-1} + b_i) composes associatively
over (a, b) pairs:

    (a1, b1) then (a2, b2)  =  (max(a2, a1 + b2), b1 + b2)

with identity (-inf, 0).  `maxplus_scan_ref` is the log-depth
Hillis-Steele scan (what the CPU path and the card's ``impl="torch"``
path run); `maxplus_scan_sequential` is the definitional O(n) loop, the
oracle both are tested against.

The segmented variants lift the combine to (a, b, f) elements, f = "this
element starts a new segment": where the later operand holds a reset,
the earlier map is discarded, and the flag lane combines by max.  The
fused replicated engine scans every replica's queue in one pass this way.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def maxplus_combine(x, y):
    """Compose affine max-plus maps; ``y`` is the *later* one."""
    a1, b1 = x
    a2, b2 = y
    return torch.maximum(a2, a1 + b2), b1 + b2


def _shift_right(x: Tensor, k: int, fill: float) -> Tensor:
    """x[..., i] <- x[..., i-k], filling the first k entries."""
    return F.pad(x[..., :-k], (k, 0), value=fill)


def maxplus_scan_ref(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """Inclusive (max,+) scan along the last axis, log2(n) doubling steps."""
    n = a.shape[-1]
    k = 1
    while k < n:
        a_prev = _shift_right(a, k, -math.inf)
        b_prev = _shift_right(b, k, 0.0)
        a, b = maxplus_combine((a_prev, b_prev), (a, b))
        k *= 2
    return a, b


def maxplus_scan_sequential(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """O(n) sequential oracle — the definitional recurrence."""
    ca = torch.full(a.shape[:-1], -math.inf, dtype=a.dtype, device=a.device)
    cb = torch.zeros(b.shape[:-1], dtype=b.dtype, device=b.device)
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b)
    for i in range(a.shape[-1]):
        ca, cb = maxplus_combine((ca, cb), (a[..., i], b[..., i]))
        out_a[..., i] = ca
        out_b[..., i] = cb
    return out_a, out_b


def _cut(f: Tensor) -> Tensor:
    """Reset flags as bool: float flags cut where > 0."""
    return f > 0 if f.is_floating_point() else f.to(torch.bool)


def maxplus_segment_combine(x, y):
    """Segmented (max, +) combine; ``y`` is the *later* element.

    Elements are (a, b, f); flags may be bool, integer or float 0/1 and
    keep their dtype (the flag lane combines by max, i.e. logical or).
    """
    a1, b1, f1 = x
    a2, b2, f2 = y
    cut = _cut(f2)
    a = torch.where(cut, a2, torch.maximum(a2, a1 + b2))
    b = torch.where(cut, b2, b1 + b2)
    f = (torch.maximum(f1, f2) if f1.dtype != torch.bool
         else torch.logical_or(f1, f2))
    return a, b, f


def maxplus_segment_scan_ref(a: Tensor, b: Tensor, f: Tensor
                             ) -> tuple[Tensor, Tensor]:
    """Segmented inclusive (max,+) scan along the last axis, log2(n) steps.

    ``f`` broadcasts against ``a``; it is reduced to bool flags first.
    """
    f = _cut(f).expand(a.shape)
    n = a.shape[-1]
    k = 1
    while k < n:
        prev = (_shift_right(a, k, -math.inf), _shift_right(b, k, 0.0),
                _shift_right(f, k, False))
        a, b, f = maxplus_segment_combine(prev, (a, b, f))
        k *= 2
    return a, b


def maxplus_segment_scan_sequential(a: Tensor, b: Tensor, f: Tensor
                                    ) -> tuple[Tensor, Tensor]:
    """O(n) sequential segmented oracle — the definitional recurrence."""
    f = _cut(f).expand(a.shape)
    carry = (torch.full(a.shape[:-1], -math.inf, dtype=a.dtype,
                        device=a.device),
             torch.zeros(b.shape[:-1], dtype=b.dtype, device=b.device),
             torch.zeros(f.shape[:-1], dtype=torch.bool, device=f.device))
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b)
    for i in range(a.shape[-1]):
        carry = maxplus_segment_combine(carry, (a[..., i], b[..., i],
                                                f[..., i]))
        out_a[..., i] = carry[0]
        out_b[..., i] = carry[1]
    return out_a, out_b
