"""Plain PyTorch versions of the (max,+) scan.

The FCFS recurrence C_i = max(a_i, C_{i-1} + b_i) composes associatively
over (a, b) pairs:

    (a1, b1) then (a2, b2)  =  (max(a2, a1 + b2), b1 + b2)

with identity (-inf, 0).  `maxplus_scan_ref` is the log-depth
Hillis-Steele scan (what the CPU path and the card's ``impl="torch"``
path run); `maxplus_scan_sequential` is the definitional O(n) loop, the
oracle both are tested against.
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
