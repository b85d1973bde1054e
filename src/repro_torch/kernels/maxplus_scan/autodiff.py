"""Forward-mode derivative of the out_a-only (max,+) scan.

The scan o_i = max(a_i, o_{i-1} + b_i) is piecewise linear in (a, b), so
its tangent obeys

    do_i = w_i da_i + (1 - w_i) (do_{i-1} + db_i),

w_i = 1 where a_i > o_{i-1} + b_i (the element starts a new segment: a
new busy period of an FCFS queue), 0 where a_i < o_{i-1} + b_i, and 0.5 on
a tie, as ``jnp.maximum``'s JVP splits it.  The weights come from the
primal output; the recurrence x_i = g_i x_{i-1} + h_i (g = 1 - w) is a
log-depth scan of affine maps in plain torch.  A segment start multiplies
everything before it by g = 0, so no sum cancels across segments.

`maxplus_scan_a` wraps the scan in a `torch.autograd.Function` whose
forward is `ops.maxplus_scan(..., with_b=False)` under the caller's
``impl``: the CUDA kernel on a CUDA tensor under ``"auto"``, the plain
scan on the CPU.  Under `torch.func.jvp` (or `torch.autograd.forward_ad`)
the forward still launches the kernel on the unwrapped tensors and the
rule above supplies the tangent.  There is no reverse-mode rule and no
vmap rule: callers take one `torch.func.jvp` per input direction.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.maxplus_scan import ops, ref

Tensor = torch.Tensor

__all__ = ["maxplus_scan_a", "scan_tangent"]


def scan_tangent(a: Tensor, b: Tensor, out: Tensor, a_t: Optional[Tensor],
                 b_t: Optional[Tensor]) -> Tensor:
    """Tangent of ``out = maxplus_scan(a, b)[0]`` along (a_t, b_t); a
    missing tangent is zero.  Everything broadcasts to ``out``'s shape."""
    c = ref._shift_right(out, 1, -torch.inf) + b       # o_{i-1} + b_i
    w = torch.where(a > c, 1.0, torch.where(a == c, 0.5, 0.0)).to(out.dtype)
    g = (1.0 - w).expand(out.shape)
    h = torch.zeros_like(out)
    if a_t is not None:
        h = h + w * a_t
    if b_t is not None:
        h = h + g * b_t
    n = out.shape[-1]
    k = 1
    while k < n:              # compose (g, h) maps: earlier, then later
        h = g * ref._shift_right(h, k, 0.0) + h
        g = g * ref._shift_right(g, k, 1.0)
        k *= 2
    return h


class _ScanA(torch.autograd.Function):
    @staticmethod
    def forward(a: Tensor, b: Tensor, impl: str) -> Tensor:
        out, _ = ops.maxplus_scan(a, b, impl=impl, with_b=False)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, _ = inputs
        ctx.save_for_forward(a, b, output)

    @staticmethod
    def jvp(ctx, a_t, b_t, _impl_t):
        a, b, out = ctx.saved_tensors
        return scan_tangent(a, b, out, a_t, b_t)


def maxplus_scan_a(a: Tensor, b: Tensor, *, impl: str = "auto") -> Tensor:
    """``ops.maxplus_scan(a, b, impl=impl, with_b=False)[0]``, with a
    forward-mode derivative (see the module docstring)."""
    return _ScanA.apply(a, b, impl)
