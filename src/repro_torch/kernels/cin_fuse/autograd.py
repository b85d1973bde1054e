"""Reverse-mode derivative of the fused CIN layer.

``y[b, o, d] = sum_{h, j} xk[b, h, d] x0[b, j, d] w[h m + j, o]`` has
three gradients:

    dw[h, j, o]  = sum_{b, d} xk[b, h, d] x0[b, j, d] g[b, o, d]
    dxk[b, h, d] = sum_{j, o} x0[b, j, d] w[h, j, o] g[b, o, d]
    dx0[b, j, d] = sum_{h, o} xk[b, h, d] w[h, j, o] g[b, o, d]

The backward is plain PyTorch, contracted one embedding coordinate d at a
time, so nothing of shape (B, Hk, m, D) is ever formed: for each d,
``wg = g_d @ w^T`` is one (B, O) x (O, Hk m) product, which gives dxk
and dx0 by two batched vector products; and ``outer_d^T @ g_d``, the
(B, Hk m) outer product of xk_d and x0_d against g_d, adds d's share of
dw.  The products run in the inputs' dtype (bfloat16 on the card at full
width: tensor cores, float32 accumulation inside each product) and the
D shares of dw add up in float32, rounded once.

`CinFunction`'s forward is whatever ``forward`` the wrapper hands it (the
CUDA kernel on the card, the plain version on the CPU).  There is no
backward kernel: the reference's Pallas kernel has no backward either.
"""

from __future__ import annotations

from typing import Callable

import torch

Tensor = torch.Tensor

__all__ = ["CinFunction", "cin_grads"]


def cin_grads(g: Tensor, xk: Tensor, x0: Tensor, w: Tensor
              ) -> tuple[Tensor, Tensor, Tensor]:
    """(dxk, dx0, dw) of the layer at output gradient g (B, O, D)."""
    b, hk, d = xk.shape
    m, o = x0.shape[1], w.shape[1]
    dt = xk.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32
    g = g.to(dt)
    wt = w.t().contiguous()                                  # (O, Hk m)
    dxk = torch.empty((d, b, hk), dtype=dt, device=xk.device)
    dx0 = torch.empty((d, b, m), dtype=dt, device=xk.device)
    dw = torch.zeros((hk * m, o), dtype=acc, device=xk.device)
    for i in range(d):
        g_d = g[:, :, i].contiguous()                        # (B, O)
        xk_d = xk[:, :, i].contiguous()                      # (B, Hk)
        x0_d = x0[:, :, i].contiguous()                      # (B, m)
        wg = (g_d @ wt).reshape(b, hk, m)                    # (B, Hk, m)
        dxk[i] = torch.bmm(wg, x0_d[:, :, None])[:, :, 0]
        dx0[i] = torch.bmm(xk_d[:, None, :], wg)[:, 0, :]
        del wg
        outer = (xk_d[:, :, None] * x0_d[:, None, :]).reshape(b, hk * m)
        dw += (outer.t() @ g_d).to(acc)
        del outer
    return (dxk.permute(1, 2, 0).contiguous(),
            dx0.permute(1, 2, 0).contiguous(), dw.to(w.dtype))


class CinFunction(torch.autograd.Function):
    """``CinFunction.apply(xk, x0, w, forward)``."""

    @staticmethod
    def forward(xk: Tensor, x0: Tensor, w: Tensor, forward: Callable
                ) -> Tensor:
        return forward(xk, x0, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        xk, x0, w, _ = inputs
        ctx.save_for_backward(xk, x0, w)

    @staticmethod
    def backward(ctx, g):
        xk, x0, w = ctx.saved_tensors
        dxk, dx0, dw = cin_grads(g, xk, x0, w)
        return (dxk if ctx.needs_input_grad[0] else None,
                dx0 if ctx.needs_input_grad[1] else None,
                dw if ctx.needs_input_grad[2] else None, None)
