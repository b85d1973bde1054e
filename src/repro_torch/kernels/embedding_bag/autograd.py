"""Reverse-mode derivative of the embedding bag.

``out[b] = sum_m mask[b, m] table[ids[b, m]] / max(count[b], 1)`` is
linear in the table, so its gradient is the scatter-add of
``mask / count * g`` into the rows that were read: a dense (R, D)
tensor, as ``jax.grad`` of the reference's ``jnp.take`` gives it (AdamW
decays every row).  A masked id is never read as an index and a bag with
no ids adds nothing; the ids and the mask get no gradient.

`BagFunction`'s forward is whatever ``forward`` the wrapper hands it (the
CUDA kernel on the card, the plain version on the CPU); its backward is
plain PyTorch: the sum over each row's reads is `repro_torch._segment
.segment_sum` (a stable sort by id and a log-depth segmented scan in
float32, rounded once to the table's dtype), so the gradient has the
same bits run to run on the card.  There is no backward kernel: the
reference's Pallas kernel has no backward either.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch._segment import segment_sum

Tensor = torch.Tensor

__all__ = ["BagFunction", "bag_table_grad"]


def bag_table_grad(g: Tensor, ids: Tensor, mask: Tensor, rows: int
                   ) -> Tensor:
    """d table of the masked mean: g (..., D), ids and mask (..., M) ->
    (rows, D) in g's dtype."""
    mask = mask.bool()
    acc = torch.float64 if g.dtype == torch.float64 else torch.float32
    w = mask.to(acc) / mask.sum(dim=-1, keepdim=True).clamp_min(1).to(acc)
    contrib = g.to(acc)[..., None, :] * w[..., None]         # (..., M, D)
    keys = torch.where(mask, ids.long(), rows)               # masked: dropped
    return segment_sum(contrib.reshape(-1, g.shape[-1]), keys.reshape(-1),
                       rows).to(g.dtype)


class BagFunction(torch.autograd.Function):
    """``BagFunction.apply(table, ids, mask, forward)``."""

    @staticmethod
    def forward(table: Tensor, ids: Tensor, mask: Tensor,
                forward: Callable) -> Tensor:
        return forward(table, ids, mask)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, ids, mask, _ = inputs
        ctx.save_for_backward(ids, mask)
        ctx.rows = table.shape[0]

    @staticmethod
    def backward(ctx, g):
        ids, mask = ctx.saved_tensors
        return bag_table_grad(g, ids, mask, ctx.rows), None, None, None
