"""Mixture-of-Experts FFN: top-k routing with capacity-bounded dispatch
(GShard / Switch lineage).

PyTorch port of `repro.models.moe`, with its semantics kept exactly:

* the router's logits are float32; padding experts (e.g. granite's 40
  -> 48) are masked to -inf, so they receive no probability mass; a
  token's top-k experts are the head of a stable descending sort (the
  lower expert first on ties, as ``jax.lax.top_k``) and their weights
  are renormalised to sum to 1;
* the routing group is one batch row, and an expert holds
  ``int(S * k * capacity_factor / E) + 1`` slots in it;
* slot positions come from the exclusive cumulative sum of the (S*k, E)
  one-hot of the choices in token-major order, which decides which
  tokens drop when an expert overflows;
* dispatch is slot-major: an (E, C) map holds the token owning each slot
  (S, a zero row, for an empty one), so filling the (E, C, d) buffer is
  one gather;
* the three expert products are plain batched matmuls over the experts,
  dense over all E experts (at decode, C = 1: every expert's weights are
  read for one slot each);
* the combine gathers each token's kept contributions through a
  token-major inverse map and adds them in ascending expert order, the
  order in which the reference's scatter-add meets them, in the model
  dtype.  No float ``index_add_``: on the card it is atomic, and its
  bits would change from run to run.

The fork-join view: dispatch fan-out and combine fan-in are the paper's
broker broadcast and merge; expert hot-spotting under skewed routing is
the disk-cache imbalance; the capacity factor trades the straggler tax
against dropped tokens.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.configs.base import MoESpec
from repro_torch.models import layers as L

Tensor = torch.Tensor

__all__ = ["MoE", "init_moe", "moe_ffn"]


def _n_experts(spec: MoESpec) -> int:
    return spec.n_experts_padded or spec.n_experts


class MoE(nn.Module):
    """The router (d, E) float32 and the experts' SwiGLU weights in the
    reference's layout: ``w_gate`` / ``w_up`` (E, d, d_expert), ``w_down``
    (E, d_expert, d), in the model dtype."""

    def __init__(self, d_model: int, spec: MoESpec, *,
                 device: DeviceLike = DEFAULT_DEVICE,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        e, f = _n_experts(spec), spec.d_expert

        def empty(shape, dt):
            return L._frozen(torch.empty(shape, device=device, dtype=dt))
        self.router = empty((d_model, e), torch.float32)
        self.w_gate = empty((e, d_model, f), dtype)
        self.w_up = empty((e, d_model, f), dtype)
        self.w_down = empty((e, f, d_model), dtype)


@torch.no_grad()
def init_moe(params: MoE, *, generator: torch.Generator) -> MoE:
    """Draw ``params`` in place as the reference does: the router normal
    x 0.02, each expert stack normal x shape[0]^-0.5 (the reference's
    ``_dense_init`` takes its fan-in from the leading axis, here E)."""
    L._dense_init_(params.router, generator, scale=0.02)
    for w in (params.w_gate, params.w_up, params.w_down):
        L._dense_init_(w, generator, scale=w.shape[0] ** -0.5)
    return params


def _capacity(s_tokens: int, spec: MoESpec) -> int:
    c = int(s_tokens * spec.top_k * spec.capacity_factor / _n_experts(spec))
    return max(c + 1, 1)


def _route(params: MoE, spec: MoESpec, x: Tensor
           ) -> tuple[Tensor, Tensor, Tensor]:
    """(probs (B, S, E), top_p (B, S, k) renormalised, top_e (B, S, k))."""
    e = _n_experts(spec)
    logits = x.float() @ params.router                       # (B, S, E)
    if e != spec.n_experts:
        pad = torch.arange(e, device=x.device) >= spec.n_experts
        logits = logits.masked_fill(pad, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :spec.top_k], top_e[..., :spec.top_k]
    top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)
    return probs, top_p, top_e


def moe_ffn(params: MoE, spec: MoESpec, x: Tensor) -> tuple[Tensor, Tensor]:
    """x (B, S, d) -> (out (B, S, d), the Switch aux loss, 0-dim float32).

    The routing group is one batch row.  A token's choice past its
    expert's capacity is dropped: it adds nothing.
    """
    b, s, d = x.shape
    e, k = _n_experts(spec), spec.top_k
    c = _capacity(s, spec)
    probs, top_p, top_e = _route(params, spec, x)

    # load-balancing auxiliary loss (Switch): E * sum_e f_e * P_e
    density = F.one_hot(top_e[..., 0], e).float().mean(dim=(0, 1))
    aux = (density * probs.mean(dim=(0, 1))).sum() * e

    ef = top_e.reshape(b, s * k)                             # token-major
    slot, keep = _slots(ef, e, c)
    # slot-major dispatch: the token owning each (expert, slot), the park
    # row S (zeros) for an empty slot; dropped choices write the extra
    # expert row E, which is cut off
    cell = torch.where(keep, ef, e) * c + slot.clamp_max(c - 1)
    tok = torch.arange(s, device=x.device).repeat_interleave(k)
    tok_map = torch.full((b, (e + 1) * c), s, dtype=torch.int64,
                         device=x.device)
    tok_map.scatter_(1, cell, tok.expand(b, -1))
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)      # row S = park
    buf = x_pad[torch.arange(b, device=x.device)[:, None],
                tok_map[:, :e * c]].view(b, e, c, d)

    h = torch.einsum("becd,edf->becf", buf, params.w_gate)
    h = F.silu(h) * torch.einsum("becd,edf->becf", buf, params.w_up)
    y = torch.einsum("becf,efd->becd", h, params.w_down)

    # combine: each token's kept contributions, in ascending expert order
    order = torch.argsort(top_e, dim=-1)                     # (B, S, k)
    src = (ef * c + slot.clamp_max(c - 1)).view(b, s, k).gather(2, order)
    keep = keep.view(b, s, k).gather(2, order)
    w = top_p.gather(2, order).to(y.dtype)
    parts = y.reshape(b, e * c, d).gather(
        1, src.view(b, s * k, 1).expand(b, s * k, d)).view(b, s, k, d)
    parts = torch.where(keep[..., None], parts * w[..., None], 0.0)
    out = parts[:, :, 0]
    for j in range(1, k):
        out = out + parts[:, :, j]
    return out, aux


def _slots(ef: Tensor, e: int, c: int) -> tuple[Tensor, Tensor]:
    """Each choice's slot in its expert (the exclusive running count of
    earlier choices of that expert in token-major order) and whether it
    fits the capacity ``c``; ``ef`` is (B, S*k)."""
    onehot = F.one_hot(ef, e).to(torch.int32)                # (B, S*k, E)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    slot = pos.gather(2, ef[..., None])[..., 0].to(torch.int64)
    return slot, slot < c

