"""Plain PyTorch version of GQA flash attention (the reference's oracle,
`repro.kernels.flash_attention.ref`, ported): float32 softmax over the
full score matrix."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *, n_rep: int,
                        causal: bool = True) -> Tensor:
    """q (B*H, Sq, D), k/v (B*KV, Sk, D) -> (B*H, Sq, D), fp32 softmax.

    ``n_rep`` consecutive q rows share one kv row; causal masks
    ``qpos < kpos`` with no offset.
    """
    d = q.shape[-1]
    k = k.repeat_interleave(n_rep, dim=0)
    v = v.repeat_interleave(n_rep, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * (d ** -0.5)
    if causal:
        mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)
