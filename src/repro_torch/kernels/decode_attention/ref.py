"""Plain PyTorch version of decode attention (the reference's oracle,
`repro.kernels.decode_attention.ref`, ported): float32 softmax over the
valid cache positions."""

from __future__ import annotations

from typing import Union

import torch

Tensor = torch.Tensor


def decode_attention_ref(q: Tensor, k: Tensor, v: Tensor,
                         length: Union[int, Tensor]) -> Tensor:
    """q (B*KV, G, D), k/v (B*KV, S, D), length () -> (B*KV, G, D).

    ``length`` is the last valid cache position, inclusive.
    """
    d = q.shape[-1]
    s = torch.einsum("hgd,hsd->hgs", q.float(), k.float()) * (d ** -0.5)
    valid = torch.arange(k.shape[1], device=k.device) <= length
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("hgs,hsd->hgd", p, v.float()).to(q.dtype)
