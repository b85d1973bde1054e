"""Plain PyTorch versions of EmbeddingBag.

`embedding_bag_ref` is the reference's oracle
(`repro.kernels.embedding_bag.ref`), ported with its signature: per-bag
counts, the first ``counts[i]`` ids of a bag valid.  `embedding_bag_masked`
takes the mask itself, as the model op (`repro.models.recsys
.embedding_bag`) does, for any mask; it is what the wrapper runs on CPU
tensors, and under autograd (``impl="torch"``) its table gradient adds
up in float32 and rounds once, as the kernel's backward does.  Both sum in float32 and round once to the table's dtype, as the
Pallas kernel does.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def embedding_bag_ref(table: Tensor, ids: Tensor, counts: Tensor) -> Tensor:
    """table (R, D), ids (BF, M), counts (BF,) -> (BF, D) mean-pooled."""
    acc = _acc(table)
    vecs = table[ids.long()].to(acc)                       # (BF, M, D)
    mask = (torch.arange(ids.shape[1], device=ids.device)[None, :]
            < counts[:, None]).to(acc)
    s = (vecs * mask[..., None]).sum(dim=1)
    return (s / counts[:, None].clamp_min(1)).to(table.dtype)


def embedding_bag_masked(table: Tensor, ids: Tensor, mask: Tensor) -> Tensor:
    """table (R, D), ids (..., M), mask (..., M) -> (..., D): the mean of
    the rows whose mask is set, zeros for a bag with none.  A masked id is
    never used as an index."""
    mask = mask.bool()
    acc = _acc(table)
    rows = torch.where(mask, ids.long(), 0)
    if torch.is_grad_enabled() and table.requires_grad:
        # the gather's backward then adds into a float32 gradient, rounded
        # once to the table's dtype, as the kernel's Function does
        vecs = table.to(acc)[rows]                          # (..., M, D)
    else:
        vecs = table[rows].to(acc)
    s = (vecs * mask[..., None].to(acc)).sum(dim=-2)
    n = mask.sum(dim=-1, keepdim=True).clamp_min(1).to(acc)
    return (s / n).to(table.dtype)


def _acc(table: Tensor) -> torch.dtype:
    return torch.float64 if table.dtype == torch.float64 else torch.float32
