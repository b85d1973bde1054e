"""Plain PyTorch versions of EmbeddingBag.

`embedding_bag_ref` is the reference's oracle
(`repro.kernels.embedding_bag.ref`), ported with its signature: per-bag
counts, the first ``counts[i]`` ids of a bag valid.  `embedding_bag_masked`
takes the mask itself, as the model op (`repro.models.recsys
.embedding_bag`) does, for any mask; it is what the wrapper runs on CPU
tensors.  Both sum in float32 and round once to the table's dtype, as the
Pallas kernel does.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def embedding_bag_ref(table: Tensor, ids: Tensor, counts: Tensor) -> Tensor:
    """table (R, D), ids (BF, M), counts (BF,) -> (BF, D) mean-pooled."""
    vecs = table[ids.long()].float()                       # (BF, M, D)
    mask = (torch.arange(ids.shape[1], device=ids.device)[None, :]
            < counts[:, None]).float()
    s = (vecs * mask[..., None]).sum(dim=1)
    return (s / counts[:, None].clamp_min(1)).to(table.dtype)


def embedding_bag_masked(table: Tensor, ids: Tensor, mask: Tensor) -> Tensor:
    """table (R, D), ids (..., M), mask (..., M) -> (..., D): the mean of
    the rows whose mask is set, zeros for a bag with none.  A masked id is
    never used as an index."""
    mask = mask.bool()
    vecs = table[torch.where(mask, ids.long(), 0)].float()  # (..., M, D)
    s = (vecs * mask[..., None].float()).sum(dim=-2)
    n = mask.sum(dim=-1, keepdim=True).clamp_min(1).float()
    return (s / n).to(table.dtype)
