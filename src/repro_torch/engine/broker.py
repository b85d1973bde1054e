"""Broker: broadcast, in-memory top-k merge, result cache (paper Sec 3.1).

The merge is the fork-join *join point*: partial ranked answers from all p
index servers are combined by a single top-k over the concatenated
candidates.  The broker "does not have to make ranking computations ...
other than comparing document ranks" (Sec 5.1) — the merge is exactly that
comparison, O(p*k log k) work, all in memory.  Ties take the lower
position of the concatenation first, as `scoring.local_topk` does.
"""

from __future__ import annotations

import time

import torch

from repro_torch.engine.scoring import local_topk

Tensor = torch.Tensor

__all__ = ["merge_topk", "timed_merge_topk"]


def merge_topk(
    partial_scores: Tensor,   # (p, Q, k_local)
    partial_docs: Tensor,     # (p, Q, k_local) — GLOBAL doc ids
    *,
    k: int,
) -> tuple[Tensor, Tensor]:
    """Merge p partial ranked answers into the final top-k per query."""
    p, q, kl = partial_scores.shape
    flat_s = torch.movedim(partial_scores, 0, 1).reshape(q, p * kl)
    flat_d = torch.movedim(partial_docs, 0, 1).reshape(q, p * kl)
    top_s, idx = local_topk(flat_s, k)
    top_d = torch.gather(flat_d, 1, idx.to(torch.int64))
    return top_s, top_d


def sync(x: Tensor) -> None:
    """Wait for ``x``'s device (the reference's ``block_until_ready``)."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def timed_merge_topk(
    partial_scores: Tensor,
    partial_docs: Tensor,
    *,
    k: int,
) -> tuple[tuple[Tensor, Tensor], float]:
    """Instrumented merge: ((scores, docs), wall-clock seconds).

    The calibration harness's broker probe — the measured time is the
    paper's S_broker contribution for this batch (the broker "only
    compares document ranks"; the merge IS that comparison): the host
    clock around the call and a device sync.  Callers should run one
    untimed batch first so first-call costs are excluded.
    """
    t0 = time.perf_counter()
    out = merge_topk(partial_scores, partial_docs, k=k)
    sync(out[0])
    return out, time.perf_counter() - t0
