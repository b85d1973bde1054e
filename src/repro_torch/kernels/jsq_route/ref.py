"""Plain PyTorch join-shortest-queue routing: the reference's step loop.

The fluid backlog tracker ``w`` (S, r, p) holds each replica server's
remaining seconds of work at the previous arrival.  Per query: drain
every tracker by the interarrival gap, pick the replica whose slowest
server frees first (first index on ties, as ``argmin`` does), and add the
query's per-server service times, scaled by ``live`` (0 for a result-cache
hit, which never reaches a replica's servers), to the chosen replica.
One step per query, in order: the CPU path and the card's
``impl="torch"`` path run it.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def jsq_route_ref(w: Tensor, gaps: Tensor, services: Tensor, live: Tensor
                  ) -> tuple[Tensor, Tensor]:
    """(choice (S, n) int64, new tracker (S, r, p)).

    w: (S, r, p); gaps, live: (S, n); services: (S, p, n).
    """
    r = w.shape[1]
    replicas = torch.arange(r, device=w.device)
    choices = []
    for i in range(gaps.shape[-1]):
        w = torch.clamp_min(w - gaps[:, i, None, None], 0.0)
        choice = torch.argmin(torch.amax(w, dim=-1), dim=-1)
        oh = (choice[:, None] == replicas[None, :]).to(w.dtype)
        w = w + (oh * live[:, i, None])[:, :, None] * services[:, None, :, i]
        choices.append(choice)
    if not choices:
        return torch.empty(gaps.shape, dtype=torch.int64,
                           device=w.device), w
    return torch.stack(choices, dim=-1), w
