"""Plain PyTorch join-shortest-queue routing: the reference's step loop.

The fluid backlog tracker ``w`` (S, r, p) holds each replica server's
remaining seconds of work at the previous arrival.  Per query: drain
every tracker by the interarrival gap, pick the replica whose slowest
server frees first (first index on ties, as ``argmin`` does), and add the
query's per-server service times, scaled by ``live`` (0 for a result-cache
hit, which never reaches a replica's servers), to the chosen replica.

Two optional masks take replicas out of the argmin while their trackers
keep draining: ``n_act`` (S, n), the autoscaler's active count (replicas
k >= n_act are inactive), and ``up`` (S, n, r), the fault injector's
replica-up mask.  With ``up`` the step also reports ``spill`` (the mask
overrode the choice the active replicas alone would give) and
``unavail`` (no active replica was up; the query then takes that
fault-free choice).  One step per query, in order: the CPU path and the
card's ``impl="torch"`` path run it.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def jsq_route_ref(w: Tensor, gaps: Tensor, services: Tensor, live: Tensor,
                  n_act: Optional[Tensor] = None, up: Optional[Tensor] = None):
    """(choice (S, n) int64, new tracker (S, r, p)), plus (spill, unavail)
    (S, n) bool when ``up`` is given.

    w: (S, r, p); gaps, live: (S, n); services: (S, p, n); n_act: (S, n)
    int; up: (S, n, r) bool.
    """
    r = w.shape[1]
    replicas = torch.arange(r, device=w.device)
    choices, spills, unavails = [], [], []
    for i in range(gaps.shape[-1]):
        w = torch.clamp_min(w - gaps[:, i, None, None], 0.0)
        backlog = torch.amax(w, dim=-1)                 # (S, r)
        if n_act is not None:
            backlog = torch.where(replicas < n_act[:, i, None], backlog,
                                  torch.inf)
        choice = torch.argmin(backlog, dim=-1)
        if up is not None:
            raw = choice
            bl_up = torch.where(up[:, i], backlog, torch.inf)
            any_up = torch.isfinite(bl_up).any(dim=-1)
            choice = torch.where(any_up, torch.argmin(bl_up, dim=-1), raw)
            raw_up = torch.gather(up[:, i], 1, raw[:, None])[:, 0]
            spills.append(any_up & ~raw_up)
            unavails.append(~any_up)
        oh = (choice[:, None] == replicas[None, :]).to(w.dtype)
        w = w + (oh * live[:, i, None])[:, :, None] * services[:, None, :, i]
        choices.append(choice)
    if not choices:
        empty = torch.empty(gaps.shape, dtype=torch.int64, device=w.device)
        flags = torch.zeros(gaps.shape, dtype=torch.bool, device=w.device)
        return (empty, w) if up is None else (empty, w, flags, flags)
    choice = torch.stack(choices, dim=-1)
    if up is None:
        return choice, w
    return choice, w, torch.stack(spills, dim=-1), torch.stack(unavails,
                                                               dim=-1)
