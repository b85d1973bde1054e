"""Plain reference of the replicated fork-join network under faults.

The network of `forkjoin` (join-shortest-queue over r replicas, each
with the Eq 8 result cache, a broker and p index servers) with a
configuration's ``fault``, after the semantics the port's fault injector
documents for its four channels (hedges aside, which no configuration
here asks for):

* **Which replicas are up.**  Replica j (taken modulo r) is down for a
  query whose arrival, on the absolute clock from the dispatch's start,
  lies in one of j's outage windows ``[start, end)``, or while j's
  two-state chain is down.  The chains start all up; per query, with
  the gap dt since the previous arrival and that query's fault uniform
  u of each replica, an up replica fails where u < 1 - exp(-dt / MTBF)
  and a down one is repaired where u < 1 - exp(-dt / MTTR).
* **Routing around them.**  Every replica's backlog tracker drains by
  the gap; the query goes to the up replica whose slowest server frees
  first (the lowest index on a tie).  Where the fault-free choice (the
  same over all replicas) is down, the query is a *spill*; where no
  replica is up, it is *unavailable* and takes the fault-free choice.
* **Slowed servers.**  Server s's (modulo p) services are multiplied by
  its factor on every replica, before the tracker or a queue reads them.
* **The k-of-p merge.**  The fork is the broker's completion.  The join
  is the slowest server's completion where that lands by fork + timeout;
  otherwise it is the later of the k-th earliest completion and fork +
  timeout, and the answer is *degraded* (k is ``quorum_k`` clipped to
  [1, p]; at k = p the broker waits for all and nothing is degraded).
  Servers finish their work either way.  A cache hit never forks and is
  never degraded.

`forkjoin.simulate` runs these channels where it is given a ``fault``;
the three counts are over the post-warm-up queries, as the mean and the
histogram are.  The arithmetic runs in ``dtype`` but for what decides a
discrete outcome: the JSQ tracker, the chains and the outage windows'
clock run in ``route_dtype``, the configuration's float32, as the
fault-free tracker does and for the same reason (a choice, a state or a
window is a discontinuous function of its inputs).  The windows' clock
is the running sum of each chunk's arrivals from the clock at the
chunk's start.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

# the counts a faulted run adds, in the order of its flags
COUNTS = ("degraded_count", "spill_count", "unavail_count")


def slowed(svc: Tensor, fault: dict) -> Tensor:
    """(S, p, n) services with each slowed server's column multiplied by
    its factor."""
    p = svc.shape[1]
    factors = [1.0] * p
    for server, factor in fault["degraded"]:
        factors[int(server) % p] *= float(factor)
    return svc * torch.tensor(factors, dtype=svc.dtype,
                              device=svc.device)[None, :, None]


def window_up(fault: dict, r: int, t_abs: Tensor) -> Tensor:
    """(S, n, r) bool: no outage window of the replica holds the arrival
    times ``t_abs`` (S, n)."""
    up = torch.ones(t_abs.shape + (r,), dtype=torch.bool,
                    device=t_abs.device)
    for replica, start, end in fault["outages"]:
        inside = (t_abs >= float(start)) & (t_abs < float(end))
        up[..., int(replica) % r] &= ~inside
    return up


def jsq_faulted(w: Tensor, chain: Tensor, gaps: Tensor, services_: Tensor,
                live: Tensor, win_up: Tensor, u: Tensor, *, mtbf: float,
                mttr: float) -> tuple:
    """Join-shortest-queue over the up replicas, one query at a time.

    ``w`` (S, r, p) is each replica server's remaining work at the
    previous arrival and ``chain`` (S, r) bool each replica's chain state;
    ``gaps``, ``live`` (S, n), ``services_`` (S, p, n), ``win_up`` and
    ``u`` (S, n, r).  Returns ((S, n) choices, the tracker, the chains,
    (S, n) spill and unavailable flags).
    """
    n_scen, r, p = w.shape
    w = w.clone()
    dep = (services_ * live[:, None, :]).permute(2, 0, 1).contiguous()
    p_fail = (1.0 - torch.exp(-gaps / mtbf)).t().contiguous()
    p_fix = (1.0 - torch.exp(-gaps / mttr)).t().contiguous()
    gaps_t = gaps.t().contiguous()
    u_t = u.permute(1, 0, 2).contiguous()
    win_t = win_up.permute(1, 0, 2).contiguous()
    n = gaps.shape[-1]
    choices = torch.empty((n_scen, n), dtype=torch.int64, device=w.device)
    spill = torch.empty((n_scen, n), dtype=torch.bool, device=w.device)
    unavail = torch.empty_like(spill)
    for i in range(n):
        chain = torch.where(chain, u_t[i] >= p_fail[i][:, None],
                            u_t[i] < p_fix[i][:, None])
        up = chain & win_t[i]
        w.sub_(gaps_t[i][:, None, None]).clamp_(min=0.0)
        backlog = torch.amax(w, dim=-1)
        raw = torch.argmin(backlog, dim=-1)
        any_up = up.any(dim=-1)
        best_up = torch.argmin(torch.where(up, backlog, math.inf), dim=-1)
        choice = torch.where(any_up, best_up, raw)
        spill[:, i] = any_up & ~torch.gather(up, 1, raw[:, None])[:, 0]
        unavail[:, i] = ~any_up
        w.scatter_add_(1, choice.view(n_scen, 1, 1).expand(n_scen, 1, p),
                       dep[i][:, None, :])
        choices[:, i] = choice
    return choices, w, chain, spill, unavail


def quorum_join(done: Tensor, fork: Tensor, *, k: int, timeout: float
                ) -> tuple[Tensor, Tensor]:
    """(join, degraded) of per-server completions ``done`` (S, p, n)
    forked at ``fork`` (S, n): the full join by fork + timeout, else the
    later of the k-th earliest completion and fork + timeout."""
    p = done.shape[1]
    k = min(max(k, 1), p)
    full = torch.amax(done, dim=1)
    deadline = fork + timeout
    if k >= p:
        return full, torch.zeros_like(full, dtype=torch.bool)
    kth = torch.topk(done, p - k + 1, dim=1).values[:, -1]
    late = full > deadline
    return torch.where(late, torch.maximum(kth, deadline), full), late
