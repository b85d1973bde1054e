"""Plain PyTorch fleet scan: the reference's two per-query recurrences.

Two `lax.scan`s of the reference run here as one loop over a chunk's
queries (`repro.core.faults.fault_scan`, `repro.launch.elastic
.autoscale_scan`):

* **the replica-up mask** (S, n, r): replica j is down for query i while
  the query's absolute arrival time lies in one of j's outage windows
  ``[start, end)``, or while j's two-state Markov chain is down.  Per
  query, an up replica fails when its uniform ``u >= 1 - exp(-gap /
  MTBF)`` is false, a down one is repaired when ``u < 1 - exp(-gap /
  MTTR)``; the chain's state (S, r) int32 is carried.  The windows are
  elementwise; only the chain is a recurrence;
* **the autoscaler's active count** (S, n) int32: the HPA-shaped
  controller of `repro_torch.launch.elastic.AutoscalePolicy`, whose
  five-value state (n, t_epoch, w_epoch, stab, backlog) is carried.  When
  outages are on, it sees the fraction of replicas up (the mask's count
  over r, or an explicit ``up_frac``) as lost capacity.

The arithmetic is the reference's, operation for operation and in its
order (a product of three factors is taken left to right), so that the
CUDA kernel, which repeats it, and this loop agree bit for bit.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

Tensor = torch.Tensor


def _outage_mask(gaps: Tensor, t_arr: Optional[Tensor], u: Optional[Tensor],
                 state: Optional[Tensor], windows, mtbf, mttr, r: int
                 ) -> tuple[Tensor, Optional[Tensor]]:
    n_scen, n = gaps.shape
    up = torch.ones((n_scen, n, r), dtype=torch.bool, device=gaps.device)
    replicas = torch.arange(r, device=gaps.device)
    for idx, start, end in windows:
        in_win = (t_arr >= start) & (t_arr < end)             # (S, n)
        up = up & ~(in_win[:, :, None] & (replicas == idx % r))
    if mtbf is None:
        return up, state
    p_fail = 1.0 - torch.exp(-gaps / mtbf)                      # (S, n)
    p_fix = 1.0 - torch.exp(-gaps / mttr)
    st = state
    states = []
    for i in range(n):
        st = torch.where(st > 0,
                         (u[:, i] >= p_fail[:, i, None]).to(torch.int32),
                         (u[:, i] < p_fix[:, i, None]).to(torch.int32))
        states.append(st)
    if states:
        up = up & (torch.stack(states, dim=1) > 0)
    return up, st


def _controller(policy: Any, p: int, state: tuple, gaps: Tensor,
                demand: Tensor, upf: Optional[Tensor]
                ) -> tuple[tuple, Tensor]:
    interval = float(policy.decision_interval_seconds)
    target = float(policy.target_utilization)
    up = int(policy.scale_up_step)
    down = int(policy.scale_down_step)
    stab_n = int(policy.stabilization_intervals)
    lo, hi = int(policy.min_r), int(policy.max_r)
    trigger = policy.queue_trigger_seconds
    n, te, we, st, bk = state
    if upf is not None:
        # floor: even fully-down fleets plan against >= one replica
        upf = torch.clamp_min(upf, 1.0 / hi)
    counts = []
    for i in range(gaps.shape[1]):
        gap, dem = gaps[:, i], demand[:, i]
        cap_rate = n.to(gap.dtype) * p          # server-seconds per second
        if upf is not None:
            bk = torch.clamp_min(bk - cap_rate * upf[:, i] * gap, 0.0) + dem
            te = te + gap
            we = we + dem / upf[:, i]
        else:
            bk = torch.clamp_min(bk - cap_rate * gap, 0.0) + dem
            te = te + gap
            we = we + dem
        decide = te >= interval
        # HPA: desired = ceil(n * util / target), the n cancelling into
        # the offered load; clipped at max_r before the integer cast (the
        # clip below would take it there: ceil(min(x, hi)) = min(ceil(x),
        # hi)), so that no cast overflows
        desired = torch.ceil(torch.clamp_max(
            we / torch.clamp_min(p * te * target, 1e-30), hi)
        ).to(torch.int32)
        if trigger is not None:
            hot = bk > cap_rate * float(trigger)
            desired = torch.where(hot, torch.maximum(desired, n + up),
                                  desired)
        desired = torch.clamp(desired, lo, hi)
        want_up = desired > n
        want_dn = desired < n
        n_up = torch.minimum(n + up, desired)
        st_next = torch.where(want_dn, st + 1, 0)
        fire_dn = want_dn & (st_next >= stab_n)
        n_next = torch.where(want_up, n_up,
                             torch.where(fire_dn,
                                         torch.maximum(n - down, desired),
                                         n))
        st_next = torch.where(fire_dn, 0, st_next)
        n = torch.where(decide, n_next, n)
        st = torch.where(decide, st_next, st)
        te = torch.where(decide, 0.0, te)
        we = torch.where(decide, 0.0, we)
        counts.append(n)
    if not counts:
        return (n, te, we, st, bk), torch.empty(
            gaps.shape, dtype=torch.int32, device=gaps.device)
    return (n, te, we, st, bk), torch.stack(counts, dim=1)


def fleet_scan_ref(gaps: Tensor, *, n_valid: Optional[int] = None,
                   t_arr: Optional[Tensor] = None, u: Optional[Tensor] = None,
                   demand: Optional[Tensor] = None,
                   up_frac: Optional[Tensor] = None,
                   up_state: Optional[Tensor] = None,
                   as_state: Optional[tuple] = None, windows: tuple = (),
                   mtbf: Optional[float] = None, mttr: float = 60.0,
                   policy: Any = None, p: int = 1, r: int = 1):
    """(up (S, n, r) bool or None, n_act (S, n) int32 or None, the chain's
    state (S, r) int32, the controller's state).

    gaps: (S, n) interarrival seconds.  The outage mask is computed when
    ``windows`` (``(replica, start, end)`` triples) or ``mtbf`` are given,
    from ``t_arr`` (S, n) absolute arrival times and, for the chain, ``u``
    (S, n, r) uniforms.  The active count is computed when ``policy`` is
    given, from ``demand`` (S, n) server-seconds a query; queries from
    ``n_valid`` on (a stream's padded tail) count as zero gap and zero
    demand for the controller.  Its capacity-loss input is ``up_frac``
    (S, n) if given, else the mask's up count over r when there is a
    mask, else none.
    """
    outage = bool(windows) or mtbf is not None
    up = None
    if outage:
        up, up_state = _outage_mask(gaps, t_arr, u, up_state, windows, mtbf,
                                    mttr, r)
    n_act = None
    if policy is not None:
        gv, dv = gaps, demand
        if n_valid is not None and n_valid < gaps.shape[1]:
            valid = torch.arange(gaps.shape[1], device=gaps.device) < n_valid
            gv = torch.where(valid, gaps, 0.0)
            dv = torch.where(valid, demand, 0.0)
        if up_frac is None and outage:
            up_frac = up.to(gaps.dtype).sum(dim=-1) / r
        as_state, n_act = _controller(policy, p, as_state, gv, dv, up_frac)
    return up, n_act, up_state, as_state
