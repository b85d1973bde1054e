"""Fault injection: the one description of everything that can break.

PyTorch port of `repro.core.faults`.  The paper's queueing model assumes
every broker, index server and replica is permanently up.  Production
verticals are sized for the opposite question — *one replica down at
global peak, do the survivors hold the SLO?* — and answer it with
degraded operation: failover routing, partial-quorum (k-of-p) result
merging, hedged retries.  :class:`FaultSpec` is the frozen, hashable
description of those failure modes, carried on
:class:`repro_torch.core.cluster.ClusterSpec` as ``fault=``:

    spec = ClusterSpec(r=3, fault=FaultSpec(outages=((0, 120.0, 300.0),)))
    res = simulate_fork_join(seed, lam, n, params, cluster=spec)
    res.availability, res.spill_fraction

Four orthogonal failure channels:

* **Replica outages** — deterministic windows (``outages``: tuples of
  ``(replica, start_s, end_s)`` in simulated time) and/or a stochastic
  per-replica two-state Markov process (``mtbf_seconds`` /
  ``mttr_seconds``: per query step of length dt an up replica fails
  w.p. 1 - exp(-dt/MTBF), a down one repairs w.p. 1 - exp(-dt/MTTR)).
  Down replicas receive no new queries: oblivious policies spill to the
  next surviving replica, JSQ masks them out of the argmin, and in-flight
  work keeps draining (the semantics of an autoscaler's scale-in).
* **Degraded servers** — ``degraded``: tuples of ``(server, factor)``
  multiplying that server column's service times on every replica.
* **Partial-quorum merge** — ``broker_timeout_seconds`` with
  ``quorum_k``: past the timeout the broker returns as soon as at least
  k answers are in; such responses are *degraded* and counted in
  ``SimResult.degraded_fraction``.
* **Hedged retries** — ``hedge_after_seconds`` fires a duplicate
  fork-join to spare capacity once the join has straggled that long past
  the broker fork; ``hedge_attempts`` duplicates back off geometrically
  by ``hedge_backoff``.

The outage mask's recurrence (:func:`fault_scan`) is strictly per-query
with the carry threaded through, so it is chunking-invariant.  On the
card it runs in the hand-written fleet scan
(`repro_torch.kernels.fleet_scan`), together with the autoscaler when
one is on; the plain loop runs on the CPU.  All stochastic draws come
from a dedicated salted stream, so ``fault=None`` leaves a run's random
numbers untouched, and an all-up spec reproduces its statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.kernels.fleet_scan import ops as fleet_ops

Tensor = torch.Tensor

__all__ = ["FaultSpec", "fault_init", "fault_scan"]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Static description of injected faults and degradation policy.

    outages:      ``((replica, start_s, end_s), ...)`` deterministic
                  outage windows in simulated time; the replica index is
                  taken modulo the provisioned count.
    mtbf_seconds: mean time between failures of the stochastic
                  per-replica outage process (None disables it).
    mttr_seconds: mean time to repair for the stochastic process.
    degraded:     ``((server, factor), ...)`` — multiply server column
                  ``server``'s service times by ``factor`` on every
                  replica.
    broker_timeout_seconds: broker patience past the fork; None means
                  full quorum always.
    quorum_k:     answers required before the timeout may cut the join
                  short (defaults to 1 when a timeout is set).
    hedge_after_seconds: straggle time after the broker fork before a
                  hedged duplicate fork fires (None disables hedging).
    hedge_backoff: geometric delay factor between successive duplicates.
    hedge_attempts: number of duplicates the broker may fire.

    Instances are frozen and hashable (tuple fields are coerced).
    """

    outages: tuple = ()
    mtbf_seconds: Optional[float] = None
    mttr_seconds: float = 60.0
    degraded: tuple = ()
    broker_timeout_seconds: Optional[float] = None
    quorum_k: Optional[int] = None
    hedge_after_seconds: Optional[float] = None
    hedge_backoff: float = 2.0
    hedge_attempts: int = 1

    def __post_init__(self):
        object.__setattr__(self, "outages", tuple(
            (int(i), float(s), float(e)) for i, s, e in self.outages))
        object.__setattr__(self, "degraded", tuple(
            (int(i), float(f)) for i, f in self.degraded))
        for i, s, e in self.outages:
            if i < 0:
                raise ValueError(f"outage replica index {i} < 0")
            if not e > s:
                raise ValueError(
                    f"outage window ({s}, {e}) must have end > start")
        for i, f in self.degraded:
            if i < 0:
                raise ValueError(f"degraded server index {i} < 0")
            if not f > 0.0:
                raise ValueError(f"slowdown factor must be > 0; got {f}")
        if self.mtbf_seconds is not None and not self.mtbf_seconds > 0.0:
            raise ValueError("mtbf_seconds must be > 0 or None")
        if not float(self.mttr_seconds) > 0.0:
            raise ValueError("mttr_seconds must be > 0")
        if (self.broker_timeout_seconds is not None
                and not self.broker_timeout_seconds > 0.0):
            raise ValueError("broker_timeout_seconds must be > 0 or None")
        if self.quorum_k is not None and int(self.quorum_k) < 1:
            raise ValueError(f"quorum_k must be >= 1; got {self.quorum_k}")
        if (self.hedge_after_seconds is not None
                and not self.hedge_after_seconds > 0.0):
            raise ValueError("hedge_after_seconds must be > 0 or None")
        if not float(self.hedge_backoff) >= 1.0:
            raise ValueError("hedge_backoff must be >= 1")
        if int(self.hedge_attempts) < 1:
            raise ValueError("hedge_attempts must be >= 1")

    @property
    def has_outages(self) -> bool:
        """True when any replica can ever be down."""
        return bool(self.outages) or self.mtbf_seconds is not None

    @property
    def wants_rng(self) -> bool:
        """True when the spec consumes random draws (salted stream)."""
        return (self.mtbf_seconds is not None
                or self.hedge_after_seconds is not None)

    def quorum(self, p: int) -> int:
        """Effective k for a p-way fork (``quorum_k`` clipped to p)."""
        k = 1 if self.quorum_k is None else int(self.quorum_k)
        return min(max(k, 1), int(p))

    def hedge_delays(self) -> tuple:
        """Fire times of the duplicate forks, relative to the fork."""
        if self.hedge_after_seconds is None:
            return ()
        base = float(self.hedge_after_seconds)
        back = float(self.hedge_backoff)
        delays, t = [], 0.0
        for j in range(int(self.hedge_attempts)):
            t += base * back ** j
            delays.append(t)
        return tuple(delays)


def fault_init(spec: FaultSpec, n_scen: int, r: int, *,
               device: DeviceLike = DEFAULT_DEVICE) -> tuple:
    """Initial outage carry: per-replica up state, all up at t=0."""
    return (torch.ones((n_scen, r), dtype=torch.int32,
                       device=torch.device(device)),)


def fault_scan(spec: FaultSpec, r: int, carry: tuple, t_arr: Tensor,
               gaps: Tensor, u: Optional[Tensor] = None, *,
               impl: str = "auto") -> tuple[tuple, Tensor]:
    """Per-query replica-up mask over one block of queries.

    t_arr: (S, n) absolute arrival times (for the deterministic outage
    windows); gaps: (S, n) interarrival seconds (hazard exposure of the
    stochastic process); u: (S, n, r) uniforms from the salted fault
    stream, required iff ``spec.mtbf_seconds`` is set.  The stochastic
    recurrence is strictly per-query with the carry threaded through, so
    splitting a stream into blocks and chaining the carry yields the SAME
    masks as one call.  ``impl``: "auto" (the CUDA fleet scan for CUDA
    tensors, the plain loop for CPU tensors), "cuda" or "torch".

    Returns ``(new_carry, up (S, n, r) bool)`` — ``up[s, i, j]`` is
    whether replica j can accept query i in scenario s.
    """
    if not spec.has_outages:
        return carry, torch.ones(t_arr.shape + (r,), dtype=torch.bool,
                                 device=t_arr.device)
    if spec.mtbf_seconds is not None and u is None:
        raise ValueError("fault_scan needs uniforms u when mtbf_seconds "
                         "is set")
    up, _, state, _ = fleet_ops.fleet_scan(
        gaps, t_arr=t_arr, u=u, up_state=carry[0], fault=spec, r=r,
        impl=impl)
    return (state,), up
