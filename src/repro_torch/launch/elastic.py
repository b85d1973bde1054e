"""Elasticity: serving autoscaler policy + training-mesh resizing.

PyTorch port of `repro.launch.elastic`.  Two consumers share this
module's mathematics:

* **Serving**: a search cluster sized by `repro_torch.core.capacity`
  holds r replicas forever, but diurnal load needs the peak count for a
  few hours a day.  :class:`AutoscalePolicy` is the HPA-shaped feedback
  controller — min/max replicas, a target utilization trigger,
  step-limited scale up/down, a stabilization window — and
  :func:`autoscale_scan` is its per-query recurrence, carried through the
  streaming simulator's chunk loop (``ClusterSpec(autoscale=...)``) so
  that policies are simulated and swept like any other capacity knob.
  On the card the recurrence is the hand-written fleet scan
  (`repro_torch.kernels.fleet_scan`); its plain loop runs on the CPU.
  Scale-out replicas start cold (empty queues); scale-in stops routing
  new queries to a replica but lets its in-flight work drain.
* **Training** (`survivor_mesh_shape` / `ElasticPlan` / `plan_downsize`):
  on host failure the surviving chips form a smaller mesh (same axis
  names, reduced ``data``/``pod`` extent); `plan_downsize` quantifies the
  throughput/step-time trade of a candidate shrink.

Straggler mitigation ties the two together with the paper's Eq 6: a
synchronous fork-join step waits for the slowest of p participants, and
with iid exponential tails the expected straggler tax is H_p.
`hedge_threshold` converts that into when to fire a hedged duplicate;
:meth:`AutoscalePolicy.for_slo` converts it into the autoscaler's
utilization trigger.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.core import queueing
from repro_torch.kernels.fleet_scan import ops as fleet_ops

Tensor = torch.Tensor

__all__ = ["AutoscalePolicy", "autoscale_init", "autoscale_scan",
           "survivor_mesh_shape", "expected_straggler_tax",
           "hedge_threshold", "ElasticPlan", "plan_downsize"]


def expected_straggler_tax(p: int) -> float:
    """E[slowest of p] / E[one], for iid exponential step times.

    This is the paper's Eq 6 synchronization factor H_p — the mean
    slowdown a synchronous fork-join step pays for waiting on p
    participants.  A host-side number (computed on the CPU).
    """
    return float(queueing.harmonic_number(max(int(p), 1), device="cpu"))


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """HPA-shaped feedback controller for the replica count.

    The controller observes the fleet once per ``decision_interval`` of
    *simulated* time: utilization is the server-seconds of work that
    arrived during the interval over the server-seconds of capacity
    (``n_active * p * interval``), and the desired count is the
    horizontal-pod-autoscaler rule

        desired = ceil(n_active * utilization / target_utilization)

    clipped to ``[min_r, max_r]``.  Scale-up applies immediately, at most
    ``scale_up_step`` replicas per decision; scale-down waits for
    ``stabilization_intervals`` *consecutive* low decisions before
    removing at most ``scale_down_step``.  ``queue_trigger_seconds``
    optionally adds a backlog override: if the fluid backlog would take
    longer than this to drain at current capacity, a scale-up step fires
    regardless of utilization.

    Replicas above the active count receive no new queries but keep
    draining in-flight work; scale-out replicas start cold.  The policy
    is frozen and hashable.
    """

    min_r: int
    max_r: int
    target_utilization: float = 0.7
    scale_up_step: int = 1
    scale_down_step: int = 1
    decision_interval_seconds: float = 15.0
    stabilization_intervals: int = 4
    queue_trigger_seconds: Optional[float] = None
    init_r: Optional[int] = None

    def __post_init__(self):
        if not 1 <= int(self.min_r) <= int(self.max_r):
            raise ValueError(
                f"need 1 <= min_r <= max_r; got ({self.min_r}, "
                f"{self.max_r})")
        if not 0.0 < float(self.target_utilization) < 1.0:
            raise ValueError("target_utilization must be in (0, 1); got "
                             f"{self.target_utilization}")
        if int(self.scale_up_step) < 1 or int(self.scale_down_step) < 1:
            raise ValueError("scale steps must be >= 1")
        if not float(self.decision_interval_seconds) > 0.0:
            raise ValueError("decision_interval_seconds must be > 0")
        if int(self.stabilization_intervals) < 1:
            raise ValueError("stabilization_intervals must be >= 1")
        if (self.queue_trigger_seconds is not None
                and not float(self.queue_trigger_seconds) > 0.0):
            raise ValueError("queue_trigger_seconds must be > 0 or None")
        if (self.init_r is not None
                and not self.min_r <= int(self.init_r) <= self.max_r):
            raise ValueError(
                f"init_r={self.init_r} outside [{self.min_r}, "
                f"{self.max_r}]")

    @property
    def start_r(self) -> int:
        """Replica count at t=0 (``init_r``, defaulting to ``min_r``)."""
        return int(self.min_r if self.init_r is None else self.init_r)

    @classmethod
    def for_slo(cls, min_r: int, max_r: int, *, p: int,
                mean_service: float, slo_seconds: float,
                **kwargs) -> "AutoscalePolicy":
        """Derive the utilization trigger from the SLO and Eq 6.

        A fork-join replica's response is roughly H_p * S / (1 - rho), so
        keeping R <= SLO needs rho <= 1 - H_p * S / SLO; this constructor
        wires :func:`expected_straggler_tax` into the trigger (clipped to
        [0.05, 0.95]).
        """
        tax = expected_straggler_tax(p)
        target = 1.0 - tax * float(mean_service) / float(slo_seconds)
        target = min(max(target, 0.05), 0.95)
        return cls(min_r=min_r, max_r=max_r,
                   target_utilization=target, **kwargs)


def autoscale_init(policy: AutoscalePolicy, n_scen: int,
                   dtype: torch.dtype, *,
                   device: DeviceLike = DEFAULT_DEVICE) -> tuple:
    """Initial controller carry: (n_active, t_epoch, w_epoch, stab, bklg).

    ``n_active`` (int32) is the live replica count, ``t_epoch`` /
    ``w_epoch`` accumulate seconds and server-seconds of demand since the
    last decision, ``stab`` (int32) counts consecutive scale-down votes,
    ``bklg`` is the fluid backlog behind the queue trigger.
    """
    dev = torch.device(device)
    zeros = torch.zeros((n_scen,), dtype=dtype, device=dev)
    return (torch.full((n_scen,), policy.start_r, dtype=torch.int32,
                       device=dev),
            zeros, zeros.clone(),
            torch.zeros((n_scen,), dtype=torch.int32, device=dev),
            zeros.clone())


def autoscale_scan(policy: AutoscalePolicy, p: int, carry: tuple,
                   gaps: Tensor, demand: Tensor,
                   up_frac: Optional[Tensor] = None, *,
                   impl: str = "auto") -> tuple[tuple, Tensor]:
    """Run the controller over one block of queries; returns per-query n.

    gaps: (S, n) interarrival seconds; demand: (S, n) server-seconds of
    work each query brings.  The recurrence is strictly per-query with
    the carry threaded through, so splitting a stream into blocks and
    chaining the carry gives the SAME per-query active counts as one
    call.  Zero-gap, zero-demand entries advance nothing.

    up_frac (optional, (S, n)): fraction of provisioned replicas that are
    up.  The controller then sees an outage as lost capacity — demand is
    inflated by 1/up_frac and the fluid backlog drains at the surviving
    rate.  ``None`` takes the all-up path.

    Returns ``(new_carry, n_active (S, n) int32)``, ``n_active[i]`` the
    count in force when query i is routed.  ``impl``: "auto" (the CUDA
    fleet scan for CUDA tensors, the plain loop for CPU tensors), "cuda"
    or "torch".
    """
    _, n_act, _, carry = fleet_ops.fleet_scan(
        gaps, demand=demand, up_frac=up_frac, as_state=tuple(carry),
        policy=policy, p=p, impl=impl)
    return carry, n_act


def survivor_mesh_shape(original: Sequence[int], failed_hosts: int,
                        chips_per_host: int, axes: Sequence[str]
                        ) -> tuple[int, ...]:
    """Shrink the data-most axis to exclude failed hosts' chips.

    Keeps the ``model`` extent intact (TP degree is a property of the
    model's sharding) and shrinks ``data`` (then ``pod``): DP width is the
    elastic dimension.
    """
    shape = list(original)
    lost = failed_hosts * chips_per_host
    order = [axes.index(a) for a in ("data", "pod") if a in axes]
    for ax in order:
        while lost > 0 and shape[ax] > 1:
            total_other = int(np.prod(shape)) // shape[ax]
            shape[ax] -= 1
            lost -= total_other
    if lost > 0:
        raise ValueError("not enough surviving capacity for model shards")
    return tuple(shape)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Throughput/step-time consequences of resizing a training mesh:
    ``throughput_fraction`` of the old mesh's examples/s and the matching
    ``step_time_factor`` slowdown at fixed global batch."""

    old_shape: tuple
    new_shape: tuple
    throughput_fraction: float
    step_time_factor: float


def plan_downsize(old_shape: Sequence[int], new_shape: Sequence[int]
                  ) -> ElasticPlan:
    """Quantify a mesh shrink (chips removed -> linear throughput loss).

    Assumes compute-bound steps: a mesh with new_n of old_n chips runs at
    new_n / old_n the throughput and old_n / new_n the step time.
    """
    old_n = int(np.prod(old_shape))
    new_n = int(np.prod(new_shape))
    return ElasticPlan(
        old_shape=tuple(old_shape), new_shape=tuple(new_shape),
        throughput_fraction=new_n / old_n,
        step_time_factor=old_n / new_n,
    )


def hedge_threshold(mean_service: float, p: int, *,
                    duplicate_cost_fraction: float = 1.0) -> float:
    """Wait time after which a hedged duplicate is worth sending.

    For exponential residence with mean R, the slowest of p has expected
    value H_p R; the marginal straggler (the gap between the (p-1)-th and
    p-th order statistic) costs R/1 on average.  Hedging pays when the
    observed wait exceeds the (1 - 1/p) quantile:
        t* = R * ln(p)        (quantile of Exp at 1 - 1/p)
    scaled by the relative cost of a duplicate.
    """
    return float(mean_service * np.log(max(p, 2))
                 * duplicate_cost_fraction)
