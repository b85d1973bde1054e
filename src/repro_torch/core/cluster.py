"""ClusterSpec: the one static description of the simulated topology.

PyTorch port of `repro.core.cluster`.  Every topology knob of the engine
entry points rides one frozen, hashable object, passed as ``cluster=``:

    spec = ClusterSpec(r=4, routing="jsq", result_cache=(0.3, 2e-3))
    res = simulate_fork_join(seed, lam, n, params, cluster=spec)

    elastic = ClusterSpec(routing="jsq",
                          autoscale=AutoscalePolicy(min_r=1, max_r=6))

``ClusterSpec()`` (all defaults) is the single-replica, cache-less
engine.  The port takes ``cluster=`` only: there are no loose ``r=`` /
``routing=`` keywords.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.faults import FaultSpec
from repro_torch.launch.elastic import AutoscalePolicy

__all__ = ["ClusterSpec", "ROUTING_POLICIES", "REPLICA_IMPLS"]

ROUTING_POLICIES = ("round_robin", "random", "jsq")
REPLICA_IMPLS = ("fused", "masked")


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Static topology of the simulated search cluster.

    r:            replica count (each replica = broker + p servers).
                  With ``autoscale`` set, leave at the default — the
                  engine provisions ``autoscale.max_r`` and the policy
                  decides how many are active.
    routing:      dispatcher policy, one of ``ROUTING_POLICIES``.
    result_cache: ``(hit_r, s_cache)`` broker-level result cache of
                  Eq 8, or None.
    replica_impl: "fused" (segment-compacted scan, default) or
                  "masked" (full-stream re-scan oracle).
    autoscale:    optional :class:`AutoscalePolicy` making the active
                  replica count time-varying.
    fault:        optional :class:`repro_torch.core.faults.FaultSpec`
                  injecting replica outages, degraded servers, a
                  partial-quorum broker timeout and hedged retries.
    """

    r: int = 1
    routing: str = "round_robin"
    result_cache: Optional[tuple[float, float]] = None
    replica_impl: str = "fused"
    autoscale: Optional[AutoscalePolicy] = None
    fault: Optional[FaultSpec] = None

    def __post_init__(self):
        object.__setattr__(self, "r", int(self.r))
        if self.result_cache is not None:
            hit_r, s_cache = self.result_cache
            object.__setattr__(self, "result_cache",
                               (float(hit_r), float(s_cache)))
        if self.r < 1:
            raise ValueError(f"need at least one replica; got r={self.r}")
        if self.routing not in ROUTING_POLICIES:
            raise ValueError(f"unknown routing policy {self.routing!r}; "
                             f"choose one of {ROUTING_POLICIES}")
        if self.replica_impl not in REPLICA_IMPLS:
            raise ValueError(
                f"unknown replica_impl {self.replica_impl!r}; choose "
                f"one of {REPLICA_IMPLS}")
        if self.autoscale is not None:
            if not isinstance(self.autoscale, AutoscalePolicy):
                raise TypeError("autoscale must be an AutoscalePolicy; "
                                f"got {type(self.autoscale).__name__}")
            if self.r != 1:
                raise ValueError(
                    "with autoscale= the engine provisions "
                    "autoscale.max_r replicas; leave r at its default "
                    f"(got r={self.r})")
        if self.fault is not None and not isinstance(self.fault, FaultSpec):
            raise TypeError("fault must be a repro_torch.core.faults."
                            f"FaultSpec; got {type(self.fault).__name__}")

    @property
    def engine_r(self) -> int:
        """Replicas the engine provisions (max_r under autoscaling)."""
        return (self.autoscale.max_r if self.autoscale is not None
                else self.r)
