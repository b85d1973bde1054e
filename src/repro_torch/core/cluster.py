"""ClusterSpec: the one static description of the simulated topology.

PyTorch port of `repro.core.cluster`.  Every topology knob of the engine
entry points rides one frozen, hashable object, passed as ``cluster=``:

    spec = ClusterSpec(r=4, routing="jsq", result_cache=(0.3, 2e-3))
    res = simulate_fork_join(seed, lam, n, params, cluster=spec)

``ClusterSpec()`` (all defaults) is the single-replica, cache-less
engine.  The port takes ``cluster=`` only: there are no loose ``r=`` /
``routing=`` keywords.  Autoscaling and fault injection are not ported
yet; a spec that asks for either raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["ClusterSpec", "ROUTING_POLICIES", "REPLICA_IMPLS"]

ROUTING_POLICIES = ("round_robin", "random", "jsq")
REPLICA_IMPLS = ("fused", "masked")


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Static topology of the simulated search cluster.

    r:            replica count (each replica = broker + p servers).
    routing:      dispatcher policy, one of ``ROUTING_POLICIES``.
    result_cache: ``(hit_r, s_cache)`` broker-level result cache of
                  Eq 8, or None.
    replica_impl: "fused" (segment-compacted scan, default) or
                  "masked" (full-stream re-scan oracle).
    autoscale:    not ported yet (ROADMAP queue 1 item 8); must be None.
    fault:        not ported yet (ROADMAP queue 1 item 9); must be None.
    """

    r: int = 1
    routing: str = "round_robin"
    result_cache: Optional[tuple[float, float]] = None
    replica_impl: str = "fused"
    autoscale: Optional[Any] = None
    fault: Optional[Any] = None

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
            raise NotImplementedError(
                "autoscale= is not ported yet (ROADMAP queue 1 item 8)")
        if self.fault is not None:
            raise NotImplementedError(
                "fault= is not ported yet (ROADMAP queue 1 item 9)")

    @property
    def engine_r(self) -> int:
        """Replicas the engine provisions."""
        return self.r
