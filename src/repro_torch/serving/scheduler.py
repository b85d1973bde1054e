"""Request scheduling with queueing-model-driven straggler mitigation.

A port of `repro.serving.scheduler` (pure Python; identical decisions).
A continuous-batching scheduler: requests queue FCFS, steps retire up to
``max_batch`` requests, and hedged duplicates fire when a request's wait
exceeds the model-derived threshold t* = R ln p (`launch.elastic`) — the
paper's H_p mathematics turned into a serving policy.  It advances on an
injected clock so tests and simulations can drive it deterministically.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, List, Optional

from repro_torch.launch.elastic import hedge_threshold

__all__ = ["Request", "StepStats", "ContinuousBatcher"]


@dataclasses.dataclass
class Request:
    req_id: int
    arrival: float
    payload: object = None
    start: Optional[float] = None
    finish: Optional[float] = None
    hedged: bool = False

    @property
    def latency(self) -> Optional[float]:
        return None if self.finish is None else self.finish - self.arrival


@dataclasses.dataclass
class StepStats:
    t: float
    batch: int
    queued: int
    hedges_fired: int


class ContinuousBatcher:
    """FCFS queue + batched steps + hedging.

    step_time_fn(batch_size) -> seconds models the serving cell (from the
    roofline planner or measured); p_shards sizes the hedge threshold.
    """

    def __init__(self, *, max_batch: int, step_time_fn: Callable[[int], float],
                 p_shards: int = 1, hedge: bool = True):
        self.max_batch = max_batch
        self.step_time_fn = step_time_fn
        self.queue: deque[Request] = deque()
        self.done: List[Request] = []
        self.stats: List[StepStats] = []
        self.hedge = hedge
        self._mean_service = step_time_fn(max_batch) / max(max_batch, 1)
        self.hedge_threshold = hedge_threshold(self._mean_service, p_shards)
        self.hedges_fired = 0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def run_until(self, t_end: float, now: float = 0.0) -> float:
        """Serve queued requests until t_end; returns the clock.

        Batches only form strictly before ``t_end`` and only over requests
        that have already arrived; idle-skipping to a next arrival at or
        beyond ``t_end`` clamps the clock to ``t_end`` instead of jumping
        past the horizon.  The returned clock exceeds ``t_end`` only when
        the last batch — which started before the horizon — finishes after
        it, so chained calls (``now=previous return``) never double-book
        the server.
        """
        t = now
        while self.queue and t < t_end:
            batch: List[Request] = []
            while self.queue and len(batch) < self.max_batch:
                r = self.queue[0]
                if r.arrival > t:
                    break
                batch.append(self.queue.popleft())
            if not batch:
                nxt = self.queue[0].arrival
                if nxt >= t_end:
                    t = t_end  # next arrival beyond the horizon: stay idle
                    break
                t = nxt
                continue
            hedges = 0
            if self.hedge:
                for r in batch:
                    if t - r.arrival > self.hedge_threshold and not r.hedged:
                        r.hedged = True   # duplicate dispatched to a replica
                        hedges += 1
            self.hedges_fired += hedges
            dt = self.step_time_fn(len(batch))
            # a hedged request completes at the min of two iid services —
            # expected service halves (Exp residual memorylessness)
            for r in batch:
                r.start = t
                r.finish = t + (dt * 0.5 if r.hedged else dt)
                self.done.append(r)
            self.stats.append(StepStats(t=t, batch=len(batch),
                                        queued=len(self.queue),
                                        hedges_fired=hedges))
            t += dt
        return t

    def latencies(self) -> List[float]:
        return [r.latency for r in self.done if r.latency is not None]
