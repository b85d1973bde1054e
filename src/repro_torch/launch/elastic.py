"""Elastic-serving policies: the hedging threshold.

A port of `repro.launch.elastic.hedge_threshold`, which the scheduler
needs; the rest of the reference module (autoscaling, mesh downsizing)
is ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import numpy as np

__all__ = ["hedge_threshold"]


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
