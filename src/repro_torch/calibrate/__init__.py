"""Trace-driven calibration: measure -> fit -> validate -> plan.

PyTorch port of `repro.calibrate`.  The paper's model is only as good as
its parameterization (Secs. 4-6: every Table 5/6 number comes from an
instrumented run).  This package closes that loop:

  measure  — `TraceRecord` + harnesses (the instrumented toy engine,
             ground-truth simulator traces, the streaming reservoir tap)
  fit      — closed-form moment matching of the Eq-1 decomposition plus
             Gauss-Newton refinement of a service scale and the Sec-3.4
             imbalance blend (forward-mode Jacobians, through the CUDA
             (max,+) scan on the card for the replay residual)
  validate — held-out predicted-vs-measured-vs-simulated error report

`plan_from_trace` is the one-call wiring: hand it a trace and get a
Section-6 capacity plan from freshly calibrated parameters.  For grid
what-ifs, ``sweep.SweepGrid.build(base=cal.to_server_params(), ...)``
drops a calibration straight into `sweep`/`planner.plan_over_grid`.
Every entry point runs on its traces' device (``cuda`` by default for
the ones that make traces).
"""

from repro_torch.calibrate.fit import (  # noqa: F401
    CalibratedParams,
    calibrate,
    fit_alpha,
    fit_moments,
    refine,
)
from repro_torch.calibrate.measure import (  # noqa: F401
    TraceRecord,
    concat_traces,
    measure_engine_trace,
    simulate_trace,
    trace_from_tap,
    window_stats,
)
from repro_torch.calibrate.validate import (  # noqa: F401
    ValidationReport,
    calibrate_and_validate,
    validate,
)

__all__ = [
    "TraceRecord",
    "simulate_trace",
    "measure_engine_trace",
    "trace_from_tap",
    "concat_traces",
    "window_stats",
    "CalibratedParams",
    "fit_moments",
    "fit_alpha",
    "refine",
    "calibrate",
    "ValidationReport",
    "validate",
    "calibrate_and_validate",
    "plan_from_trace",
]


def plan_from_trace(traces, target_rate_qps: float, slo_seconds: float,
                    **calibrate_kwargs):
    """Measure -> fit -> plan in one call.

    Calibrates from ``traces`` and answers the paper's Section-6 manager
    question for the calibrated system.  Returns
    (:class:`CalibratedParams`, :class:`repro_torch.core.capacity
    .CapacityPlan`).
    """
    from repro_torch.core import capacity

    cal = calibrate(traces, **calibrate_kwargs)
    plan = capacity.plan_capacity(cal.to_server_params(), target_rate_qps,
                                  slo_seconds)
    return cal, plan
