"""Observability for the simulated search engine (PyTorch port of
`repro.obs`).

Three layers, one per way of looking at a running cluster:

  * `repro_torch.obs.timeline` — streaming per-time-bin telemetry
    (:class:`TelemetrySpec` / :class:`Timeline`), accumulated by the
    simulator's chunk loop and self-checkable against the operational
    laws U = X*S and L = lambda*W.
  * `repro_torch.obs.trace_export` — span traces: a simulated or replayed
    sample path rendered as Chrome-trace JSON (chrome://tracing or
    Perfetto) showing the broker -> fork -> join structure per query.
  * `repro_torch.obs.profile` — profiling hooks: first-call time, steady
    time, flop and byte counts and peak device memory of the kernel
    stack and entry points, as structured `ProfileRecord`s.

``python -m repro_torch.obs.report`` renders all three as a text
dashboard.

Import discipline: this package root re-exports ONLY the timeline layer
— `repro_torch.core.simulator` imports it, so anything heavier (trace
export and profiling import the simulator and the kernels) stays behind
its own submodule import to keep the import graph acyclic.
"""

from repro_torch.obs.timeline import (  # noqa: F401
    DEFAULT_TIMELINE_BINS,
    TelemetrySpec,
    Timeline,
    timeline_from_trace,
)

__all__ = ["TelemetrySpec", "Timeline", "timeline_from_trace",
           "DEFAULT_TIMELINE_BINS"]
