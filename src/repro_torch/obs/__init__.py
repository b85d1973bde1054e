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
  * `repro_torch.obs.profile` — profiling hooks: the simulator's layer
    spans (`layer_span`), and first-call time, steady time, flop and
    byte counts and peak device memory of the kernel stack and entry
    points, as structured `ProfileRecord`s.

``python -m repro_torch.obs.report`` renders all three as a text
dashboard.

To see the simulator's layers on the card, wrap any planning call in a
profiler; nothing else turns the spans on:

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        simulate_fork_join_batch(...)      # or sweep_simulated, plan_...
    print(prof.key_averages().table(sort_by="cpu_time_total"))

The spans are ``repro_torch.sim.dispatch``, ``.setup``, ``.chunk`` and
the chunk's leaves (``.draws``, ``.arrivals``, ``.fleet``, ``.route``,
``.compact``, ``.fcfs.cache`` / ``.broker`` / ``.servers``, ``.join``,
``.stats``, ``.telemetry``); each device kernel belongs to the
innermost span around its launch.  Off the profiler a span costs
0.12-0.67 us, on 1.34-3.34 us (`repro_torch.obs.profile`).

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
