"""Text dashboard for the observability layer (PyTorch port of
`repro.obs.report`).

    PYTHONPATH=src python -m repro_torch.obs.report [--device cuda] [...]

Renders, in order:

  * sparkline timelines — per-bin throughput, server/broker utilization,
    queue depth, SLO violations, routing imbalance — from a streaming
    run with ``telemetry=TelemetrySpec(...)``;
  * operational-law self-checks — the binned telemetry must satisfy
    U = X * S (utilization law, paper Eq 3) and L = lambda * W
    (Little's law) per bin, because all three sides are measured from
    the same arrivals; the dashboard recomputes both sides and prints
    the worst relative deviation (rounding only);
  * a profile table — first-call time, flops, bytes, peak memory of the
    (max,+) kernel stack via `repro_torch.obs.profile`;
  * optionally (``--trace-json out.json``) a span-trace export of the
    same scenario, schema-validated on the spot.

Every rendering helper is importable (the examples and tests reuse
them); only ``main`` touches argparse.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

_BLOCKS = "▁▂▃▄▅▆▇█"


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a float64 numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def sparkline(values: Sequence[float], lo: Optional[float] = None,
              hi: Optional[float] = None) -> str:
    """Unicode sparkline of a 1-D series (NaN renders as a space)."""
    v = _np(values)
    finite = v[np.isfinite(v)]
    lo = float(finite.min()) if lo is None and finite.size else (lo or 0.0)
    hi = float(finite.max()) if hi is None and finite.size else (hi or 1.0)
    span = hi - lo
    out = []
    for x in v:
        if not np.isfinite(x):
            out.append(" ")
            continue
        t = 0.0 if span <= 0 else (x - lo) / span
        out.append(_BLOCKS[min(len(_BLOCKS) - 1,
                               max(0, int(t * len(_BLOCKS))))])
    return "".join(out)


def render_timeline(tl, label: str = "") -> str:
    """Multi-row sparkline panel for one scenario's Timeline."""
    util = _np(tl.utilization)              # (B, r, p)
    rows = []
    if label:
        rows.append(f"== timeline: {label} ==")
    bin_s = float(_np(tl.bin_seconds))
    rows.append(f"  {tl.n_bins} bins x {bin_s:.3g}s")

    def line(name, series, fmt="{:.3g}"):
        s = _np(series)
        f = s[np.isfinite(s)]
        rng = (f"[{fmt.format(f.min())}, {fmt.format(f.max())}]"
               if f.size else "[empty]")
        rows.append(f"  {name:<14} {sparkline(s)}  {rng}")

    line("throughput", tl.throughput)
    line("util (srv avg)", util.mean(axis=(1, 2)))
    line("util (srv max)", util.max(axis=(1, 2)))
    line("util (broker)", _np(tl.broker_utilization).mean(axis=1))
    line("queue depth", tl.queue_depth)
    line("mean resp (s)", tl.mean_response)
    if float(_np(tl.slo_count).sum()) > 0:
        line("SLO viol frac", tl.slo_violation_fraction)
    if util.shape[1] > 1:
        line("imbalance", tl.imbalance_share)
    if float(_np(tl.hit_count).sum()) > 0:
        line("cache hits", tl.hit_fraction)
    if getattr(tl, "active_sum", None) is not None:
        line("active repl", tl.active_replicas)
    if getattr(tl, "up_sum", None) is not None:
        line("up replicas", tl.up_replicas)
    if (getattr(tl, "spill_sum", None) is not None
            and float(_np(tl.spill_sum).sum()) > 0):
        line("spill frac", tl.spill_fraction)
    if (getattr(tl, "degraded_sum", None) is not None
            and float(_np(tl.degraded_sum).sum()) > 0):
        line("degraded frac", tl.degraded_fraction)
    return "\n".join(rows)


def oplaw_check(tl) -> tuple[str, float]:
    """Self-check U = X * S and L = lambda * W on a Timeline.

    Both laws are identities of the binned accumulators (busy-seconds and
    response-seconds are attributed to the arrival bin), so the deviation
    is float rounding only.  Returns (report, worst relative deviation
    over non-empty bins).
    """
    count = _np(tl.count)
    busy = _np(tl.busy_server).sum(axis=(1, 2)) \
        + _np(tl.busy_broker).sum(axis=1)
    resp = _np(tl.resp_sum)
    bin_s = float(_np(tl.bin_seconds))
    occupied = count > 0

    # U = X * S: busy/bin == (count/bin) * (busy/count)
    x = count / bin_s
    s = busy / np.maximum(count, 1.0)
    u_direct = busy / bin_s
    u_law = x * s
    dev_u = np.abs(u_direct - u_law) / np.maximum(np.abs(u_direct), 1e-12)
    # L = lambda * W: resp_sum/bin == (count/bin) * (resp_sum/count)
    l_direct = resp / bin_s
    l_law = x * (resp / np.maximum(count, 1.0))
    dev_l = np.abs(l_direct - l_law) / np.maximum(np.abs(l_direct), 1e-12)

    worst = float(max(dev_u[occupied].max(initial=0.0),
                      dev_l[occupied].max(initial=0.0)))
    lines = [
        "== operational-law self-checks ==",
        f"  U = X*S   worst per-bin rel dev: "
        f"{dev_u[occupied].max(initial=0.0):.2e}",
        f"  L = lam*W worst per-bin rel dev: "
        f"{dev_l[occupied].max(initial=0.0):.2e}",
        f"  ({int(occupied.sum())}/{count.size} occupied bins; both laws "
        "are identities of the arrival-binned accumulators)",
    ]
    return "\n".join(lines), worst


def render_profiles(records) -> str:
    """Fixed-width table of ProfileRecords."""
    rows = ["== kernel/entry-point profiles ==",
            f"  {'name':<24} {'compile_s':>9} {'run_ms':>8} "
            f"{'Mflops':>9} {'MB moved':>9} {'peak MB':>8} {'F/B':>6}"]
    for r in records:
        rows.append(
            f"  {r.name:<24} {r.compile_s:>9.3f} {r.run_s * 1e3:>8.2f} "
            f"{r.flops / 1e6:>9.2f} {r.bytes_accessed / 1e6:>9.2f} "
            f"{r.peak_bytes / 1e6:>8.2f} {r.arithmetic_intensity:>6.2f}")
    return "\n".join(rows)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="repro_torch.obs text dashboard (timelines, "
                    "operational-law self-checks, kernel profiles)")
    ap.add_argument("--device", default="cuda",
                    help="where the simulation runs (default cuda)")
    ap.add_argument("--scenario", choices=("stationary", "flash"),
                    default="flash")
    ap.add_argument("--lam", type=float, default=24.0,
                    help="base arrival rate (qps)")
    ap.add_argument("--r", type=int, default=3, help="replicas")
    ap.add_argument("--routing", default="jsq",
                    choices=("round_robin", "random", "jsq"))
    ap.add_argument("--n-queries", type=int, default=20_000)
    ap.add_argument("--bins", type=int, default=48)
    ap.add_argument("--slo", type=float, default=0.7,
                    help="SLO seconds for the violation timeline")
    ap.add_argument("--no-profile", action="store_true",
                    help="skip the kernel profiling table")
    ap.add_argument("--trace-json", default=None,
                    help="also export + validate a span trace here")
    args = ap.parse_args(argv)

    from repro_torch.core import capacity, simulator
    from repro_torch.core.arrivals import ArrivalProcess
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.obs import profile as obs_profile
    from repro_torch.obs.timeline import TelemetrySpec

    dev = args.device
    params = capacity.TABLE5_PARAMS
    if args.scenario == "flash":
        horizon = args.n_queries / (args.lam * 1.6)
        proc = ArrivalProcess.flash_crowd(
            args.lam, burst_starts=0.35 * horizon,
            burst_seconds=0.2 * horizon, burst_multiplier=4.0,
            period_seconds=horizon, bin_seconds=horizon / 64, device=dev)
        label = (f"flash crowd (lam {args.lam:g} qps x4 burst, "
                 f"r={args.r}, {args.routing})")
    else:
        proc = ArrivalProcess.stationary(args.lam, device=dev)
        label = f"stationary lam {args.lam:g} qps, r={args.r}"

    spec = TelemetrySpec(n_bins=args.bins, slo_seconds=args.slo)
    res = simulator.simulate_fork_join(
        0, proc, args.n_queries, params,
        cluster=ClusterSpec(r=args.r, routing=args.routing),
        telemetry=spec, device=dev)
    print(render_timeline(res.timeline, label))
    print()
    report, worst = oplaw_check(res.timeline)
    print(report)
    if worst > 1e-3:
        raise SystemExit(f"operational-law self-check FAILED "
                         f"(worst dev {worst:.2e} > 1e-3)")

    if not args.no_profile:
        print()
        print(render_profiles(obs_profile.profile_kernels(device=dev)))

    if args.trace_json is not None:
        from repro_torch.obs import trace_export
        n_span = min(args.n_queries, 2000)
        spans = trace_export.simulate_spans(
            0, proc, n_span, params, r=args.r, routing=args.routing,
            device=dev)
        path = trace_export.export_chrome_trace(spans, args.trace_json)
        counts = trace_export.validate_chrome_trace(path)
        print(f"\nspan trace: {path} ({counts['X']} spans, "
              f"{counts['async_pairs']} query lifetimes, "
              f"{counts['lanes']} lanes) — schema OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
