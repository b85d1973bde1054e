"""Held-out validation of a calibrated model (the paper's Sec 5.3 figures).

PyTorch port of `repro.calibrate.validate`.  The paper judges its model
by predicted-vs-measured response times on operating points the fit
never saw.  :func:`validate` does exactly that with three columns per
held-out window:

  * **observed** — the trace's windowed mean response (the measurement);
  * **calibrated** — the analytical model at the window's observed rate,
    with the fitted Eq-1 parameters and imbalance blend;
  * **simulated** — the streaming (max,+) simulator run at the same rate
    with the same calibrated parameters (the model's mechanistic twin).

Error metrics (mean/p95 relative error, per-lambda error curves) mirror
the validation figures; :func:`calibrate_and_validate` wires the
time-split train/held-out protocol end to end.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.calibrate import fit, measure
from repro_torch.calibrate.fit import CalibratedParams
from repro_torch.calibrate.measure import TraceRecord
from repro_torch.core import simulator
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.faults import FaultSpec
from repro_torch.core.queueing import ServerParams
from repro_torch.core.simulator import _mix
from repro_torch.launch.elastic import AutoscalePolicy

Tensor = torch.Tensor

__all__ = ["ValidationReport", "validate", "calibrate_and_validate"]


@dataclasses.dataclass(frozen=True)
class ValidationReport:
    """Held-out predicted-vs-measured-vs-simulated comparison.

    All tensors are per held-out window, sorted by observed rate.
    """

    lam: Tensor            # observed window arrival rates (qps)
    r_observed: Tensor     # windowed mean response from the trace (s)
    r_calibrated: Tensor   # calibrated analytical prediction (s)
    r_simulated: Tensor    # calibrated-simulator mean response (s)
    calibrated: CalibratedParams
    # Replicated cross-check (``validate(..., cluster=ClusterSpec(r=...))``):
    # the calibrated cluster simulated as r dispatcher-routed copies at
    # r x the window rate — per-replica load is unchanged, so deviations
    # from ``r_simulated`` isolate routing/imbalance effects that the
    # analytical even-split assumption cannot see.  None when r == 1.
    # Under an autoscale policy ``replicas`` is the policy's max_r and
    # ``autoscale`` records the policy.  With a FaultSpec on the spec the
    # column runs the same calibrated fleet under injected faults
    # (``fault`` records the spec, ``faulted_degraded_fraction`` its
    # partial-quorum share).
    r_sim_replicated: Optional[Tensor] = None
    replicas: int = 1
    autoscale: Optional[AutoscalePolicy] = None
    fault: Optional[FaultSpec] = None
    faulted_degraded_fraction: Optional[Tensor] = None

    @property
    def rel_err_observed(self) -> Tensor:
        """|calibrated - observed| / observed, per window."""
        return torch.abs(self.r_calibrated - self.r_observed) / self.r_observed

    @property
    def rel_err_simulated(self) -> Tensor:
        """|calibrated - simulated| / simulated, per window."""
        return (torch.abs(self.r_calibrated - self.r_simulated)
                / self.r_simulated)

    @property
    def rel_err_replicated(self) -> Optional[Tensor]:
        """|calibrated - replicated sim| / replicated sim, per window."""
        if self.r_sim_replicated is None:
            return None
        return (torch.abs(self.r_calibrated - self.r_sim_replicated)
                / self.r_sim_replicated)

    @property
    def mean_rel_err(self) -> float:
        return float(torch.mean(self.rel_err_observed))

    @property
    def p95_rel_err(self) -> float:
        return float(torch.quantile(self.rel_err_observed, 0.95))

    @property
    def mean_rel_err_vs_sim(self) -> float:
        return float(torch.mean(self.rel_err_simulated))

    @property
    def max_rel_err_vs_sim(self) -> float:
        return float(torch.max(self.rel_err_simulated))

    def error_curve(self) -> tuple[np.ndarray, np.ndarray]:
        """(lam, relative error vs observed) — the per-lambda error curve."""
        return (self.lam.cpu().numpy(),
                self.rel_err_observed.cpu().numpy())

    def summary(self) -> str:
        replicated = self.r_sim_replicated is not None
        head = (f"{'lam (qps)':>10s} {'observed':>10s} {'calibrated':>11s} "
                f"{'simulated':>10s} {'err(obs)':>9s} {'err(sim)':>9s}")
        if replicated:
            head += f" {f'sim(x{self.replicas})':>10s} {'err(rep)':>9s}"
        lines = [
            "== calibration validation "
            f"({self.lam.shape[0]} held-out windows) ==",
            head,
        ]

        def host(x):
            return x.cpu().numpy()
        lam, obs, cal, sim = (host(self.lam), host(self.r_observed),
                              host(self.r_calibrated), host(self.r_simulated))
        eo, es = host(self.rel_err_observed), host(self.rel_err_simulated)
        if replicated:
            rep, er = host(self.r_sim_replicated), host(
                self.rel_err_replicated)
        for i in range(lam.shape[0]):
            row = (f"{lam[i]:10.2f} {obs[i] * 1e3:8.1f}ms "
                   f"{cal[i] * 1e3:9.1f}ms {sim[i] * 1e3:8.1f}ms "
                   f"{eo[i] * 100:8.1f}% {es[i] * 100:8.1f}%")
            if replicated:
                row += f" {rep[i] * 1e3:8.1f}ms {er[i] * 100:8.1f}%"
            lines.append(row)
        lines.append(
            f"vs observed:  mean {self.mean_rel_err * 100:.1f}%  "
            f"p95 {self.p95_rel_err * 100:.1f}%")
        lines.append(
            f"vs simulator: mean {self.mean_rel_err_vs_sim * 100:.1f}%  "
            f"max {self.max_rel_err_vs_sim * 100:.1f}%")
        if replicated:
            lines.append(
                f"vs x{self.replicas}-replicated simulator: mean "
                f"{er.mean() * 100:.1f}%  max {er.max() * 100:.1f}%")
        if self.fault is not None:
            note = f"replicated column fault-injected: {self.fault!r}"
            if self.faulted_degraded_fraction is not None:
                note += (
                    "  (degraded "
                    f"{float(torch.mean(self.faulted_degraded_fraction)) * 100:.1f}%)")
            lines.append(note)
        return "\n".join(lines)


def _vec_params(params: ServerParams, n: int, device) -> ServerParams:
    """(n,) float32 copies of every field, as the reference casts them."""
    return ServerParams(**{
        f.name: torch.full((n,), float(getattr(params, f.name)),
                           dtype=torch.float32, device=device)
        for f in dataclasses.fields(ServerParams)})


def validate(
    traces: Union[TraceRecord, Sequence[TraceRecord]],
    calibrated: CalibratedParams,
    *,
    n_windows: int = 8,
    holdout_fraction: float = 1.0,
    seed: int = 0,
    simulator_queries: int = 40_000,
    impl: str = "auto",
    cluster: Optional[ClusterSpec] = None,
    draws=None,
) -> ValidationReport:
    """Score a calibrated model on (held-out) trace windows.

    ``holdout_fraction`` keeps the LAST fraction of windows (a time
    split: validation data is strictly later than anything a preceding
    `fit.calibrate` call saw); 1.0 scores every window of ``traces`` —
    the mode :func:`calibrate_and_validate` uses after splitting the raw
    trace itself.  The simulator column re-runs the streaming engine at
    each held-out window's observed rate under the calibrated parameters
    (mode="cache", one batched dispatch for all windows, seeded by
    ``seed``; ``draws`` replaces its per-chunk random numbers, see
    `repro_torch.core.simulator`).  It runs on the traces' device in
    their dtype, from the parameters rounded to float32 as the reference
    rounds them.

    ``cluster=ClusterSpec(r > 1)`` adds the simulated-replicated column:
    the same calibrated cluster deployed as r dispatcher-routed copies
    (with the spec's routing/result cache/replica engine) at r x each
    window's observed rate, seeded ``_mix(seed, r)``.  Per-replica load
    matches the measured system, so this column scores the scale-out
    story the single-cluster trace cannot measure directly.  With
    ``autoscale=`` on the spec the column runs the elastic fleet at
    ``max_r`` x the window rate; with ``fault=FaultSpec(...)`` it runs
    the calibrated fleet UNDER those injected faults (the report then
    carries the spec and the observed ``faulted_degraded_fraction``).
    """
    spec = ClusterSpec() if cluster is None else cluster
    lam_w, r_obs_w, _ = measure.window_stats(traces, n_windows)
    n_hold = max(1, int(round(lam_w.shape[0] * holdout_fraction)))
    lam_h, r_obs_h = lam_w[-n_hold:], r_obs_w[-n_hold:]

    r_cal = calibrated.predict_mean_response(lam_h)

    params = calibrated.to_server_params()
    vp = _vec_params(params, n_hold, lam_h.device)
    kw = dict(p=int(params.p), mode="cache", impl=impl,
              device=lam_h.device, dtype=lam_h.dtype)
    sim = simulator.simulate_fork_join_batch(
        seed, lam_h, vp, simulator_queries, draws=draws, **kw)
    r_sim = sim.mean_response

    r_rep = degr_frac = None
    rep_r = spec.engine_r
    if rep_r > 1 or spec.autoscale is not None or spec.fault is not None:
        rep = simulator.simulate_fork_join_batch(
            _mix(seed, rep_r), lam_h * rep_r, vp, simulator_queries,
            cluster=spec, **kw)
        r_rep = rep.mean_response
        if (spec.fault is not None
                and spec.fault.broker_timeout_seconds is not None):
            degr_frac = rep.degraded_fraction

    order = torch.argsort(lam_h)
    return ValidationReport(
        lam=lam_h[order], r_observed=r_obs_h[order],
        r_calibrated=r_cal[order], r_simulated=r_sim[order],
        calibrated=calibrated,
        r_sim_replicated=None if r_rep is None else r_rep[order],
        replicas=rep_r, autoscale=spec.autoscale, fault=spec.fault,
        faulted_degraded_fraction=(None if degr_frac is None
                                   else degr_frac[order]))


def _holdout_split(traces: Union[TraceRecord, Sequence[TraceRecord]],
                   holdout_fraction: float
                   ) -> tuple[list[TraceRecord], list[TraceRecord]]:
    """(train, held): the last ``holdout_fraction`` of the queries held
    out, walking batches from the end and cutting at most one in two."""
    batches = measure.as_trace_list(traces)
    total = sum(tr.n_queries for tr in batches)
    remaining = max(2, int(total * holdout_fraction))
    train: list[TraceRecord] = []
    held: list[TraceRecord] = []
    for tr in reversed(batches):
        if remaining <= 0:
            train.insert(0, tr)
        elif tr.n_queries <= remaining:
            held.insert(0, tr)
            remaining -= tr.n_queries
        else:
            cut = tr.n_queries - remaining
            train.insert(0, tr.map(lambda x: x[:cut]))
            held.insert(0, tr.map(lambda x: x[cut:]))
            remaining = 0
    return train, held


def calibrate_and_validate(
    traces: Union[TraceRecord, Sequence[TraceRecord]],
    *,
    n_windows: int = 16,
    holdout_fraction: float = 0.25,
    seed: int = 0,
    simulator_queries: int = 40_000,
    **fit_kwargs,
) -> tuple[CalibratedParams, ValidationReport]:
    """Time-split protocol: fit on the head, validate on the tail.

    The last ``holdout_fraction`` of the measurements never enters the
    fit; the report's error metrics are honest held-out numbers.  The
    split walks trace batches from the end (batches are independent runs
    with their own clocks — see `measure.concat_traces`), cutting at most
    one batch in two, so held-out windows keep clean interarrival spans.
    """
    train, held = _holdout_split(traces, holdout_fraction)
    if not train:
        raise ValueError("holdout_fraction leaves no training data")
    cal = fit.calibrate(
        train, n_windows=max(4, n_windows - int(n_windows
                                                * holdout_fraction)),
        **fit_kwargs)
    report = validate(
        held, cal, n_windows=max(2, int(n_windows * holdout_fraction)),
        holdout_fraction=1.0, seed=seed,
        simulator_queries=simulator_queries)
    return cal, report
