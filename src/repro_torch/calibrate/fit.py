"""Fit Eq-1 parameters + the Sec-3.4 imbalance correction from traces.

PyTorch port of `repro.calibrate.fit`.  Two stages:

1. **Closed-form moment matching** (:func:`fit_moments`): the Eq-1
   decomposition falls straight out of the trace's sufficient statistics.
   ``hit`` is the hit-flag mean; ``s_hit`` the mean busy time over hit
   entries; ``s_broker`` the mean broker busy time.  When the trace
   records the disk split, ``s_disk``/``s_miss`` are exact conditional
   means; without it they come from the first two moments of the miss
   busy time — for Exp(a)+Exp(b), mean m and variance v give
   (a - b)^2 = 2v - m^2, closed form up to the {a, b} labeling, resolved
   by the larger-is-disk convention.

2. **Gauss-Newton refinement** (:func:`refine`): a damped Gauss-Newton
   on windowed predicted-vs-observed mean-response residuals fitting the
   Sec-3.4 imbalance blend ``alpha`` between the Eq-7 bounds:

       R_pred(lam) = R_broker + (1 + alpha (H_p - 1)) R_server.

   The (candidate-params x trace-window) residual grid is one broadcast
   evaluation that seeds the iteration; the ``n_iters`` steps are a
   Python loop whose Jacobian is one `torch.func.jvp` a parameter (theta
   has one or two entries).  The ``residual="maxplus"`` path instead
   replays the trace's arrivals through the FCFS recurrence
   (`simulator.fcfs_completion_times`) with busy times rescaled by
   ``s_scale``: on the card the replay and its tangent run the CUDA
   (max,+) scan, whose forward-mode rule lives in
   `repro_torch.kernels.maxplus_scan.autodiff`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import torch

from repro_torch._tensor import as_tensor, resolve
from repro_torch.calibrate import measure
from repro_torch.calibrate.measure import TraceRecord
from repro_torch.core import queueing
from repro_torch.core.queueing import ServerParams
from repro_torch.core.simulator import fcfs_completion_times

Tensor = torch.Tensor

__all__ = [
    "CalibratedParams",
    "fit_moments",
    "fit_alpha",
    "refine",
    "calibrate",
]

_RHO_CAP = 0.995          # soft saturation guard inside the optimizer
_GN_DAMPING = 1e-6


@dataclasses.dataclass(frozen=True)
class CalibratedParams:
    """A calibrated model: Eq-1 parameters + the imbalance blend.

    ``params`` is a plain :class:`ServerParams` with the refinement scale
    already folded in, so it drops straight into `capacity.plan_capacity`,
    `sweep.SweepGrid.build(base=...)`, and `planner.plan_over_grid` — the
    measure -> fit -> plan wiring is just ``cal.to_server_params()``.
    """

    params: ServerParams
    alpha: Tensor            # Sec 3.4 imbalance blend in [0, 1]
    s_scale: Tensor          # refinement scale applied to the service times
    residual_rms: Tensor     # final weighted log-residual RMS of the fit

    def to_server_params(self) -> ServerParams:
        return self.params

    def predict_mean_response(self, lam) -> Tensor:
        """Calibrated mean response: R_lo + alpha (R_hi - R_lo) (Eq 7)."""
        lo, hi = queueing.response_time_bounds(lam, self.params)
        return lo + self.alpha * (hi - lo)

    def predict_bounds(self, lam) -> tuple[Tensor, Tensor]:
        return queueing.response_time_bounds(lam, self.params)


def _field(x, like: Tensor) -> Tensor:
    return as_tensor(x, like.device, like.dtype)


def _scale_service(params: ServerParams, s_scale: Tensor) -> ServerParams:
    """Rescale the index-server service decomposition (broker untouched)."""
    return dataclasses.replace(
        params,
        s_hit=_field(params.s_hit, s_scale) * s_scale,
        s_miss=_field(params.s_miss, s_scale) * s_scale,
        s_disk=_field(params.s_disk, s_scale) * s_scale)


def fit_moments(
    traces: Union[TraceRecord, Sequence[TraceRecord]],
) -> ServerParams:
    """Closed-form Eq-1 decomposition from trace sufficient statistics.

    Accepts a single record or any chunking of one into batches; the
    estimate only depends on accumulated sums, so it is invariant to the
    chunking.
    """
    batches = measure.as_trace_list(traces)
    p = batches[0].p
    has_disk = all(tr.server_disk is not None for tr in batches)

    n_entries = n_hit = 0.0
    s_busy_hit = s_busy_miss = ss_busy_miss = 0.0
    s_disk_miss = s_broker = 0.0
    n_queries = 0.0
    for tr in batches:
        hit = tr.server_hit
        miss = 1.0 - hit
        n_entries += hit.numel()
        n_hit += torch.sum(hit)
        s_busy_hit += torch.sum(tr.server_busy * hit)
        s_busy_miss += torch.sum(tr.server_busy * miss)
        ss_busy_miss += torch.sum(tr.server_busy**2 * miss)
        if has_disk:
            s_disk_miss += torch.sum(tr.server_disk * miss)
        s_broker += torch.sum(tr.broker_busy)
        n_queries += tr.n_queries

    n_miss = torch.clamp_min(n_entries - n_hit, 1.0)
    hit_ratio = n_hit / n_entries
    s_hit = s_busy_hit / torch.clamp_min(n_hit, 1.0)
    m = s_busy_miss / n_miss                       # E[busy | miss]
    if has_disk:
        s_disk = s_disk_miss / n_miss
        s_miss = m - s_disk
    else:
        v = torch.clamp_min(ss_busy_miss / n_miss - m * m, 0.0)
        d = torch.sqrt(torch.clamp_min(2.0 * v - m * m, 0.0))
        s_disk = 0.5 * (m + d)                     # larger-is-disk
        s_miss = 0.5 * (m - d)
    return ServerParams(
        p=p, s_broker=s_broker / n_queries, s_hit=s_hit,
        s_miss=s_miss, s_disk=s_disk, hit=hit_ratio)


def _soft_mean_response(lam, params: ServerParams, alpha) -> Tensor:
    """The fitted-mean predictor with a saturation-safe M/M/1 core.

    Identical to `CalibratedParams.predict_mean_response` below rho_cap;
    the clip keeps residuals finite while the optimizer passes through
    infeasible candidates (an Inf residual would NaN the Jacobian).
    Broadcasts over ``lam``, ``alpha`` and the parameters."""
    dev, dt = resolve(lam, params)
    lam = as_tensor(lam, dev, dt)
    s = queueing.service_time_server(params)

    def r_mm1(s_):
        rho = torch.clamp(lam * s_, 0.0, _RHO_CAP)
        return s_ / (1.0 - rho)

    hp = queueing.harmonic_number(params.p, device=dev)
    return r_mm1(as_tensor(params.s_broker, dev, dt)) + (
        1.0 + alpha * (hp - 1.0)) * r_mm1(s)


def fit_alpha(params: ServerParams, lam, r_observed) -> Tensor:
    """Closed-form imbalance blend from (lam, mean response) points.

    alpha solves R_obs = R_lo + alpha (R_hi - R_lo) per point; points are
    averaged weighted by the bound gap (wide-gap points constrain alpha
    best).  This is the whole fit available to response-only traces —
    e.g. the streaming tap (`measure.trace_from_tap`)."""
    lo, hi = queueing.response_time_bounds(lam, params)
    r_observed = torch.as_tensor(r_observed, device=lo.device)
    gap = torch.clamp_min(hi - lo, 1e-12)
    ok = torch.isfinite(lo) & torch.isfinite(hi) & torch.isfinite(r_observed)
    a = torch.clamp((r_observed - lo) / gap, 0.0, 1.0)
    a = torch.where(ok, a, 0.0)   # NaN observations would survive a*0
    w = torch.where(ok, gap, 0.0)
    return torch.sum(a * w) / torch.clamp_min(torch.sum(w), 1e-30)


def _window_residuals_analytic(theta, params, lam_w, r_obs_w, sqrt_w):
    """theta (..., 1) = (logit alpha,) or (..., 2) = (log s_scale, logit
    alpha); leading candidate axes broadcast against the windows."""
    s_scale = (torch.exp(theta[..., :1]) if theta.shape[-1] == 2
               else torch.ones_like(theta[..., :1]))
    alpha = torch.sigmoid(theta[..., -1:])
    pred = _soft_mean_response(lam_w, _scale_service(params, s_scale),
                               alpha)
    return sqrt_w * (torch.log(pred) - torch.log(r_obs_w))


def _replay_window_means(trace: TraceRecord, s_scale, k: int, w: int
                         ) -> Tensor:
    """Mean response per window from a (max,+) replay at scaled service.

    Replays the OBSERVED arrivals and busy times — rescaled by
    ``s_scale`` — through the same FCFS recurrence the simulator uses
    (the CUDA scan on the card, with its forward-mode rule), so `refine`
    can Gauss-Newton through the queueing sample path itself.  (k, w) is
    the batch's `measure.window_plan` entry."""
    arr = trace.arrival
    broker_done = fcfs_completion_times(arr, trace.broker_busy)
    busy = trace.server_busy.T * s_scale          # (p, n)
    fork = broker_done[None, :].expand(busy.shape)
    response = torch.amax(fcfs_completion_times(fork, busy), dim=0) - arr
    return torch.mean(response[: k * w].reshape(k, w), dim=1)


def _residual_and_jacobian(resid, theta: Tensor, eye: Tensor
                           ) -> tuple[Tensor, Tensor]:
    """(resid(theta), d resid / d theta): one forward-mode pass a
    parameter (a row of ``eye``), each through the (max,+) scan's rule
    where the residual replays one."""
    outs = [torch.func.jvp(resid, (theta,), (e,)) for e in eye]
    return outs[0][0], torch.stack([col for _, col in outs], dim=-1)


def refine(
    params: ServerParams,
    lam_w: Tensor,
    r_obs_w: Tensor,
    weights: Tensor,
    *,
    n_iters: int = 20,
    residual: str = "analytic",
    traces: Union[TraceRecord, Sequence[TraceRecord], None] = None,
    n_candidates: int = 9,
    fit_scale: bool = False,
    n_windows: int = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Damped Gauss-Newton refinement; returns (s_scale, alpha, rms).

    Seeds from the best point of a (candidate-params x window) residual
    grid, then runs ``n_iters`` Gauss-Newton steps whose Jacobians come
    from `torch.func.jvp`.  Residuals are log-space (scale-free),
    weighted by sqrt(window count).

    The analytic path fits ``alpha`` ONLY unless ``fit_scale=True``: the
    moment-matched decomposition already pins the service scale from
    direct busy-time measurement, and a free scale lets constant-alpha
    misspecification (the true blend drifts with utilization) leak into
    the directly-measured parameters — the classic identifiability trap
    of fitting scale and shape to one response curve.

    ``residual="maxplus"`` fits ``s_scale`` against the (max,+) replay of
    ``traces`` instead of the analytic curve.  There the scale IS
    well-identified — the replay pins the queueing mechanism exactly, so
    the only freedom left is the busy-time scale (e.g. timer overhead in
    an engine harness) — and alpha then comes from :func:`fit_alpha`
    against the replayed windows.  ``lam_w``/``r_obs_w``/``weights`` must
    come from `measure.window_stats` on the same traces, and
    ``n_windows`` must be the SAME value that call used, so the replayed
    windows line up one-to-one.
    """
    dtype, dev = lam_w.dtype, lam_w.device
    sqrt_w = torch.sqrt(weights / torch.clamp_min(torch.sum(weights), 1e-30))
    if residual == "maxplus":
        if traces is None:
            raise ValueError("residual='maxplus' needs the traces")
        batches = measure.as_trace_list(traces)
        plan = measure.window_plan(
            batches, lam_w.shape[0] if n_windows is None else n_windows)
        realized = sum(k for k, _ in plan if k > 0)
        if realized != lam_w.shape[0]:
            raise ValueError(
                f"window plan yields {realized} windows but lam_w has "
                f"{lam_w.shape[0]}; pass refine(..., n_windows=) the same "
                "value the window_stats call used")
        # The replay starts each batch from an EMPTY queue, but the
        # observed responses carry backlog in from the (trimmed) warmup,
        # so each batch's first window systematically reads low in the
        # replay.  Mask it out of the residuals (and the later alpha fit)
        # rather than letting Gauss-Newton inflate s_scale to paper over
        # the transient.
        keep = torch.cat([torch.arange(k, device=dev) > 0
                          for k, _ in plan if k > 0])
        sqrt_w = sqrt_w * keep.to(dtype)

        def replay(s):
            return torch.cat([_replay_window_means(tr, s, k, w)
                              for tr, (k, w) in zip(batches, plan) if k > 0])

        def resid(theta):
            pred = replay(torch.exp(theta[0]))
            return sqrt_w * (torch.log(torch.clamp_min(pred, 1e-12))
                             - torch.log(r_obs_w))

        theta = torch.zeros((1,), dtype=dtype, device=dev)
    elif residual == "analytic":
        def resid(theta):
            return _window_residuals_analytic(theta, params, lam_w,
                                              r_obs_w, sqrt_w)

        # ONE broadcast evaluation over (candidate x window): seed where
        # the grid is least wrong.  alpha across (0, 1); log s_scale in
        # +-20% when it is being fitted at all.
        ca = torch.linspace(-2.5, 2.5, n_candidates, dtype=dtype, device=dev)
        if fit_scale:
            cs = torch.linspace(-0.2, 0.2, n_candidates, dtype=dtype,
                                device=dev)
            cand = torch.stack(torch.meshgrid(cs, ca, indexing="ij"),
                               -1).reshape(-1, 2)
        else:
            cand = ca[:, None]
        grid_rms = torch.sum(resid(cand) ** 2, dim=-1)
        theta = cand[torch.argmin(grid_rms)]
    else:
        raise ValueError(f"unknown residual path: {residual}")

    eye = torch.eye(theta.shape[0], dtype=dtype, device=dev)
    for _ in range(n_iters):
        r, j = _residual_and_jacobian(resid, theta, eye)
        delta = torch.linalg.solve(j.T @ j + _GN_DAMPING * eye, j.T @ r)
        # trust region: a log-space step never exceeds 0.5
        theta = theta - torch.clamp(delta, -0.5, 0.5)
    rms = torch.sqrt(torch.sum(resid(theta) ** 2))
    if residual == "maxplus":
        s_scale = torch.exp(theta[0])
        alpha = fit_alpha(_scale_service(params, s_scale),
                          torch.where(keep, lam_w, 0.0),
                          torch.where(keep, replay(s_scale), torch.nan))
    else:
        s_scale = (torch.exp(theta[0]) if fit_scale
                   else torch.ones((), dtype=dtype, device=dev))
        alpha = torch.sigmoid(theta[-1])
    return s_scale, alpha, rms


def calibrate(
    traces: Union[TraceRecord, Sequence[TraceRecord]],
    *,
    n_windows: int = 16,
    do_refine: bool = True,
    n_iters: int = 20,
    residual: str = "analytic",
    fit_scale: bool = False,
) -> CalibratedParams:
    """Moment-match then refine: the full fitting pipeline.

    Returns :class:`CalibratedParams` whose ``params`` carry the refined
    scale, ready for `capacity.plan_capacity` / `sweep.SweepGrid.build`.
    Runs on the traces' device in their dtype.
    """
    base = fit_moments(traces)
    lam_w, r_obs_w, counts = measure.window_stats(traces, n_windows)
    if not do_refine:
        alpha = fit_alpha(base, lam_w, r_obs_w)
        pred = _soft_mean_response(lam_w, base, alpha)
        rms = torch.sqrt(torch.mean((torch.log(pred)
                                     - torch.log(r_obs_w)) ** 2))
        return CalibratedParams(
            params=base, alpha=alpha,
            s_scale=torch.ones((), dtype=lam_w.dtype, device=lam_w.device),
            residual_rms=rms)
    s_scale, alpha, rms = refine(
        base, lam_w, r_obs_w, counts, n_iters=n_iters, residual=residual,
        traces=traces, fit_scale=fit_scale, n_windows=n_windows)
    return CalibratedParams(
        params=_scale_service(base, s_scale), alpha=alpha,
        s_scale=s_scale, residual_rms=rms)
