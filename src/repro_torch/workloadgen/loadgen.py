"""Open-loop load generation: Poisson arrivals, diurnal modulation, folding.

PyTorch port of `repro.workloadgen.loadgen`.  Reproduces the temporal
structure of Figs 3-5: within a stable one-hour window arrivals are
homogeneous Poisson (exponential gaps, Sec 4.2); across a day/week the
rate follows a diurnal profile; the *folding* procedure merges
corresponding windows to boost the rate (Table 3: TodoBR Monday 0.69 qps
-> 23.58 qps folded, a ~34x boost = 243 days / 7-day window).

Built on the same :class:`repro_torch.core.arrivals.ArrivalProcess` the
streaming simulator consumes: :func:`diurnal_rates` produces the weekly
hourly profile once (a tensor on the caller's device),
:func:`diurnal_process` wraps it for the simulator, and
:func:`diurnal_arrivals` samples concrete timestamps from the *same*
binned profile by thinning.  Host-side timestamp positions stay numpy
float64 (float32 would quantize long windows; see `poisson_arrivals`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.core.arrivals import ArrivalProcess

__all__ = [
    "poisson_arrivals",
    "diurnal_rates",
    "diurnal_process",
    "diurnal_arrivals",
    "replay_process",
    "fold",
    "WEEK_SECONDS",
]

WEEK_SECONDS = 7 * 24 * 3600.0
_WEEK_HOURS = 7 * 24


def poisson_arrivals(rate: float, duration: float, *, seed: int = 0
                     ) -> np.ndarray:
    """Homogeneous Poisson arrival timestamps on [0, duration).

    Timestamps are drawn host-side in float64: a float32 uniform only has
    2^-24 resolution, which would quantize a 243-day fold window to
    ~1.25 s steps and generate masses of zero gaps.
    """
    rng = np.random.default_rng(seed)
    n = rng.poisson(rate * duration)
    return np.sort(rng.random(n) * duration)


def diurnal_rates(
    base_rate: float = 1.0,
    *,
    peak_hour: float = 15.0,
    peak_to_trough: float = 4.0,
    weekend_factor: float = 0.7,
    device: DeviceLike = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(168,) weekly hourly-binned rate profile, in qps.

    rate(hour) = base * daily * weekly; daily is a raised cosine peaking at
    ``peak_hour`` with the given peak/trough ratio (evaluated at bin
    centers); weekends are scaled by ``weekend_factor`` (TodoBR profile;
    Radix used >1).
    """
    hours = torch.arange(_WEEK_HOURS, dtype=dtype, device=device)
    hour_of_day = torch.remainder(hours, 24.0) + 0.5
    dow = torch.floor_divide(hours, 24.0)
    r = peak_to_trough
    amp = (r - 1.0) / (r + 1.0)
    daily = 1.0 + amp * torch.cos((hour_of_day - peak_hour) / 24.0
                                  * 2.0 * math.pi)
    weekly = torch.where(dow >= 5, weekend_factor, 1.0).to(dtype)
    return base_rate * daily * weekly


def diurnal_process(
    base_rate: float,
    *,
    peak_hour: float = 15.0,
    peak_to_trough: float = 4.0,
    weekend_factor: float = 0.7,
    bin_seconds: float = 3600.0,
    device: DeviceLike = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
) -> ArrivalProcess:
    """The weekly diurnal profile as a simulator-ready arrival process.

    ``bin_seconds`` rescales time: 3600 is the real week; smaller values
    compress it, which lets a modest simulated horizon cover full
    diurnal/weekly cycles (handy for sweep-scale what-ifs).
    """
    rates = diurnal_rates(base_rate, peak_hour=peak_hour,
                          peak_to_trough=peak_to_trough,
                          weekend_factor=weekend_factor, device=device,
                          dtype=dtype)
    return ArrivalProcess.piecewise(rates, bin_seconds, device=device,
                                    dtype=dtype)


def diurnal_arrivals(
    base_rate: float,
    days: int,
    *,
    peak_hour: float = 15.0,
    peak_to_trough: float = 4.0,
    weekend_factor: float = 0.7,
    seed: int = 0,
    device: DeviceLike = DEFAULT_DEVICE,
) -> np.ndarray:
    """Inhomogeneous Poisson arrivals with daily + weekly structure.

    Sampled by thinning against the binned :func:`diurnal_rates` profile —
    exactly the rate function the streaming simulator sees.  Timestamps
    are float64 (see :func:`poisson_arrivals`); only the thinning
    probabilities go through the float32 profile on ``device``.
    """
    proc = diurnal_process(base_rate, peak_hour=peak_hour,
                           peak_to_trough=peak_to_trough,
                           weekend_factor=weekend_factor, device=device)
    duration = days * 86400.0
    lam_max = float(proc.peak_rate)
    rng = np.random.default_rng(seed)
    n = rng.poisson(lam_max * duration)
    t = np.sort(rng.random(n) * duration)
    rate = proc.rate_at(torch.as_tensor(t, dtype=torch.float32,
                                        device=proc.rates.device))
    keep = rng.random(n) < rate.cpu().numpy() / lam_max
    return t[keep]


def replay_process(timestamps: np.ndarray, *,
                   device: DeviceLike = DEFAULT_DEVICE,
                   dtype: torch.dtype = torch.float32) -> ArrivalProcess:
    """A measured (or folded) timestamp trace as an arrival process.

    The float64 timestamps reach `ArrivalProcess.from_trace` unrounded,
    which differences them on the host before any float32 conversion.
    """
    return ArrivalProcess.from_trace(timestamps, device=device, dtype=dtype)


def fold(timestamps: np.ndarray, window: float = WEEK_SECONDS
         ) -> tuple[np.ndarray, float]:
    """Paper Sec 4.2 folding: merge all windows; returns (folded, boost)."""
    folded = np.sort(np.mod(timestamps, window))
    duration = timestamps.max() - timestamps.min()
    return folded, float(np.ceil(duration / window))
