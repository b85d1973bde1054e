"""Workload characterization (paper Section 4).

PyTorch port of `repro.core.workload`.  Five distribution families
exactly as evaluated in the paper — Exponential, Gamma, Weibull,
Lognormal, Pareto — with MLE fitting, their CDFs, and the paper's two
goodness-of-fit criteria (sum of squared differences between empirical
and model CDFs, and the Kolmogorov-Smirnov statistic).

Plus: Zipf popularity sampling/fitting (Fig 2) and the log *folding*
procedure (Sec 4.2) that boosts a dataset's arrival rate while preserving
its distributional shape.

Everything runs on the samples' device with no host sync: the fits use
fixed-iteration Newton steps (no data-dependent Python control flow).
The gamma fit's digamma is XLA's form (`repro_torch.core.queueing`);
the Weibull fit differentiates its shape equation with `torch.func.grad`.
Random draws take an integer seed or a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Union

import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.core.queueing import _digamma

Tensor = torch.Tensor
Seed = Union[int, torch.Generator]

__all__ = [
    "DistFit",
    "fit_exponential",
    "fit_gamma",
    "fit_weibull",
    "fit_lognormal",
    "fit_pareto",
    "fit_all",
    "ks_statistic",
    "ssq_statistic",
    "best_fit",
    "zipf_probs",
    "sample_zipf",
    "fit_zipf_alpha",
    "rank_frequencies",
    "fold_timestamps",
    "sample_poisson_arrivals",
    "empirical_cdf_points",
]

_NEWTON_ITERS = 25


def _generator(seed: Seed, device: DeviceLike) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _f32(x) -> Tensor:
    """float32, as the reference's ``asarray(x, float32)``."""
    return torch.as_tensor(x).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class DistFit:
    """A fitted distribution: name, parameter tensors, and its CDF."""

    name: str
    params: Dict[str, Tensor]
    cdf: Callable[[Tensor], Tensor] = dataclasses.field(compare=False)

    def __repr__(self) -> str:  # params as floats for readability
        p = {k: float(v) for k, v in self.params.items()}
        return f"DistFit({self.name}, {p})"


# --------------------------------------------------------------------------
# MLE fits. Each returns a DistFit whose cdf closes over fitted params.
# --------------------------------------------------------------------------

def fit_exponential(x: Tensor) -> DistFit:
    """f(t) = (1/mu) exp(-t/mu); MLE mu = mean (paper footnote 6)."""
    mu = torch.mean(x)
    return DistFit("exponential", {"mu": mu},
                   lambda t: 1.0 - torch.exp(-t / mu))


def fit_gamma(x: Tensor) -> DistFit:
    """Gamma(k, theta) via Newton on  ln k - psi(k) = s."""
    x = _f32(x)
    mean = torch.mean(x)
    s = torch.log(mean) - torch.mean(torch.log(x))
    s = torch.clamp_min(s, 1e-6)
    k = (3.0 - s + torch.sqrt((s - 3.0) ** 2 + 24.0 * s)) / (12.0 * s)
    for _ in range(_NEWTON_ITERS):
        f = torch.log(k) - _digamma(k) - s
        fp = 1.0 / k - torch.special.polygamma(1, k)
        k = torch.clamp(k - f / fp, 1e-4, 1e6)
    theta = mean / k
    return DistFit(
        "gamma", {"k": k, "theta": theta},
        lambda t: torch.special.gammainc(k, torch.clamp_min(t, 0.0) / theta))


def fit_weibull(x: Tensor) -> DistFit:
    """Weibull(k, lam) via Newton on the profile-likelihood shape equation."""
    x = _f32(x)
    lx = torch.log(x)
    mlx = torch.mean(lx)
    lx_max = torch.amax(lx)

    def g(k):
        # numerically stable weighted means of log x under weights x^k
        w = torch.exp(k * (lx - lx_max))
        sw = torch.sum(w)
        return torch.sum(w * lx) / sw - 1.0 / k - mlx

    dg = torch.func.grad(g)
    k = torch.ones((), dtype=torch.float32, device=x.device)
    for _ in range(_NEWTON_ITERS):
        k = torch.clamp(k - g(k) / dg(k), 1e-3, 1e3)
    lam = torch.mean(x ** k) ** (1.0 / k)
    return DistFit(
        "weibull", {"k": k, "lam": lam},
        lambda t: 1.0 - torch.exp(-torch.clamp_min(t / lam, 0.0) ** k))


def fit_lognormal(x: Tensor) -> DistFit:
    lx = torch.log(_f32(x))
    mu = torch.mean(lx)
    sigma = torch.clamp_min(torch.std(lx, correction=0), 1e-6)
    return DistFit(
        "lognormal", {"mu": mu, "sigma": sigma},
        lambda t: 0.5 * (1.0 + torch.erf(
            (torch.log(torch.clamp_min(t, 1e-30)) - mu)
            / (sigma * math.sqrt(2.0)))))


def fit_pareto(x: Tensor) -> DistFit:
    """Pareto(x_m, alpha), x_m = min(x); MLE alpha = n / sum ln(x/x_m)."""
    x = _f32(x)
    xm = torch.amin(x)
    alpha = x.shape[0] / torch.clamp_min(torch.sum(torch.log(x / xm)), 1e-6)
    return DistFit(
        "pareto", {"xm": xm, "alpha": alpha},
        lambda t: torch.where(
            t >= xm, 1.0 - (xm / torch.maximum(t, xm)) ** alpha, 0.0))


def fit_all(x: Tensor) -> Dict[str, DistFit]:
    """All five families of Sec 4.2/4.3."""
    return {
        f.name: f
        for f in (fit_exponential(x), fit_gamma(x), fit_weibull(x),
                  fit_lognormal(x), fit_pareto(x))
    }


# --------------------------------------------------------------------------
# Goodness of fit (paper Sec 4.2): SSQ of CDF differences + KS statistic.
# --------------------------------------------------------------------------

def empirical_cdf_points(x: Tensor) -> tuple[Tensor, Tensor]:
    xs = torch.sort(x).values
    n = xs.shape[0]
    ecdf = torch.arange(1, n + 1, dtype=torch.float32, device=x.device) / n
    return xs, ecdf


def ks_statistic(x: Tensor, fit: DistFit) -> Tensor:
    """Kolmogorov-Smirnov D = sup |F_emp - F_model| over the sample."""
    xs = torch.sort(x).values
    n = xs.shape[0]
    f = fit.cdf(xs)
    hi = torch.arange(1, n + 1, dtype=torch.float32, device=x.device) / n
    lo = torch.arange(0, n, dtype=torch.float32, device=x.device) / n
    return torch.maximum(torch.amax(torch.abs(f - hi)),
                         torch.amax(torch.abs(f - lo)))


def ssq_statistic(x: Tensor, fit: DistFit) -> Tensor:
    """Sum of squared differences between the empirical and model CDFs."""
    xs, ecdf = empirical_cdf_points(x)
    return torch.sum((fit.cdf(xs) - ecdf) ** 2)


def best_fit(x: Tensor, criterion: str = "ks"
             ) -> tuple[str, Dict[str, Tensor]]:
    """Name + per-family statistic; lowest statistic wins."""
    stat = ks_statistic if criterion == "ks" else ssq_statistic
    fits = fit_all(x)
    stats = {name: stat(x, f) for name, f in fits.items()}
    winner = min(stats, key=lambda k: float(stats[k]))
    return winner, stats


# --------------------------------------------------------------------------
# Zipf popularity (paper Fig 2): Prob(E_n) ∝ n^-alpha.
# --------------------------------------------------------------------------

def zipf_probs(n_elements: int, alpha: float, *,
               device: DeviceLike = DEFAULT_DEVICE) -> Tensor:
    ranks = torch.arange(1, n_elements + 1, dtype=torch.float32,
                         device=device)
    w = ranks ** (-alpha)
    return w / torch.sum(w)


def sample_zipf(seed: Seed, n_elements: int, alpha: float, shape, *,
                device: DeviceLike = DEFAULT_DEVICE) -> Tensor:
    """Inverse-CDF sampling of Zipf ranks (0-based element ids)."""
    cdf = torch.cumsum(zipf_probs(n_elements, alpha, device=device), dim=0)
    u = torch.rand(shape, generator=_generator(seed, device), device=device)
    return torch.searchsorted(cdf, u).to(torch.int32)


def rank_frequencies(ids: Tensor, n_elements: int) -> Tensor:
    """Frequency of each element, sorted descending (rank-frequency curve)."""
    counts = torch.bincount(ids.reshape(-1).long(), minlength=n_elements)
    return torch.sort(counts.to(torch.int32), descending=True).values


def fit_zipf_alpha(freqs_desc: Tensor, min_count: int = 5) -> Tensor:
    """Slope of the log-log rank-frequency line (paper's fitting method).

    Weighted least squares over ranks whose count >= min_count (the deep
    tail of 1-count elements otherwise biases the slope).
    """
    n = freqs_desc.shape[0]
    ranks = torch.arange(1, n + 1, dtype=torch.float32,
                         device=freqs_desc.device)
    mask = (freqs_desc >= min_count).to(torch.float32)
    x = torch.log(ranks)
    y = torch.log(torch.clamp_min(freqs_desc.to(torch.float32), 1e-9))
    w = mask / torch.clamp_min(torch.sum(mask), 1.0)
    xm = torch.sum(w * x)
    ym = torch.sum(w * y)
    slope = torch.sum(w * (x - xm) * (y - ym)) / torch.clamp_min(
        torch.sum(w * (x - xm) ** 2), 1e-9)
    return -slope  # alpha


# --------------------------------------------------------------------------
# Folding (paper Sec 4.2) and Poisson arrival synthesis.
# --------------------------------------------------------------------------

def fold_timestamps(timestamps: Tensor, window: float
                    ) -> tuple[Tensor, Tensor]:
    """Fold arrivals modulo ``window`` and sort.

    Returns (folded_sorted_timestamps, boost_factor) where boost_factor is
    the arrival-rate multiplier = ceil(duration / window) merged windows.
    """
    t = torch.as_tensor(timestamps)
    folded = torch.sort(torch.remainder(t, window)).values
    duration = torch.amax(t) - torch.amin(t)
    boost = torch.ceil(duration / window)
    return folded, boost


def sample_poisson_arrivals(seed: Seed, lam: float, n: int, *,
                            device: DeviceLike = DEFAULT_DEVICE) -> Tensor:
    """n arrival timestamps of a rate-lam Poisson process (cumsum of Exp)."""
    gaps = torch.empty((n,), device=device).exponential_(
        generator=_generator(seed, device)) / lam
    return torch.cumsum(gaps, dim=0)
