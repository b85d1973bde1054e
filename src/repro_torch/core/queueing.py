"""Queueing-network performance model for vertical search engines.

PyTorch port of `repro.core.queueing`: the analytical model of Badue et
al., "Capacity Planning for Vertical Search Engines" (2010), Section 5:

  * Eq 1 — index-server service time with disk-cache decomposition
  * Eq 2/4 — open-network MVA residence time (M/M/1):  R = S / (1 - lambda S)
  * Eq 3 — utilization U = lambda S
  * Eq 6 — Nelson-Tantawi fork-join upper bound: R_cluster <= H_p R_server
  * Eq 7 — two-sided bound on system response time
  * Eq 8 — application-level result-cache extension

Every function is elementwise torch and broadcasts over its inputs, so a
whole what-if grid evaluates in one pass.  Saturated operating points
(lambda S >= 1) return +inf.  Each takes ``device=`` / ``dtype=`` for
inputs given as Python numbers (see `repro_torch._tensor`).

The reference pins float32 in a few places even when the rest of a call
runs in float64 (`harmonic_number`, `mm1_residence_time`, Erlang C, the
quantile bound).  Those casts are mirrored exactly: the simulator builds
its histogram scale from these values, so a different cast would move
responses into different bins.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from repro_torch._tensor import DeviceLike, as_tensor, resolve

Tensor = torch.Tensor
TensorLike = Union[Tensor, float]

__all__ = [
    "ServerParams",
    "harmonic_number",
    "service_time_server",
    "mm1_residence_time",
    "utilization",
    "fork_join_lower_bound",
    "fork_join_upper_bound",
    "fork_join_interpolation",
    "response_time_bounds",
    "apply_result_cache",
    "response_time_with_result_cache",
    "saturation_rate",
    "expected_max_exponential",
    "response_time_quantile_upper",
]


@dataclasses.dataclass(frozen=True)
class ServerParams:
    """Model input parameters (paper Table 4).

    Times are in *seconds*.  Any field may be a Python number or a
    tensor; everything broadcasts.
    """

    p: TensorLike            # number of index servers
    s_broker: TensorLike     # broker CPU service time per query
    s_hit: TensorLike        # CPU time, full disk-cache hit
    s_miss: TensorLike       # CPU time, query touching disk
    s_disk: TensorLike       # disk time per query
    hit: TensorLike          # P(full disk-cache hit)

    def scale(self, *, memory=None, cpu: float = 1.0, disk: float = 1.0
              ) -> "ServerParams":
        """Apply a Section-6 style upgrade: CPU/disk `x times faster`.

        ``memory`` changes (s_hit, s_miss, s_disk, hit) jointly; callers
        pass re-measured parameters for that (see
        `repro_torch.core.capacity.MEMORY_TABLE`).
        """
        if memory is not None:
            raise ValueError(
                "memory upgrades require re-measured parameters; use "
                "capacity.scenario_params(memory=...) instead")
        return dataclasses.replace(
            self,
            s_broker=self.s_broker / cpu,
            s_hit=self.s_hit / cpu,
            s_miss=self.s_miss / cpu,
            s_disk=self.s_disk / disk,
        )


# XLA's digamma (the Lanczos form that `jax.scipy.special.digamma` lowers
# to).  `torch.special.digamma` is a different approximation: in float32
# it differs from the reference by an ulp or two at p = 8 and most other
# server counts, which shifts the simulator's histogram edges.
_LANCZOS_GAMMA = 7.0
_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS_COEFFS = (
    676.520368121885098567009190444019,
    -1259.13921672240287047156078755283,
    771.3234287776530788486528258894,
    -176.61502916214059906584551354,
    12.507343278686904814458936853,
    -0.13857109526572011689554707,
    9.984369578019570859563e-6,
    1.50563273514931155834e-7,
)
_EULER_GAMMA = 0.57721566490153286


def _digamma(x: Tensor) -> Tensor:
    """psi(x) by the Lanczos approximation, with reflection below 1/2."""
    reflect = x < 0.5
    z = torch.where(reflect, -x, x - 1.0)
    num = torch.zeros_like(x)
    den = torch.full_like(x, _LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS_COEFFS):
        zi = z + float(i + 1)
        coeff = torch.full_like(x, c)   # tensor / tensor: no reciprocal
        num = num - coeff / (zi * zi)
        den = den + coeff / zi
    g_half = _LANCZOS_GAMMA + 0.5
    t = g_half + z
    log_t = math.log(g_half) + torch.log1p(z / torch.full_like(x, g_half))
    y = log_t + num / den - torch.full_like(x, _LANCZOS_GAMMA) / t
    reduced = x + torch.abs(torch.floor(x + 0.5))
    reflection = y - math.pi * torch.cos(math.pi * reduced) / torch.sin(
        math.pi * reduced)
    out = torch.where(reflect, reflection, y)
    pole = (x <= 0.0) & (x == torch.floor(x))
    return torch.where(pole, torch.full_like(x, math.nan), out)


def harmonic_number(p: TensorLike, *, device: DeviceLike = None) -> Tensor:
    """H_p = 1 + 1/2 + ... + 1/p, valid for real p via digamma.

    H_p = digamma(p + 1) + gamma, computed in float32 as the reference
    does whatever the caller's dtype.
    """
    dev, _ = resolve(p, device=device)
    p = as_tensor(p, dev, torch.float32).to(torch.float32)
    return _digamma(p + 1.0) + _EULER_GAMMA


def expected_max_exponential(p: TensorLike, mean: TensorLike, *,
                             device: DeviceLike = None,
                             dtype: Optional[torch.dtype] = None) -> Tensor:
    """E[max of p iid Exp(mean)] = H_p * mean — the origin of Eq 6."""
    dev, dt = resolve(p, mean, device=device, dtype=dtype)
    return harmonic_number(p, device=dev) * as_tensor(mean, dev, dt)


def service_time_server(params: ServerParams, *, device: DeviceLike = None,
                        dtype: Optional[torch.dtype] = None) -> Tensor:
    """Eq 1:  S_server = hit*S_hit + (1-hit)*(S_miss + S_disk)."""
    dev, dt = resolve(params, device=device, dtype=dtype)
    hit = as_tensor(params.hit, dev, dt)
    return hit * as_tensor(params.s_hit, dev, dt) + (1.0 - hit) * (
        as_tensor(params.s_miss, dev, dt) + as_tensor(params.s_disk, dev, dt))


def utilization(lam: TensorLike, service_time: TensorLike, *,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Tensor:
    """Eq 3:  U = lambda * S."""
    dev, dt = resolve(lam, service_time, device=device, dtype=dtype)
    return as_tensor(lam, dev, dt) * as_tensor(service_time, dev, dt)


def mm1_residence_time(lam: TensorLike, service_time: TensorLike, *,
                       device: DeviceLike = None,
                       dtype: Optional[torch.dtype] = None) -> Tensor:
    """Eq 2/4:  R = S / (1 - lambda*S); +inf at/over saturation.

    ``S`` is cast to float32 as in the reference; ``lambda`` keeps its
    dtype, so a float64 rate gives a float64 result.
    """
    dev, dt = resolve(lam, service_time, device=device, dtype=dtype)
    s = as_tensor(service_time, dev, torch.float32).to(torch.float32)
    rho = as_tensor(lam, dev, dt) * s
    r = s / (1.0 - rho)
    return torch.where(rho < 1.0, r, math.inf)


def fork_join_lower_bound(lam: TensorLike, params: ServerParams, *,
                          device: DeviceLike = None,
                          dtype: Optional[torch.dtype] = None) -> Tensor:
    """Lower bound: ignore the join — R_cluster >= R_server (Sec 5.2.2)."""
    dev, dt = resolve(lam, params, device=device, dtype=dtype)
    return mm1_residence_time(
        lam, service_time_server(params, device=dev, dtype=dt),
        device=dev, dtype=dt)


def fork_join_upper_bound(lam: TensorLike, params: ServerParams, *,
                          device: DeviceLike = None,
                          dtype: Optional[torch.dtype] = None) -> Tensor:
    """Eq 6 (Nelson-Tantawi): R_cluster <= H_p * R_server."""
    dev, dt = resolve(lam, params, device=device, dtype=dtype)
    return harmonic_number(params.p, device=dev) * fork_join_lower_bound(
        lam, params, device=dev, dtype=dt)


def fork_join_interpolation(lam: TensorLike, params: ServerParams, *,
                            device: DeviceLike = None,
                            dtype: Optional[torch.dtype] = None) -> Tensor:
    """Utilization-weighted blend between the two Eq 7 sides.

    R_p ~= [H_p + rho (H_p - 1) / 2] / (1 + rho / 2) * R_server in spirit:
    exact at rho -> 0 (order statistics of service times only) and
    approaching H_p * R_server as rho -> 1; always inside Eq 7.  See the
    reference docstring for the derivation.
    """
    dev, dt = resolve(lam, params, device=device, dtype=dtype)
    lam = as_tensor(lam, dev, dt)
    s = service_time_server(params, device=dev, dtype=dt)
    rho = torch.clamp(lam * s, 0.0, 1.0 - 1e-6)
    hp = harmonic_number(params.p, device=dev)
    r1 = mm1_residence_time(lam, s)
    blend = rho
    return (1.0 - blend) * (hp * s + (r1 - s)) + blend * hp * r1


def broker_residence_time(lam: TensorLike, params: ServerParams, *,
                          device: DeviceLike = None,
                          dtype: Optional[torch.dtype] = None) -> Tensor:
    """Eq 4 applied to the broker."""
    dev, dt = resolve(lam, params, device=device, dtype=dtype)
    return mm1_residence_time(lam, params.s_broker, device=dev, dtype=dt)


def response_time_bounds(lam: TensorLike, params: ServerParams, *,
                         device: DeviceLike = None,
                         dtype: Optional[torch.dtype] = None
                         ) -> tuple[Tensor, Tensor]:
    """Eq 7:  (R_server + R_broker,  H_p R_server + R_broker)."""
    dev, dt = resolve(lam, params, device=device, dtype=dtype)
    r_broker = broker_residence_time(lam, params, device=dev, dtype=dt)
    lo = fork_join_lower_bound(lam, params, device=dev, dtype=dt) + r_broker
    hi = fork_join_upper_bound(lam, params, device=dev, dtype=dt) + r_broker
    return lo, hi


def apply_result_cache(
    response: TensorLike,
    lam: TensorLike,
    hit_result: TensorLike,
    s_broker_cache_hit: TensorLike,
    *,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> Tensor:
    """The Eq 8 blend, applicable to ANY response surface:

    R_cached = R * (1 - hit_r) + R_broker_cache * hit_r

    where R_broker_cache is the M/M/1 residence of the broker's cache
    queue at the full (un-thinned) arrival rate.
    """
    dev, dt = resolve(response, lam, hit_result, s_broker_cache_hit,
                      device=device, dtype=dtype)
    hit_r = as_tensor(hit_result, dev, dt)
    r_cache = mm1_residence_time(lam, s_broker_cache_hit, device=dev,
                                 dtype=dt)
    return as_tensor(response, dev, dt) * (1.0 - hit_r) + r_cache * hit_r


def response_time_with_result_cache(
    lam: TensorLike,
    params: ServerParams,
    hit_result: TensorLike,
    s_broker_cache_hit: TensorLike,
    *,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> Tensor:
    """Eq 8: upper bound with application-level result caching at the broker.

    R <= (H_p R_server + R_broker) (1 - hit_r) + R_broker_cache * hit_r
    """
    dev, dt = resolve(lam, params, hit_result, s_broker_cache_hit,
                      device=device, dtype=dtype)
    _, hi = response_time_bounds(lam, params, device=dev, dtype=dt)
    return apply_result_cache(hi, lam, hit_result, s_broker_cache_hit,
                              device=dev, dtype=dt)


def saturation_rate(params: ServerParams, *, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Tensor:
    """Largest sustainable lambda: min(1/S_server, 1/S_broker)."""
    dev, dt = resolve(params, device=device, dtype=dtype)
    s = service_time_server(params, device=dev, dtype=dt)
    return torch.minimum(1.0 / s, 1.0 / as_tensor(params.s_broker, dev, dt))


def erlang_c(lam: TensorLike, service_time: TensorLike, c: int, *,
             device: DeviceLike = None) -> Tensor:
    """M/M/c waiting probability (Erlang C), in float32.  Stable iff
    lam * S < c."""
    dev, _ = resolve(lam, service_time, device=device)
    lam = as_tensor(lam, dev, torch.float32).to(torch.float32)
    s = as_tensor(service_time, dev, torch.float32).to(torch.float32)
    a = lam * s                       # offered load (erlangs)
    rho = a / c
    terms = [torch.ones_like(a)]
    for k in range(1, c):
        terms.append(terms[-1] * a / k)
    s0 = sum(terms)
    top = terms[-1] * a / c / torch.clamp_min(1.0 - rho, 1e-9)
    pw = top / (s0 + top)
    return torch.where(rho < 1.0, pw, torch.ones_like(pw))


def mmc_residence_time(lam: TensorLike, service_time: TensorLike, c: int,
                       *, device: DeviceLike = None) -> Tensor:
    """M/M/c mean response: S + P_wait * S / (c - lam*S)."""
    dev, _ = resolve(lam, service_time, device=device)
    lam = as_tensor(lam, dev, torch.float32).to(torch.float32)
    s = as_tensor(service_time, dev, torch.float32).to(torch.float32)
    pw = erlang_c(lam, s, c)
    w = pw * s / torch.clamp_min(c - lam * s, 1e-9)
    return torch.where(lam * s < c, s + w, math.inf)


def response_time_bounds_mmc(lam: TensorLike, params: ServerParams,
                             threads: int, *, device: DeviceLike = None,
                             dtype: Optional[torch.dtype] = None
                             ) -> tuple[Tensor, Tensor]:
    """Eq 7 with multi-threaded index servers (M/M/c per server)."""
    dev, dt = resolve(lam, params, device=device, dtype=dtype)
    s = service_time_server(params, device=dev, dtype=dt)
    r_server = mmc_residence_time(as_tensor(lam, dev, dt), s, threads)
    r_broker = mm1_residence_time(lam, params.s_broker, device=dev,
                                  dtype=dt)
    lo = r_server + r_broker
    hi = harmonic_number(params.p, device=dev) * r_server + r_broker
    return lo, hi


def two_phase_response_upper(
    lam: TensorLike,
    params: ServerParams,
    *,
    s_docserver: TensorLike,
    p_docservers: TensorLike,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> Tensor:
    """Both query phases (paper Sec 1): index retrieval + a second
    fork-join stage of M/M/1 document servers, H_{p_doc}-bounded."""
    dev, dt = resolve(lam, params, s_docserver, p_docservers,
                      device=device, dtype=dtype)
    _, hi1 = response_time_bounds(lam, params, device=dev, dtype=dt)
    r_doc = mm1_residence_time(lam, s_docserver, device=dev, dtype=dt)
    return hi1 + harmonic_number(p_docservers, device=dev) * r_doc


def response_time_quantile_upper(
    lam: TensorLike, params: ServerParams, q: TensorLike, *,
    device: DeviceLike = None, dtype: Optional[torch.dtype] = None,
) -> Tensor:
    """q-percentile upper estimate (paper Sec 7 'future work').

    The cluster residence is the max of p iid exponentials with mean
    R_server, t_q = -R * ln(1 - q^(1/p)); the broker adds its M/M/1
    q-quantile.
    """
    dev, dt = resolve(lam, params, q, device=device, dtype=dtype)
    q = as_tensor(q, dev, torch.float32).to(torch.float32)
    r_server = fork_join_lower_bound(lam, params, device=dev, dtype=dt)
    p = as_tensor(params.p, dev, torch.float32).to(torch.float32)
    t_cluster = -r_server * torch.log1p(-torch.pow(q, 1.0 / p))
    r_broker = broker_residence_time(lam, params, device=dev, dtype=dt)
    t_broker = -r_broker * torch.log1p(-q)
    return t_cluster + t_broker
