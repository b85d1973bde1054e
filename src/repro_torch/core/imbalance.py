"""Mechanistic model of per-query service-time imbalance (paper Sec 3.4).

PyTorch port of `repro.core.imbalance`.  The paper attributes imbalance
among *homogeneous* index servers to heterogeneous disk-cache behavior:
for a given query some servers find the needed inverted lists in the OS
page cache while others go to disk.  This module models that mechanism
analytically so the capacity planner can predict the (hit, S_hit,
S_miss, S_disk) decomposition of Eq 1 from first principles — term
popularity (Zipf), posting-list sizes, per-server memory, and the number
of servers p — instead of only from /proc measurements.

Cache model: Che's approximation for an LRU cache under the independent
reference model.  For object i with request rate lambda_i and size z_i, the
hit probability is  h_i = 1 - exp(-lambda_i * T_c)  where the
characteristic time T_c solves

    sum_i  z_i * (1 - exp(-lambda_i * T_c))  =  C        (cache bytes)

Document partitioning divides every posting list by p, so z_i(p) = z_i / p.

Everything runs in float32 on the geometry's device with no host sync.
Che's bisection sums over all terms at every step: on the card the sum
is taken in another order than on the CPU, so the two may part by a
bisection step at the boundary (the tests state the tolerance).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Union

import torch

from repro_torch.core import queueing

Tensor = torch.Tensor
TensorLike = Union[Tensor, float]

__all__ = [
    "CacheGeometry",
    "che_characteristic_time",
    "term_hit_probabilities",
    "query_full_hit_probability",
    "imbalance_probability",
    "service_params_from_cache_model",
    "service_time_cv",
]

_CHE_ITERS = 40


def _f32(x, like: Tensor) -> Tensor:
    return torch.as_tensor(x, device=like.device).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class CacheGeometry:
    """Inputs to the disk-cache model.

    term_rates:  (T,) per-term request rate (queries/sec * terms-per-query
                 share), i.e. Zipf-shaped popularity.
    list_bytes:  (T,) full (unpartitioned) inverted-list size per term.
    cache_bytes: per-server memory available to the OS page cache.
    p:           number of index servers (document partitioning => each
                 server stores list_bytes / p per term).
    disk_bw:     sustained disk read bandwidth, bytes/sec.
    disk_seek:   per-query seek+rotation overhead, seconds.
    """

    term_rates: Tensor
    list_bytes: Tensor
    cache_bytes: TensorLike
    p: TensorLike
    disk_bw: float = 50e6
    disk_seek: float = 8e-3


def che_characteristic_time(geom: CacheGeometry) -> Tensor:
    """Solve Che's fixed point for T_c by bisection (monotone in T_c)."""
    z = geom.list_bytes / _f32(geom.p, geom.list_bytes)
    lam = geom.term_rates
    cap = _f32(geom.cache_bytes, z)

    def filled(log_t):
        t = torch.exp(log_t)
        return torch.sum(z * (1.0 - torch.exp(-lam * t)))

    # Bisection in log space: cache fill is monotone increasing in T_c.
    lo = torch.full((), -20.0, dtype=torch.float32, device=z.device)
    hi = torch.full((), 25.0, dtype=torch.float32, device=z.device)
    for _ in range(_CHE_ITERS):
        mid = 0.5 * (lo + hi)
        too_big = filled(mid) > cap
        lo, hi = torch.where(too_big, lo, mid), torch.where(too_big, mid, hi)
    t_c = torch.exp(0.5 * (lo + hi))
    # If the whole (partitioned) working set fits in cache, T_c -> inf.
    return torch.where(torch.sum(z) <= cap, math.inf, t_c)


def term_hit_probabilities(geom: CacheGeometry) -> Tensor:
    """h_i = 1 - exp(-lambda_i T_c) per term."""
    t_c = che_characteristic_time(geom)
    h = 1.0 - torch.exp(-geom.term_rates * t_c)
    return torch.where(torch.isinf(t_c), torch.ones_like(h), h)


def _term_mask(query_terms: Tensor, lengths: Tensor) -> Tensor:
    return (torch.arange(query_terms.shape[1], device=query_terms.device
                         )[None, :] < lengths[:, None])


def query_full_hit_probability(
    geom: CacheGeometry, query_terms: Tensor, lengths: Tensor
) -> Tensor:
    """P(all lists for the query are cached) per query (Eq 1's ``hit``).

    query_terms: (Q, Lmax) padded term ids; lengths: (Q,) #valid terms.
    Terms are independent under the IRM, so the full-hit probability is the
    product of per-term hit probabilities.  Padding ids (-1) index the
    last term, as in the reference; the mask drops them.
    """
    h = term_hit_probabilities(geom)
    ht = h[query_terms.long()]  # (Q, Lmax)
    mask = _term_mask(query_terms, lengths)
    log_h = torch.where(mask, torch.log(torch.clamp_min(ht, 1e-30)), 0.0)
    return torch.exp(torch.sum(log_h, dim=1))


def imbalance_probability(hit_q: Tensor, p: TensorLike) -> Tensor:
    """P(servers split: some hit AND some miss) for one query.

    Under document partitioning each server's cache sees the same term
    stream with 1/p-size objects; treating per-server hits as independent
    Bernoulli(hit_q):  P_split = 1 - hit^p - (1-hit)^p.  This is the
    probability that the fork-join join actually pays the imbalance tax.
    """
    p = _f32(p, hit_q)
    return 1.0 - hit_q ** p - (1.0 - hit_q) ** p


def service_params_from_cache_model(
    geom: CacheGeometry,
    query_terms: Tensor,
    lengths: Tensor,
    *,
    cpu_per_entry: float = 20e-9,
    entry_bytes: float = 12.0,
    cpu_base: float = 2e-3,
) -> queueing.ServerParams:
    """Derive Eq 1 parameters (hit, S_hit, S_miss, S_disk) from the model.

    CPU time scales with the number of posting entries touched
    (intersection + ranking ~ linear pass over the shortest lists); disk
    time = seek + bytes_missed / disk_bw.  Constants are calibratable; the
    defaults land in the same regime as paper Table 5.
    """
    p = _f32(geom.p, geom.list_bytes)
    terms = query_terms.long()
    h_term = term_hit_probabilities(geom)
    hit_q = query_full_hit_probability(geom, query_terms, lengths)

    mask = _term_mask(query_terms, lengths)
    q_bytes = torch.where(mask, geom.list_bytes[terms] / p, 0.0)
    q_entries = q_bytes / entry_bytes

    # CPU time: linear in entries processed (both hit and miss paths).
    s_cpu_q = cpu_base + cpu_per_entry * torch.sum(q_entries, dim=1)
    hit = torch.mean(hit_q)
    w_hit = hit_q / torch.clamp_min(torch.sum(hit_q), 1e-9)
    w_miss = (1 - hit_q) / torch.clamp_min(torch.sum(1 - hit_q), 1e-9)
    s_hit = torch.sum(w_hit * s_cpu_q)
    s_miss = torch.sum(w_miss * s_cpu_q)

    # Disk bytes actually read: per term, missed with prob (1 - h_term).
    miss_bytes = torch.where(mask, (1.0 - h_term[terms]) * q_bytes, 0.0)
    bytes_per_miss_query = torch.sum(w_miss * torch.sum(miss_bytes, dim=1))
    s_disk = geom.disk_seek + bytes_per_miss_query / geom.disk_bw

    return queueing.ServerParams(
        p=p, s_broker=torch.zeros((), device=p.device), s_hit=s_hit,
        s_miss=s_miss, s_disk=s_disk, hit=hit)


def service_time_cv(params: queueing.ServerParams) -> Tensor:
    """Coefficient of variation of the per-server service time under Eq 1.

    Mixture of Exp(s_hit) w.p. hit and Exp(s_miss)+Exp(s_disk) w.p. 1-hit.
    CV near 1 supports the paper's exponential service-time finding; the
    hit/miss split is what spreads *per-query* times across servers.
    """
    hit = torch.as_tensor(params.hit)
    m_hit = torch.as_tensor(params.s_hit)
    a = torch.as_tensor(params.s_miss)
    b = torch.as_tensor(params.s_disk)
    m_miss = a + b
    mean = hit * m_hit + (1 - hit) * m_miss
    # a sum of two independent exponentials with means a, b has
    # E[(A+B)^2] = (a+b)^2 + a^2 + b^2
    ex2 = hit * 2.0 * m_hit**2 + (1 - hit) * ((a + b) ** 2 + a**2 + b**2)
    var = ex2 - mean**2
    return torch.sqrt(torch.clamp_min(var, 0.0)) / mean
