"""Plain reference of the replicated fork-join network (paper Fig 8, Sec 6).

One dispatcher routes each query to one of r replicas (round-robin,
random thinning or join-shortest-queue on a fluid backlog tracker).
With the Eq 8 result cache, a hit is served by its replica's cache queue
(FCFS, Exp(s_cache)) and a miss by its replica's broker (FCFS) and then,
forked, by all p index servers (FCFS each); the response is the join
(the slowest server) minus the arrival.  Service times follow the Sec
3.4 hit / miss / disk mixture, or are exponential with the Eq 1 mean.

Every FCFS queue is the Lindley recurrence C_i = max(A_i, C_{i-1}) +
S_i, evaluated in closed form, C_i = B_i + max(c, max_{j<=i}(A_j + S_j
- B_j)) with B the running sum of the services and c the carry from
the previous chunk.  Each replica's queues run over the whole chunk,
with zero service for queries that are not theirs: such an entry never
delays a later one, because arrivals are in order.  Clocks restart at
each chunk's last arrival.  The statistics are the program's
definitions: the mean over post-warm-up queries and the q-quantile of
the log-spaced histogram whose span is set from the Eq 7 bound.

The arithmetic runs in ``dtype`` (float64 for the reference; a lower
precision is the control).  The one exception is the JSQ dispatcher's
backlog tracker, which runs in ``route_dtype``, the precision the
configuration states (float32): a routing choice is a discontinuous
function of the tracker, so trackers rounded differently part at near
ties, and from there the two sides simulate two different sample paths
(at full size, gaps of 10^-4-10^-3 in the mean that say nothing of
either side's precision).  Inputs are the float32 tensors the program
gets; the variates come from `rng_plan`.  A configuration's faults
(`faulted`) change the routing, the services and the join, and add
three counts.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import faulted, rng_plan

Tensor = torch.Tensor

_HIST_DECADES_BELOW = 3.0
_HIST_DECADES_TOTAL = 6.0


def lindley(arrivals: Tensor, services: Tensor, carry: Tensor) -> Tensor:
    """FCFS completion times along the last axis, after prior work that
    completes at ``carry`` (broadcasting against the leading axes)."""
    arrivals = arrivals.expand(services.shape)
    b = torch.cumsum(services, dim=-1)
    head = torch.cummax(arrivals + services - b, dim=-1).values
    return b + torch.maximum(head, carry[..., None])


def jsq_assign(w: Tensor, gaps: Tensor, services: Tensor, live: Tensor
               ) -> tuple[Tensor, Tensor]:
    """Join-shortest-queue, one query at a time.

    ``w`` (S, r, p) is each replica server's remaining work at the
    previous arrival.  Per query: drain every tracker by the gap, choose
    the replica whose slowest server frees first (lowest index on a
    tie), add the query's per-server services (times ``live``: a cache
    hit adds nothing) to it.  Returns ((S, n) choices, the tracker).
    """
    n_scen, r, p = w.shape
    w = w.clone()
    dep = (services * live[:, None, :]).permute(2, 0, 1).contiguous()
    choices = torch.empty(gaps.shape, dtype=torch.int64, device=w.device)
    gaps_t = gaps.t().contiguous()
    for i in range(gaps.shape[-1]):
        w.sub_(gaps_t[i][:, None, None]).clamp_(min=0.0)
        choice = torch.argmin(torch.amax(w, dim=-1), dim=-1)
        w.scatter_add_(1, choice.view(n_scen, 1, 1).expand(n_scen, 1, p),
                       dep[i][:, None, :])
        choices[:, i] = choice
    return choices, w


def services(v: dict, fields: dict, mode: str, dt: torch.dtype) -> Tensor:
    """(S, p, chunk) service times in ``dt`` from the chunk's variates:
    the Sec 3.4 mixture (a hit with probability ``hit``: Exp(s_hit);
    else Exp(s_miss) + Exp(s_disk)) or Exp(S_server) (Eq 1's mean)."""
    def per(k):
        return fields[k].to(dt)[:, None, None]

    if mode == "cache":
        return torch.where(v["hit_u"].to(dt) < per("hit"),
                           v["hit_e"].to(dt) * per("s_hit"),
                           v["miss_e"].to(dt) * per("s_miss")
                           + v["disk_e"].to(dt) * per("s_disk"))
    mean = per("hit") * per("s_hit") + (1.0 - per("hit")) * (
        per("s_miss") + per("s_disk"))
    return v["server"].to(dt) * mean


def harmonic(p: int) -> float:
    return math.fsum(1.0 / k for k in range(1, p + 1))


def hist_scale(lam: Tensor, fields: dict, *, p: int, r: int,
               hit_r: float) -> Tensor:
    """The histogram's centre: the Eq 7 upper bound at the per-replica
    miss rate, H_p R_server + R_broker (100 S_server past saturation)."""
    s = fields["hit"] * fields["s_hit"] + (1.0 - fields["hit"]) * (
        fields["s_miss"] + fields["s_disk"])
    rate = lam * (1.0 - hit_r) / r

    def mm1(svc):
        rho = rate * svc
        return torch.where(rho < 1.0, svc / (1.0 - rho), math.inf)

    hi = harmonic(p) * mm1(s) + mm1(fields["s_broker"])
    return torch.where(torch.isfinite(hi) & (hi > 0), hi, 100.0 * s)


def hist_quantile(hist: Tensor, count: Tensor, log_lo: Tensor,
                  log_step: Tensor, q: float) -> Tensor:
    """q-quantile of a log histogram, log-linear inside the bin."""
    n_bins = hist.shape[-1]
    cum = torch.cumsum(hist, dim=-1)
    target = q * count
    k = torch.clamp(torch.sum(cum < target[:, None], dim=-1), 0, n_bins - 1)
    before = torch.where(
        k > 0, torch.gather(cum, -1, torch.clamp_min(k - 1, 0)[:, None])[:, 0],
        0.0)
    in_bin = torch.gather(hist, -1, k[:, None])[:, 0]
    frac = torch.clamp((target - before) / torch.clamp_min(in_bin, 1.0),
                       0.0, 1.0)
    return torch.exp(log_lo + (k + frac) * log_step)


def simulate(seed: int, lam: Tensor, fields: dict, *, p: int,
             n_queries: int, chunk: int, warmup_fraction: float,
             hist_bins: int, quantile: float, mode: str, r: int = 1,
             routing: str = "round_robin", result_cache=None,
             fault: dict | None = None,
             dtype: torch.dtype = torch.float64,
             route_dtype: torch.dtype = torch.float32) -> dict:
    """Mean, q-quantile and count of the response per scenario.

    ``lam`` (S,) and every ``fields`` value (S,) are the program's float32
    inputs, on the device the program ran on (the variates depend on
    it).  ``result_cache`` is (hit_r, s_cache) or None.  ``route_dtype``
    is the JSQ tracker's precision (see the module docstring).  ``fault``
    is a configuration's six fault keys (`faulted`), under JSQ over two
    or more replicas.  Returns (S,) tensors ``mean``, ``quantile`` (in
    ``dtype``) and ``count``, and with ``fault`` ``degraded_count``,
    ``spill_count`` and ``unavail_count``.
    """
    if fault is not None and (routing != "jsq" or r < 2):
        raise ValueError("the faulted reference routes by jsq over two or "
                         f"more replicas; got {routing!r}, r = {r}")
    dev = lam.device
    dt = dtype
    n_scen = lam.shape[0]
    lam_d = lam.to(dt)
    f = {k: v.to(dt) for k, v in fields.items()}
    hit_r = 0.0 if result_cache is None else float(result_cache[0])
    n_chunks = -(-n_queries // chunk)
    n_warm = int(n_queries * warmup_fraction)
    random_route = r > 1 and routing == "random"
    scale = hist_scale(lam_d, f, p=p, r=r, hit_r=hit_r)
    log_lo = torch.log(scale) - _HIST_DECADES_BELOW * math.log(10.0)
    log_step = torch.full_like(log_lo, _HIST_DECADES_TOTAL * math.log(10.0)
                               / hist_bins)

    def zeros(*shape):
        return torch.zeros((n_scen,) + shape, dtype=dt, device=dev)

    c_cache, c_brk, c_srv = zeros(r), zeros(r), zeros(r, p)
    w_jsq = torch.zeros((n_scen, r, p), dtype=route_dtype, device=dev)
    total = zeros()
    count = torch.zeros(n_scen, dtype=torch.int64, device=dev)
    hist = zeros(hist_bins)
    col = torch.arange(chunk, device=dev)
    if fault is not None:
        chain = torch.ones((n_scen, r), dtype=torch.bool, device=dev)
        clock = torch.zeros(n_scen, dtype=route_dtype, device=dev)
        tallies = {key: torch.zeros(n_scen, dtype=torch.int64, device=dev)
                   for key in faulted.COUNTS}
    for c_idx in range(n_chunks):
        v = rng_plan.chunk_variates(
            seed, c_idx, n_scen=n_scen, chunk=chunk, p=p, mode=mode,
            route_r=r if random_route else None,
            result_cache=result_cache is not None, device=dev,
            fault_r=None if fault is None else r)
        gaps = v["gap"].to(dt) / lam_d[:, None]
        arr = torch.cumsum(gaps, dim=-1)
        s_brk = v["broker"].to(dt) * f["s_broker"][:, None]
        svc = services(v, fields, mode, dt)
        if fault is not None:
            svc = faulted.slowed(svc, fault)
        if result_cache is not None:
            is_hit = v["cache_u"].to(dt) < torch.tensor(hit_r, dtype=dt)
            t_cache = v["cache_e"].to(dt) * float(result_cache[1])
        else:
            is_hit = torch.zeros((n_scen, chunk), dtype=torch.bool,
                                 device=dev)
        live = (~is_hit).to(dt)
        gidx = col + c_idx * chunk

        if r == 1:
            assign = torch.zeros((n_scen, chunk), dtype=torch.int64,
                                 device=dev)
        elif routing == "round_robin":
            assign = (gidx % r)[None, :].expand(n_scen, chunk)
        elif routing == "random":
            assign = v["route"]
        elif routing == "jsq" and fault is None:
            rd = route_dtype
            assign, w_jsq = jsq_assign(
                w_jsq, v["gap"].to(rd) / lam.to(rd)[:, None],
                services(v, fields, mode, rd), live.to(rd))
        elif routing == "jsq":
            rd = route_dtype
            gaps_rd = v["gap"].to(rd) / lam.to(rd)[:, None]
            arr_rd = torch.cumsum(gaps_rd, dim=-1)
            assign, w_jsq, chain, spill_q, unav_q = faulted.jsq_faulted(
                w_jsq, chain, gaps_rd,
                faulted.slowed(services(v, fields, mode, rd), fault),
                live.to(rd),
                faulted.window_up(fault, r, clock[:, None] + arr_rd),
                v["fault_u"].to(rd), mtbf=float(fault["mtbf_seconds"]),
                mttr=float(fault["mttr_seconds"]))
            clock = clock + arr_rd[:, -1]
            degr_q = torch.zeros((n_scen, chunk), dtype=torch.bool,
                                 device=dev)
        else:
            raise ValueError(f"no reference for routing {routing!r}")

        response = torch.zeros((n_scen, chunk), dtype=dt, device=dev)
        for k in range(r):
            mine = assign == k
            miss_k = (mine & ~is_hit).to(dt)
            if result_cache is not None:
                cache_done = lindley(arr, t_cache * (mine & is_hit).to(dt),
                                     c_cache[:, k])
                c_cache[:, k] = cache_done[:, -1]
            brk_done = lindley(arr, s_brk * miss_k, c_brk[:, k])
            srv_done = lindley(brk_done[:, None, :], svc * miss_k[:, None, :],
                               c_srv[:, k, :])
            c_brk[:, k] = brk_done[:, -1]
            c_srv[:, k, :] = srv_done[:, :, -1]
            if fault is None:
                resp_k = torch.amax(srv_done, dim=1) - arr
            else:
                join, late = faulted.quorum_join(
                    srv_done, brk_done, k=int(fault["quorum_k"]),
                    timeout=float(fault["broker_timeout_seconds"]))
                resp_k = join - arr
                degr_q = torch.where(mine, late & ~is_hit, degr_q)
            del srv_done
            if result_cache is not None:
                resp_k = torch.where(is_hit, cache_done - arr, resp_k)
            response = torch.where(mine, resp_k, response)

        shift = arr[:, -1]
        c_cache = c_cache - shift[:, None]
        c_brk = c_brk - shift[:, None]
        c_srv = c_srv - shift[:, None, None]

        valid = (gidx >= n_warm) & (gidx < n_queries)
        vf = valid.to(dt)[None, :]
        total = total + torch.sum(response * vf, dim=-1)
        count = count + int(valid.sum())
        if fault is not None:
            for key, flags in zip(faulted.COUNTS, (degr_q, spill_q, unav_q)):
                tallies[key] = tallies[key] + torch.sum(flags & valid, dim=-1)
        bins = torch.clamp(torch.floor(
            (torch.log(torch.clamp_min(response, 1e-30)) - log_lo[:, None])
            / log_step[:, None]), 0, hist_bins - 1).to(torch.int64)
        hist = hist.scatter_add(1, bins, vf.expand(n_scen, chunk))
    cnt = count.to(dt)
    return {"mean": total / torch.clamp_min(cnt, 1.0),
            "quantile": hist_quantile(hist, cnt, log_lo, log_step, quantile),
            "count": count, **({} if fault is None else tallies)}
