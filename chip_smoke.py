#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout's sources (the
(max,+) scan, the segmented (max,+) scan and the JSQ router, one nvcc
each, in parallel), holds each against its plain PyTorch version on the
card, and drives the port's two paths over Table 6's 100-server case
study, 64 scenarios: the single-replica engine (phases 3-4) and the
replicated cluster, r = 4 with the result cache, under random and JSQ
routing (phases 6-7).  It checks the answers against the Eq 7 bounds and
against the plain path, and prints timings beside the card's name and
power limit.  Any failed check raises (non-zero exit).  The last lines
are the kernel report (JSON), the card, and the device line (JSON).

Needs a CUDA device and nvcc; it refuses to run anywhere else.  Imports
torch and repro_torch only.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM, non-tensor float32
N_SCEN, P, CHUNK, N_CHUNKS = 64, 100, 4096, 25   # Table 6, full width
TIMED_SHAPE = (N_SCEN * P, CHUNK)   # the server scan: 64 scenarios x p
N_TIMED = 50
R = 4                           # replicas of the replicated path
RESULT_CACHE = (0.2, 2e-3)      # (hit_r, s_cache), as replicated_bench.py
MAX_BUFFERS_PER_R = 10.0        # the reference's r-free memory allowance


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _inputs(shape, dtype, gen):
    import torch
    arr = torch.empty(shape, dtype=dtype, device="cuda").exponential_(
        generator=gen).cumsum(-1)
    svc = torch.empty(shape, dtype=dtype, device="cuda").exponential_(
        generator=gen)
    carry = torch.rand(shape[:-1], dtype=dtype, device="cuda",
                       generator=gen) * 50.0
    return arr + svc, svc, carry


def _rel_err(x, y) -> float:
    return float(((x - y).abs() / y.abs().clamp_min(1e-30)).max())


def _time_ms(fn, n: int = N_TIMED, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _wall(run) -> float:
    """Host wall seconds of ``run()`` through to a device sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _reset_counts() -> None:
    from repro_torch.kernels.jsq_route import ops as jsq_ops
    from repro_torch.kernels.maxplus_scan import ops
    ops.reset_launch_count()
    ops.reset_segment_launch_count()
    jsq_ops.reset_launch_count()


def _counts() -> dict:
    from repro_torch.kernels.jsq_route import ops as jsq_ops
    from repro_torch.kernels.maxplus_scan import ops
    return {"maxplus_scan": ops.launch_count(),
            "maxplus_segment_scan": ops.segment_launch_count(),
            "jsq_route": jsq_ops.launch_count()}


def phase_device():
    import torch
    from repro_torch.kernels.jsq_route import kernel as jsq_kernel
    from repro_torch.kernels.maxplus_scan import kernel
    card = _card()
    print("== phase 1: device and kernel builds")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}; "
          f"count {torch.cuda.device_count()}")
    libs = (kernel.SCAN_LIB, kernel.SEGMENT_LIB, jsq_kernel.LIB)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs))   # raises on failure
    print(f"{len(libs)} libraries built+loaded in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(f"-- {lib.name}: nvcc {lib.build_seconds} s")
        print(lib.build_log.strip() or "(library found in the build cache)")
    return card


def phase_kernel(card: str) -> dict:
    """The kernel against its plain version, then timings at TIMED_SHAPE."""
    import torch
    from repro_torch.kernels.maxplus_scan import kernel, ops
    print("== phase 2: kernel vs plain version on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = 0.0
    shapes = [TIMED_SHAPE, (N_SCEN, CHUNK), (37, 1000), (3, 5, 777)]
    for shape, dtype, seeded in itertools.product(
            shapes, (torch.float32, torch.float64), (False, True)):
        rtol = 1e-5 if dtype == torch.float32 else 1e-12
        a, b, carry = _inputs(shape, dtype, gen)
        if seeded:
            args = (a, b, carry, 0.1 * carry)
            ka, kb = ops.maxplus_scan_seeded(*args, impl="cuda")
            pa, pb = ops.maxplus_scan_seeded(*args, impl="torch")
        else:
            ka, kb = ops.maxplus_scan(a, b, impl="cuda")
            pa, pb = ops.maxplus_scan(a, b, impl="torch")
        torch.cuda.synchronize()
        err = max(_rel_err(ka, pa), _rel_err(kb, pb))
        abs_err = float(max((ka - pa).abs().max(), (kb - pb).abs().max()))
        print(f"  {str(shape):14s} {str(dtype):14s} seeded={seeded!s:5s} "
              f"max rel err {err:.3e} max abs err {abs_err:.3e} "
              f"(rtol {rtol:g})")
        if not err <= rtol:
            raise AssertionError(f"kernel disagrees with the plain scan at "
                                 f"{shape} {dtype}: {err} > {rtol}")
        if shape == TIMED_SHAPE and dtype == torch.float32:
            main_err = max(main_err, abs_err)

    a, b, carry = _inputs(TIMED_SHAPE, torch.float32, gen)
    ms = _time_ms(lambda: kernel.maxplus_scan_cuda(a, b, carry))
    plain_ms = _time_ms(lambda: ops.maxplus_scan_seeded(a, b, carry,
                                                        impl="torch"))

    def yardstick():             # timed only; the port never calls it
        big_b = torch.cumsum(b, -1)
        return big_b + torch.cummax(a - big_b, -1).values
    library_ms = _time_ms(yardstick)
    rows, length = TIMED_SHAPE
    moved = rows * length * 4 * a.element_size()    # a, b in; out_a, out_b
    ops_ms = rows * length * 3 / FP32_OPS_PER_S * 1e3   # add, add, max
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"  at {TIMED_SHAPE} float32, mean of {N_TIMED} launches "
          f"[{card}]:")
    print(f"    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  yardstick "
          f"(cumsum+cummax) {library_ms:.4f} ms  bound {bound_ms:.4f} ms "
          f"({moved / 1e6:.1f} MB at 3.35 TB/s); kernel at "
          f"{moved / (ms * 1e-3) / 1e9:.0f} GB/s")
    return {"name": "maxplus_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/maxplus_scan/csrc/"
                      "maxplus_scan.cu",
            "replaces": "src/repro/kernels/maxplus_scan/kernel.py:126",
            "launches": None, "max_abs_err": main_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def _table6_batch():
    """64 scenarios: memory x cpu x disk upgrades, each at four loads."""
    import torch
    from repro_torch.core import capacity, queueing
    rows = []
    for memory, cpu, disk, rho in itertools.product(
            (1, 2, 3, 4), (1.0, 4.0), (1.0, 4.0), (0.3, 0.5, 0.7, 0.85)):
        pr = capacity.scenario_params(memory=memory, cpu=cpu, disk=disk,
                                      p=P, device="cpu")
        s = float(queueing.service_time_server(pr))
        rows.append((rho / s, float(pr.s_broker), pr.s_hit, pr.s_miss,
                     pr.s_disk, pr.hit))
    cols = list(zip(*rows))

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device="cuda")
    params = queueing.ServerParams(p=P, s_broker=t(cols[1]),
                                   s_hit=t(cols[2]), s_miss=t(cols[3]),
                                   s_disk=t(cols[4]), hit=t(cols[5]))
    return t(cols[0]), params


def phase_main_path(card: str) -> tuple[int, float]:
    """Table 6's p = 100 cluster, 64 scenarios, through the kernel."""
    import torch
    from repro_torch.core import queueing, simulator
    print(f"== phase 3: main path, Table 6 cluster (p = {P}), {N_SCEN} "
          "scenarios")
    lam, params = _table6_batch()
    n_queries, chunk, p = N_CHUNKS * CHUNK, CHUNK, P
    n_chunks = -(-n_queries // chunk)
    lo, hi = queueing.response_time_bounds(lam, params)
    # one-chunk warm-up (allocator, generators, first launches), uncounted
    simulator.simulate_fork_join_batch(11, lam, params, chunk, p=p,
                                       chunk_size=chunk)
    launches = exp_wall = None
    for mode in ("exponential", "cache"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        res = simulator.simulate_fork_join_batch(
            11, lam, params, n_queries, p=p, mode=mode, chunk_size=chunk)
        mean = res.mean_response
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        count = _counts()["maxplus_scan"]
        peak = torch.cuda.max_memory_allocated()
        wall = _wall(lambda: simulator.simulate_fork_join_batch(
            11, lam, params, n_queries, p=p, mode=mode, chunk_size=chunk))
        if count != 2 * n_chunks:
            raise AssertionError(f"{mode}: {count} kernel launches, expected "
                                 f"2 x {n_chunks} chunks")
        if launches is None:
            launches, exp_wall = count, wall
        t0 = time.perf_counter()
        plain = simulator.simulate_fork_join_batch(
            11, lam, params, n_queries, p=p, mode=mode, chunk_size=chunk,
            impl="torch")
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        if not bool(torch.isfinite(mean).all()):
            raise AssertionError(f"{mode}: non-finite means")
        # exponential service is the model's assumption: Eq 7 holds as
        # tests/test_simulator.py allows it; the cache mixture is held to
        # the same 5 % band the reference's cache-mode test uses
        floor = lo if mode == "exponential" else 0.95 * lo
        if not bool(((mean > floor) & (mean < 1.05 * hi)).all()):
            bad = torch.nonzero(~((mean > floor) & (mean < 1.05 * hi)))
            raise AssertionError(f"{mode}: means outside Eq 7 at scenarios "
                                 f"{bad.flatten().tolist()}")
        err = _rel_err(mean, plain.mean_response)
        if not err <= 1e-4:
            raise AssertionError(f"{mode}: kernel path vs plain path means "
                                 f"differ by {err} > 1e-4")
        n_total = lam.shape[0] * n_queries
        print(f"  {mode}: {count} launches for {n_chunks} chunks; "
              f"kernel path {first:.4f} s, again {wall:.4f} s = "
              f"{n_total / wall:.4g} queries/s, "
              f"{n_total * p / wall:.4g} server-events/s; plain path "
              f"{plain_wall:.3f} s; peak {peak / 2**20:.0f} MiB "
              f"[{card}]")
        print(f"    means vs plain path: max rel err {err:.2e}; mean "
              f"response {float(mean.min()) * 1e3:.1f}.."
              f"{float(mean.max()) * 1e3:.1f} ms, all inside Eq 7; "
              f"p95 max {float(res.quantile(0.95).max()) * 1e3:.1f} ms")
    return launches, exp_wall


def phase_profile(card: str, wall: float, run, title: str) -> None:
    """Where a path's device time goes (one run of ``run()``).

    Only device-side events are summed: `key_averages` also lists each
    aten op with the time of the kernels it launched, which would count
    them twice.  ``wall`` is the unprofiled run's wall time.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    print(f"== {title}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        print("  the profiler recorded no device-side events")
        return
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"  device busy {busy_ms:.2f} ms in {len(kernels)} kernels; "
          f"unprofiled wall {wall * 1e3:.2f} ms, so the card idles "
          f"{100 * (1 - busy_ms / (wall * 1e3)):.1f} % of it [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d}x  {e.key[:100]}")
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3
    print(f"  host: {host_ms:.2f} ms of self time in {len(host)} op kinds "
          f"(profiled); the largest:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"    {e.self_cpu_time_total / 1e3:8.3f} ms "
              f"{e.count:5d}x  {e.key[:80]}")


def _route_flags(rows, length, gen):
    """Segment heads of a random r = 4 routing, compacted as the engine
    compacts it: (rows, length) bool."""
    import torch
    assign = torch.randint(0, R, (rows, length), device="cuda",
                           generator=gen)
    srt = torch.sort(assign, dim=-1, stable=True).values
    flags = torch.ones_like(srt, dtype=torch.bool)
    flags[:, 1:] = srt[:, 1:] != srt[:, :-1]
    return flags


def phase_segment_kernel(card: str) -> dict:
    """The segmented kernel against its plain version, then timings at
    the server level of the replicated path: (6400, 4096) float32 with
    (64, 4096) route flags shared by each scenario's 100 server rows."""
    import torch
    from repro_torch.kernels.maxplus_scan import kernel, ops
    print("== phase 5: segmented (max,+) scan vs plain version on the card")
    gen = torch.Generator(device="cuda").manual_seed(5)
    main_err = 0.0
    # (a shape, its flag shape): server level, broker level, two ragged
    cases = [((N_SCEN, P, CHUNK), (N_SCEN, 1, CHUNK)),
             ((N_SCEN, CHUNK), (N_SCEN, CHUNK)), ((37, 1000), (37, 1000)),
             ((3, 5, 777), (3, 1, 777))]
    for (shape, fshape), dtype in itertools.product(
            cases, (torch.float32, torch.float64)):
        rtol = 1e-5 if dtype == torch.float32 else 1e-12
        a, b, _ = _inputs(shape, dtype, gen)
        f = _route_flags(math.prod(fshape[:-1]), fshape[-1],
                         gen).reshape(fshape)
        ka, kb = ops.maxplus_segment_scan(a, b, f, impl="cuda")
        pa, pb = ops.maxplus_segment_scan(a, b, f, impl="torch")
        torch.cuda.synchronize()
        err = max(_rel_err(ka, pa), _rel_err(kb, pb))
        abs_err = float(max((ka - pa).abs().max(), (kb - pb).abs().max()))
        print(f"  {str(shape):14s} flags {str(fshape):14s} "
              f"{str(dtype):14s} max rel err {err:.3e} max abs err "
              f"{abs_err:.3e} (rtol {rtol:g})")
        if not err <= rtol:
            raise AssertionError(f"segmented kernel disagrees with the "
                                 f"plain scan at {shape} {dtype}: {err} > "
                                 f"{rtol}")
        if shape == (N_SCEN, P, CHUNK) and dtype == torch.float32:
            main_err = max(main_err, abs_err)

    a, b, _ = _inputs(TIMED_SHAPE, torch.float32, gen)
    f = _route_flags(N_SCEN, CHUNK, gen)
    f8 = f.to(torch.uint8)
    ms = _time_ms(lambda: kernel.maxplus_segment_scan_cuda(a, b, f8))
    plain_ms = _time_ms(lambda: ops.maxplus_segment_scan(
        a, b, f[:, None, :].expand(N_SCEN, P, CHUNK).reshape(TIMED_SHAPE),
        impl="torch"), n=10)
    rows, length = TIMED_SHAPE
    moved = rows * length * 4 * a.element_size() + f8.numel()
    ops_ms = rows * length * 3 / FP32_OPS_PER_S * 1e3   # add, add, max
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"  at {TIMED_SHAPE} float32, {tuple(f8.shape)} uint8 flags, "
          f"mean of "
          f"{N_TIMED} launches [{card}]:")
    print(f"    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library: none "
          f"(no PyTorch call computes a segmented (max,+) scan)  bound "
          f"{bound_ms:.4f} ms ({moved / 1e6:.1f} MB at 3.35 TB/s); kernel "
          f"at {moved / (ms * 1e-3) / 1e9:.0f} GB/s")
    return {"name": "maxplus_segment_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/maxplus_scan/csrc/"
                      "maxplus_segment_scan.cu",
            "replaces": "src/repro/kernels/maxplus_scan/kernel.py:165",
            "launches": None, "max_abs_err": main_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def phase_jsq_kernel(card: str) -> dict:
    """The JSQ router against its plain loop at the replicated path's
    width (N_SCEN scenarios, r = R, p = P, one CHUNK-query chunk)."""
    import torch
    from repro_torch.kernels.jsq_route import kernel, ops
    print("== phase 5b: JSQ router vs plain loop on the card")
    gen = torch.Generator(device="cuda").manual_seed(6)
    s_mean = 0.02
    report = None
    for dtype in (torch.float32, torch.float64):
        w = torch.zeros((N_SCEN, R, P), dtype=dtype, device="cuda")
        gaps = torch.empty((N_SCEN, CHUNK), dtype=dtype, device="cuda"
                           ).exponential_(generator=gen) * (s_mean / R / 0.8)
        svc = torch.empty((N_SCEN, P, CHUNK), dtype=dtype, device="cuda"
                          ).exponential_(generator=gen) * s_mean
        live = (torch.rand((N_SCEN, CHUNK), device="cuda", generator=gen)
                >= RESULT_CACHE[0]).to(dtype)
        kc, kw = ops.jsq_route(w, gaps, svc, live, impl="cuda")
        pc, pw = ops.jsq_route(w, gaps, svc, live, impl="torch")
        torch.cuda.synchronize()
        same = bool(torch.equal(kc, pc))
        abs_err = float((kw - pw).abs().max())
        print(f"  {str(dtype):14s} choices equal: {same}; tracker max abs "
              f"err {abs_err:.3e}; replica shares "
              f"{torch.bincount(kc.flatten(), minlength=R).tolist()}")
        if not same or abs_err != 0.0:
            raise AssertionError(f"JSQ kernel disagrees with the plain loop "
                                 f"({dtype}): choices equal {same}, "
                                 f"tracker err {abs_err}")
        if dtype == torch.float32:
            ms = _time_ms(lambda: kernel.jsq_route_cuda(w, gaps, svc, live),
                          n=20)
            plain_ms = _time_ms(lambda: ops.jsq_route(w, gaps, svc, live,
                                                      impl="torch"),
                                n=2, warm=0)
            moved = ((w.numel() * 2 + gaps.numel() + svc.numel()
                      + live.numel()) * w.element_size() + kc.numel() * 8)
            # per query and scenario: drain (sub, max) and reduce over
            # r x p, argmin over r, deposit (mul, add) over p
            n_ops = N_SCEN * CHUNK * (3 * R * P + R + 2 * P)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = n_ops / FP32_OPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            print(f"  at ({N_SCEN}, r={R}, p={P}, {CHUNK}) float32 "
                  f"[{card}]: "
                  f"kernel {ms:.4f} ms (mean of 20)  plain loop "
                  f"{plain_ms:.1f} ms  library: none  bound "
                  f"{bound_ms:.4f} ms ({moved / 1e6:.1f} MB at 3.35 TB/s; "
                  f"the chain is {CHUNK} dependent steps, "
                  f"{ms * 1e6 / CHUNK:.0f} ns each)")
            report = {"name": "jsq_route", "route": "cuda",
                      "source": "src/repro_torch/kernels/jsq_route/csrc/"
                                "jsq_route.cu",
                      "replaces": "src/repro/core/simulator.py:541 "
                                  "(lax.scan, no Pallas kernel)",
                      "launches": None, "max_abs_err": abs_err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": ("bytes" if bytes_ms >= ops_ms
                                   else "operations"),
                      "library_ms": None}
    return report


def _slice(lam, params, idx):
    import dataclasses
    return lam[idx], dataclasses.replace(params, **{
        name: getattr(params, name)[idx]
        for name in ("s_broker", "s_hit", "s_miss", "s_disk", "hit")})


def phase_replicated(card: str) -> tuple[dict, float]:
    """The replicated cluster at full width: r = 4, result cache, 64
    scenarios x p = 100, 25 chunks, random and JSQ routing."""
    import torch
    from repro_torch.core import queueing, simulator
    from repro_torch.core.cluster import ClusterSpec
    print(f"== phase 6: replicated path, r = {R}, result cache "
          f"{RESULT_CACHE}, Table 6 cluster (p = {P}), 64 scenarios")
    lam1, params = _table6_batch()
    lam = R * lam1                 # each replica sees phase 3's rho
    rho = lam1 * queueing.service_time_server(params)
    n_queries = N_CHUNKS * CHUNK

    def run(routing, n=n_queries, cache=RESULT_CACHE, impl="auto",
            replica_impl="fused", lam=lam, params=params):
        return simulator.simulate_fork_join_batch(
            11, lam, params, n, p=P, chunk_size=CHUNK, impl=impl,
            cluster=ClusterSpec(r=R, routing=routing, result_cache=cache,
                                replica_impl=replica_impl))

    for routing in ("random", "jsq"):     # warm-up, uncounted
        run(routing, n=CHUNK)
    launches, means, walls = {}, {}, {}
    for routing in ("random", "jsq"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        res = run(routing)
        mean = res.mean_response
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        wall = _wall(lambda: run(routing))
        expect = {"maxplus_scan": 0, "maxplus_segment_scan": 3 * N_CHUNKS,
                  "jsq_route": N_CHUNKS if routing == "jsq" else 0}
        if counts != expect:
            raise AssertionError(f"{routing}: launches {counts}, expected "
                                 f"{expect}")
        if not bool(torch.isfinite(mean).all()):
            raise AssertionError(f"{routing}: non-finite means")
        launches[routing], means[routing], walls[routing] = (counts, mean,
                                                             wall)
        n_total = lam.shape[0] * n_queries
        print(f"  {routing}: launches {counts}; {first:.4f} s, again "
              f"{wall:.4f} s = {n_total / wall:.4g} queries/s, "
              f"{n_total * P / wall:.4g} server-events/s; peak "
              f"{peak / 2**20:.0f} MiB; "
              f"mean {float(mean.min()) * 1e3:.2f}.."
              f"{float(mean.max()) * 1e3:.2f} ms; p95 max "
              f"{float(res.quantile(0.95).max()) * 1e3:.1f} ms [{card}]")

    # the kernel path against the plain path on the same draws; JSQ's
    # plain loop is ~8 launches per query, so it runs 2 chunks only
    for routing, n in (("random", n_queries), ("jsq", 2 * CHUNK)):
        kern = run(routing, n=n).mean_response
        t0 = time.perf_counter()
        plain = run(routing, n=n, impl="torch").mean_response
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        err = _rel_err(kern, plain)
        print(f"  {routing}: kernel path vs plain path means over "
              f"{n // CHUNK} chunks: max rel err {err:.2e} (plain path "
              f"{plain_wall:.2f} s)")
        if not err <= 1e-4:
            raise AssertionError(f"{routing}: kernel vs plain means differ "
                                 f"by {err} > 1e-4")

    # random routing thins Poisson exactly: without the cache every
    # replica is the phase 3 cluster at lam / r, inside Eq 7
    lo, hi = queueing.response_time_bounds(lam / R, params)
    nc = run("random", cache=None).mean_response
    ok = (nc > lo) & (nc < 1.05 * hi)
    print(f"  random, no cache: means inside Eq 7 at lam / r: "
          f"{int(ok.sum())} / {ok.numel()}")
    if not bool(ok.all()):
        raise AssertionError(f"no-cache random means outside Eq 7 at "
                             f"{torch.nonzero(~ok).flatten().tolist()}")

    heavy = rho >= 0.7
    jsq_wins = means["jsq"] <= means["random"]
    print(f"  jsq <= random in {int((jsq_wins & heavy).sum())} of "
          f"{int(heavy.sum())} scenarios with rho >= 0.7; mean ratio "
          f"{float((means['jsq'] / means['random'])[heavy].mean()):.3f}")
    if not bool(jsq_wins[heavy].all()):
        raise AssertionError("jsq slower than random at rho >= 0.7 in "
                             f"{torch.nonzero(heavy & ~jsq_wins).flatten()}")

    idx = torch.arange(0, lam.shape[0], 8, device=lam.device)
    lam8, params8 = _slice(lam, params, idx)
    for routing in ("random", "jsq"):
        fused, masked = (run(routing, lam=lam8, params=params8,
                             replica_impl=impl).mean_response
                         for impl in ("fused", "masked"))
        err = _rel_err(fused, masked)
        print(f"  {routing}: fused vs masked means at 8 scenarios: max rel "
              f"err {err:.2e}")
        if not err <= 1e-4:
            raise AssertionError(f"{routing}: fused vs masked differ by "
                                 f"{err} > 1e-4")
    return launches, walls["random"]


def phase_memory_law(card: str) -> None:
    """Fused peak memory against r: the slope per replica stays under the
    reference's allowance of 10 S x p x chunk float32 buffers."""
    import torch
    from repro_torch.core import simulator
    from repro_torch.core.cluster import ClusterSpec
    print("== phase 7: r-free memory law of the fused engine")
    lam1, params = _table6_batch()
    peaks = {}
    for r in (2, 4, 8):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        simulator.simulate_fork_join_batch(
            11, r * lam1, params, 2 * CHUNK, p=P, chunk_size=CHUNK,
            cluster=ClusterSpec(r=r, routing="random",
                                result_cache=RESULT_CACHE))
        torch.cuda.synchronize()
        peaks[r] = torch.cuda.max_memory_allocated() - base
    unit = lam1.shape[0] * P * CHUNK * 4
    slope = (peaks[8] - peaks[2]) / 6
    print(f"  peak above baseline: " + ", ".join(
        f"r={r} {v / 2**20:.1f} MiB" for r, v in peaks.items())
        + f"; slope {slope / 2**20:.3f} MiB per replica = "
        f"{slope / unit:.4f} S*p*chunk buffers (allowance "
        f"{MAX_BUFFERS_PER_R:g}) [{card}]")
    if not slope <= MAX_BUFFERS_PER_R * unit:
        raise AssertionError(f"fused peak memory grows {slope / unit:.2f} "
                             f"S*p*chunk buffers per replica")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is missing ({exc}); "
              "run from a checkout of the repository", file=sys.stderr)
        return 2
    card = phase_device()
    scan = phase_kernel(card)
    scan["launches"], wall = phase_main_path(card)
    from repro_torch.core import simulator
    lam, params = _table6_batch()
    phase_profile(card, wall, lambda: simulator.simulate_fork_join_batch(
        11, lam, params, N_CHUNKS * CHUNK, p=P),
        "phase 4: device time by kernel, main path (exponential)")
    segment = phase_segment_kernel(card)
    jsq = phase_jsq_kernel(card)
    launches, wall = phase_replicated(card)
    segment["launches"] = launches["random"]["maxplus_segment_scan"]
    jsq["launches"] = launches["jsq"]["jsq_route"]
    from repro_torch.core.cluster import ClusterSpec
    phase_profile(card, wall, lambda: simulator.simulate_fork_join_batch(
        11, R * lam, params, N_CHUNKS * CHUNK, p=P,
        cluster=ClusterSpec(r=R, routing="random",
                            result_cache=RESULT_CACHE)),
        f"phase 6b: device time by kernel, replicated path (random, r = {R},"
        " result cache)")
    phase_memory_law(card)
    print(json.dumps({"kernels": [scan, segment, jsq]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
