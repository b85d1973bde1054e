#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA (max,+) scan from the checkout's sources,
holds it against its plain PyTorch version on the card, drives the port's
main path — `simulate_fork_join_batch` over Table 6's 100-server case
study, 64 scenarios — through the kernel, checks the answers against the
Eq 7 bounds and against the plain path, and prints timings beside the
card's name and power limit.  Any failed check raises (non-zero exit).
The last two lines are the kernel report and the device line, as JSON.

Needs a CUDA device and nvcc; it refuses to run anywhere else.  Imports
torch and repro_torch only.
"""

from __future__ import annotations

import itertools
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM, non-tensor float32
TIMED_SHAPE = (6400, 4096)      # the server scan: 64 scenarios x p=100
N_TIMED = 50


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


def _time_ms(fn) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(N_TIMED):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / N_TIMED


def phase_device():
    import torch
    from repro_torch.kernels.maxplus_scan import kernel
    card = _card()
    print("== phase 1: device")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}; "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kernel.load_library()
    print(f"maxplus_scan built+loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kernel.build_seconds} s)")
    print(kernel.build_log.strip() or "(library found in the build cache)")
    return card


def phase_kernel(card: str) -> dict:
    """The kernel against its plain version, then timings at TIMED_SHAPE."""
    import torch
    from repro_torch.kernels.maxplus_scan import kernel, ops
    print("== phase 2: kernel vs plain version on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = 0.0
    shapes = [TIMED_SHAPE, (64, 4096), (37, 1000), (3, 5, 777)]
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
                                      p=100, device="cpu")
        s = float(queueing.service_time_server(pr))
        rows.append((rho / s, float(pr.s_broker), pr.s_hit, pr.s_miss,
                     pr.s_disk, pr.hit))
    cols = list(zip(*rows))

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device="cuda")
    params = queueing.ServerParams(p=100, s_broker=t(cols[1]),
                                   s_hit=t(cols[2]), s_miss=t(cols[3]),
                                   s_disk=t(cols[4]), hit=t(cols[5]))
    return t(cols[0]), params


def phase_main_path(card: str) -> tuple[int, float]:
    """Table 6's p = 100 cluster, 64 scenarios, through the kernel."""
    import torch
    from repro_torch.core import queueing, simulator
    from repro_torch.kernels.maxplus_scan import ops
    print("== phase 3: main path, Table 6 cluster (p = 100), 64 scenarios")
    lam, params = _table6_batch()
    n_queries, chunk, p = 25 * 4096, 4096, 100
    n_chunks = -(-n_queries // chunk)
    lo, hi = queueing.response_time_bounds(lam, params)
    # one-chunk warm-up (allocator, generators, first launches), uncounted
    simulator.simulate_fork_join_batch(11, lam, params, chunk, p=p,
                                       chunk_size=chunk)
    launches = exp_wall = None
    for mode in ("exponential", "cache"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_count()
        t0 = time.perf_counter()
        res = simulator.simulate_fork_join_batch(
            11, lam, params, n_queries, p=p, mode=mode, chunk_size=chunk)
        mean = res.mean_response
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        count = ops.launch_count()
        peak = torch.cuda.max_memory_allocated()
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
              f"kernel path {wall:.3f} s = {n_total / wall:.4g} queries/s, "
              f"{n_total * p / wall:.4g} server-events/s; plain path "
              f"{plain_wall:.3f} s; peak {peak / 2**20:.0f} MiB "
              f"[{card}]")
        print(f"    means vs plain path: max rel err {err:.2e}; mean "
              f"response {float(mean.min()) * 1e3:.1f}.."
              f"{float(mean.max()) * 1e3:.1f} ms, all inside Eq 7; "
              f"p95 max {float(res.quantile(0.95).max()) * 1e3:.1f} ms")
    return launches, exp_wall


def phase_profile(card: str, wall: float) -> None:
    """Where the main path's device time goes (one exponential run).

    Only device-side events are summed: `key_averages` also lists each
    aten op with the time of the kernels it launched, which would count
    them twice.  ``wall`` is the unprofiled run's wall time (phase 3).
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import simulator
    print("== phase 4: device time by kernel, main path (exponential)")
    lam, params = _table6_batch()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        simulator.simulate_fork_join_batch(11, lam, params, 25 * 4096,
                                           p=100)
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
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d}x  {e.key[:100]}")


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
    report = phase_kernel(card)
    report["launches"], wall = phase_main_path(card)
    phase_profile(card, wall)
    print(json.dumps({"kernels": [report]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
