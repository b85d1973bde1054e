#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout's sources (the
(max,+) scan, the segmented (max,+) scan, the JSQ router, flash attention,
decode attention, the embedding bag, the fused CIN layer, the fleet scan
and the service sampler, one nvcc each, in parallel), holds each against
its plain PyTorch version on the card (the service sampler bit for bit
against the plain draws, phase 5c), and drives the port's paths:

  * the simulator over Table 6's 100-server case study, 64 scenarios:
    the single-replica engine (phases 3-4) and the replicated cluster,
    r = 4 with the result cache, under random and JSQ routing (phases
    6-7), checked against the Eq 7 bounds and the plain path;
  * LM serving: `LMServer` at Qwen3-8B's full width in bfloat16 with
    random weights from a seed, 12 requests through 8 slots (phases
    10-10b), its logits held against the plain path (phase 11), and the
    serving planner on the measured step (phase 12);
  * CTR serving: the embedding-bag and CIN kernels at xDeepFM's shapes
    (phases 13-14), then xDeepFM at full width (39 fields, 33.8 M rows,
    CIN 200-200-200) in bfloat16 with random weights serving four
    serve_p99 batches (B = 512) and one serve_bulk batch (B = 262,144) of
    `ctr_batch` requests, DeepFM and AutoInt one serve_p99 batch each,
    logits and each CIN layer on the served values held against the
    plain path (phase 15), and where the device time goes (phase 15b);
  * the planning layer (phase 16): examples/whatif_sweep.py's Table 6
    columns through `plan_over_grid` and examples/global_sweep.py's
    1,000,000-scenario grid in one `sweep_analytical` call, both held
    against the CPU (16a); a simulated sweep of 3 x 64 scenarios at
    1,048,576 queries each under random and JSQ routing, its kernel
    launches asserted (the service sampler's too, with no call to the
    plain draws), Eq 7, the plain path, p95 frontiers and a
    diurnal plan (16b); the paper's 4 x 100 plan with its simulated
    cross-check (16c); and the disk-cache imbalance model over the
    TodoBR universe against the CPU (16d);
  * the cluster under change (phase 17): the fleet scan (outage masks
    and the autoscaler, the eighth kernel) and the masked JSQ router
    against their plain loops (17a, 17a'); the 16b slab under the weekly
    profile with an AutoscalePolicy (1..4) under JSQ and random routing,
    the pinned policy bit-identical to static r = 4 (17b); the same slab
    at r = 4 with all four fault channels under the three routings, the
    fault-free identities, a trace (17c); the N+1 plan, a policy axis
    and a fault axis through `plan_over_grid` (17d); past 16 replicas,
    the router and the fleet scan at r = 17, 32, 64 and 256 (17a, 17a')
    and an N+1 plan of more than 16 replicas under random and JSQ
    routing, held to the CPU's (17e).  Kernel launches are asserted and
    the kernel path is held against the plain path;
  * observability (phase 18): telemetry on 16b's slab at r = 1 and 4
    (base statistics bitwise those without it, counts and busy sums
    conserved, the operational laws, its cost a chunk and its peak
    memory), on 17b's and 17c's dispatches (the active, up, spill and
    degraded channels), card against CPU, a JSQ span trace exported and
    validated, the kernel profiles and a rendered timeline;
  * the calibration loop (phase 19): the toy search engine at Table 5's
    layout (8 index servers over a 400,000-page collection, TodoBR
    queries), its scorer against the CPU and its stacked 8-shard search
    against one index (19a); measure -> fit -> plan on the engine at
    three Poisson rates, the fit's replay through the (max,+) scan and
    its tangent with the scan's launches asserted (19b); the 60,000-query
    Table 5 round trip of examples/calibrate_and_plan.py, held-out
    validation with a replicated JSQ column, card against CPU (19c); the
    scan's forward-mode rule on the kernel against the plain path, the
    scan's times at the calibration's shapes, and a profile of the fit
    (19d);
  * scenario sharding (phase 20): the 1,000,000-scenario analytic grid
    under `make_sweep_mesh()` and an 8-way mesh on cuda:0, bitwise the
    unsharded surfaces (20a); 16b's slab at r = 4 under JSQ with the
    result cache split 2 and 4 ways, each shard bitwise a direct batch
    run on its seed, its launches asserted and its peak memory beside
    the unsharded peak (20b); phase 19a's 8-shard engine under
    `make_search_fn(mesh)` against the stacked search (20c);
  * MoE and Command-R serving (phase 21): `LMServer` on Qwen3-MoE-30B-A3B
    at full width and depth, Granite-MoE-3B whole and Command-R+ at full
    width with its depth cut to what fits the card, phase 10's slots and
    prompts (16 new tokens a request), random bfloat16 weights: tokens/s, where a decode step's
    time goes (the MoE layer's expert products against routing, dispatch
    and combine), the kernel path's logits against the plain path's;
  * MIND at FULL (phase 22): interests of a serve batch, then
    retrieval_cand (one user against 1,000,000 items, top-100), card
    against CPU;
  * LM training (phase 23): Qwen3-1.7B at full width and depth in
    bfloat16, `TrainStep` (AdamW, 4 microbatches) on 8 x 4096 pipeline
    tokens a step: step wall, tokens/s, MFU, peak memory, where a step's
    device time goes, one sequence's loss and three gradients against a
    float32 copy (23a); Granite-MoE-3B at full width, the aux loss in
    the loss (23b); the smoke configs in float32 card against CPU and
    `forward_train` against `prefill`'s flash kernel (23c);
    examples/torch_train_lm.py's demo-12m for 300 steps, its checkpoint
    restored bit for bit (23d).  LM training launches no port kernel: the
    reference trains through plain attention;
  * recommender training (phase 24): xDeepFM at full width in bfloat16,
    `TrainStep(AdamW(1e-4))` on the reference's train_batch cell (B =
    65,536 `ctr_batch` samples) through the embedding-bag and CIN
    kernels' `torch.autograd.Function`s (kernel forward, plain-PyTorch
    backward): step wall, samples/s, model FLOP/s, peak memory, idle
    share and where a step's device time goes (24a); on a 4,096-sample
    microbatch every gradient against autograd of the plain path in
    bfloat16 and float32, the launches, a repeated step bit for bit and
    serve_p99's launches unchanged (24b); DeepFM and AutoInt (24c) and
    MIND with 1,024 shared negatives (24d) one timed step each, the four
    at their smoke configs card against CPU (24d), and smoke xDeepFM
    learning one batch (24e);
  * DimeNet (phase 25): FULL in bfloat16, a `TrainStep` on the molecule
    cell (128 molecules, padded as the reference's cell pads, 25a) and on
    minibatch_lg (1,024 seeds, fanouts 15 / 10 from a 232,965-node power
    law graph whose average degree is cut from 492 to 64; 25b), with
    where its device time goes; a repeated step bit for bit, bfloat16
    against a float32 copy, and the smoke config card against CPU (25c);
  * the production dry run (phase 26): one cell of each family (qwen3-8b
    train_4k, xdeepfm train_batch, dimenet ogb_products) and two serving
    cells traced on the host on the (16, 16) and (2, 16, 16) meshes of
    meta devices, every figure finite and the argument bytes those of
    the stand-ins' shards (26a); three cells on a (1, 1) mesh of the card
    held against real steps: argument bytes and the plain path's FLOPs
    exactly (xDeepFM's plain path at the largest halved batch that the
    record says fits), temporaries and step time beside the record's
    (26b); the (max,+) kernels on H100_SXM's roofline (26c); the records'
    tables and examples/torch_plan_llm_serving.py's plans (26d);
  * the port's static analysis (phase 27): `repro_torch.staticcheck`
    over the checkout on the card's host, nothing active (27a); its
    host-sync rule held against the card's own sync debug mode on two
    chunks each of the r = 1 main path, r = 4 JSQ with the cache, 17b's
    autoscaled and 17c's faulted slab with telemetry: every sync inside
    the chunk loop must be at a site the rule reports, suppressed; a
    sync seeded into the loop is caught; a DimeNet-sized segment sum
    syncs at exactly the rule's two sites (27b); the shape contract's
    probes on the card equal the CPU's specs (27c);
  * the three late examples (phase 28): examples/torch_simulate_cluster
    .py's table at p = 8 .. 1024, 40,000 queries, three service modes,
    Eq 7 against the CPU's, the exponential means inside Eq 7, p = 1024
    kernel against plain path, the scan's time at (1024, 4096) (28a);
    examples/torch_replicated_sweep.py's three frontiers against the
    CPU's, its 4 x 100 JSQ plan and the 3x flash crowd at r = 4 and 12
    (150,000 queries, launches asserted, the crowd's first chunks at r
    = 12 against the plain path) (28b); examples/torch_serve_search.py's
    open loop for 15 s on the card's engine, one batch's top-k against
    the CPU engine, the backlog and the latency drift printed (28c).

Phases 8 and 14 also print the wgmma kernels' ptxas reports (registers,
spills, serialisation warnings) and take one tile through the shared
Hopper header (csrc/hopper.cuh: TMA, descriptors, wgmma) against a
float32 matmul.

It prints timings beside the card's name and power limit.  Any failed
check raises (non-zero exit).  The last lines are the kernel report
(JSON), the card, and the device line (JSON).  TF32 is off for matrix
products and cuDNN (`torch.backends`), so float32 means float32.

Needs a CUDA device and nvcc; it refuses to run anywhere else.  Imports
torch, numpy and repro_torch only.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM, non-tensor float32
BF16_OPS_PER_S = 989e12         # H100 SXM, dense bf16 tensor cores
N_SCEN, P, CHUNK, N_CHUNKS = 64, 100, 4096, 25   # Table 6, full width
TIMED_SHAPE = (N_SCEN * P, CHUNK)   # the server scan: 64 scenarios x p
N_TIMED = 50
# The tile check's products are exact in float32 (bf16 x bf16) and sum at
# most 128 of them: float32 rounding, ~1e-7 of the largest |C|.
TILE_RTOL = 1e-5
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


def _device_ms(fn, n: int = N_TIMED, warm: int = 3) -> float:
    """Device time of one ``fn()`` call.  A spin kernel holds the stream
    while the host queues all ``n`` calls, so a call whose host cost
    (Python wrapper, launches) exceeds its device time is timed by the
    card, not by the host."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2e9))   # >= 2 x host_s at <= 2 GHz
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
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fleet_scan import ops as fleet_ops
    from repro_torch.kernels.jsq_route import ops as jsq_ops
    from repro_torch.kernels.maxplus_scan import ops
    from repro_torch.kernels.service_sample import ops as sample_ops
    ops.reset_launch_count()
    ops.reset_segment_launch_count()
    jsq_ops.reset_launch_count()
    fleet_ops.reset_launch_count()
    sample_ops.reset_counts()
    fa_ops.reset_counts()
    dec_ops.reset_counts()


def _counts() -> dict:
    from repro_torch.kernels.fleet_scan import ops as fleet_ops
    from repro_torch.kernels.jsq_route import ops as jsq_ops
    from repro_torch.kernels.maxplus_scan import ops
    return {"maxplus_scan": ops.launch_count(),
            "maxplus_segment_scan": ops.segment_launch_count(),
            "jsq_route": jsq_ops.launch_count(),
            "fleet_scan": fleet_ops.launch_count()}


def _sample_counts() -> dict:
    """Service-sampler launches, and calls that took the plain draws."""
    from repro_torch.kernels.service_sample import ops as sample_ops
    return {"service_sample": sample_ops.launch_count(),
            "plain": sample_ops.plain_count()}


def _attention_counts() -> dict:
    """Attention kernel launches, and calls that took a plain version."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    return {"flash_attention": fa_ops.launch_count(),
            "decode_attention": dec_ops.launch_count(),
            "plain": fa_ops.plain_count() + dec_ops.plain_count()}


def phase_device():
    import torch
    from repro_torch.kernels import _cuda
    card = _card()
    print("== phase 1: device and kernel builds")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}; "
          f"count {torch.cuda.device_count()}")
    libs = _cuda.all_libraries()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs))   # raises on failure
    print(f"{len(libs)} libraries built+loaded in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    wgmma = {"flash_attention", "cin_fuse", "hopper_tile"}
    for lib in libs:
        print(f"-- {lib.name}: nvcc {lib.build_seconds} s")
        if lib.name not in wgmma:
            _ptxas_report(lib)
    print("(the wgmma libraries' ptxas reports: phases 8 and 14)")
    return card


def _ptxas_report(lib) -> None:
    """One line a kernel of ``lib`` from its nvcc -Xptxas -v output:
    registers, spill stores and loads; then ptxas's performance warnings
    (wgmma serialisation, C751x)."""
    if not lib.build_log:
        print(f"  {lib.name}: found in the build cache, no ptxas report")
        return
    name = None
    for line in lib.build_log.splitlines():
        if "Compiling entry function" in line:
            name, spills = line.split("'")[1], ""
        elif "spill stores" in line and name:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[1].split(",")[0].strip()
            print(f"  {lib.name} {_demangle(name)}: {regs}; {spills}")
            name = None
        elif "Potential Performance Loss" in line:
            print(f"  {lib.name} ptxas: {line.split('info    :')[-1].strip()}")


def _demangle(name: str) -> str:
    """A kernel's C++ name (c++filt where the machine has it), without
    its parameter list."""
    try:
        out = subprocess.run(["c++filt", name], capture_output=True,
                             text=True, check=True, timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return name[:90]
    out = out.strip().replace("(anonymous namespace)::", "")
    return out.split("(")[0].removeprefix("void ")


def _tile_check(what: str) -> None:
    """hopper.cuh alone on the card: one 64 x N x K bf16 tile through TMA
    and wgmma, B K-major and MN-major, A from shared memory and from
    registers, against a float32 matmul of the same bf16 values."""
    import torch
    from repro_torch.kernels import hopper
    gen = torch.Generator(device="cuda").manual_seed(15)
    worst = 0.0
    cases = list(itertools.product(hopper.TILE_N, hopper.TILE_K,
                                   (False, True), (False, True)))
    for n, k, mn, regs in cases:
        a = torch.randn((64, k), generator=gen, device="cuda").bfloat16()
        b = torch.randn((k, n) if mn else (n, k), generator=gen,
                        device="cuda").bfloat16()
        c = hopper.tile_product(a, b, b_mn_major=mn, a_in_regs=regs)
        expect = a.float() @ (b.float() if mn else b.float().t())
        err = float((c - expect).abs().max() / expect.abs().max())
        worst = max(worst, err)
        if not err <= TILE_RTOL:
            raise AssertionError(f"hopper.cuh tile N={n} K={k} "
                                 f"mn_major={mn} a_in_regs={regs}: {err}")
    print(f"  {what}: hopper.cuh tile check, {len(cases)} cases (N "
          f"{hopper.TILE_N} x K {hopper.TILE_K} x B K-/MN-major x A in "
          f"shared memory / registers): worst max abs err / max |C| "
          f"{worst:.2e} (limit {TILE_RTOL:g})")


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
        # out_a alone (the simulator's FCFS queues): the same out_a
        oa, none = (ops.maxplus_scan_seeded(*args, impl="cuda", with_b=False)
                    if seeded else
                    ops.maxplus_scan(a, b, impl="cuda", with_b=False))
        torch.cuda.synchronize()
        err = max(_rel_err(ka, pa), _rel_err(kb, pb))
        abs_err = float(max((ka - pa).abs().max(), (kb - pb).abs().max()))
        same = none is None and bool(torch.equal(oa, ka))
        print(f"  {str(shape):14s} {str(dtype):14s} seeded={seeded!s:5s} "
              f"max rel err {err:.3e} max abs err {abs_err:.3e} "
              f"(rtol {rtol:g}); out_a only equal {same}")
        if not err <= rtol or not same:
            raise AssertionError(f"kernel disagrees with the plain scan at "
                                 f"{shape} {dtype}: {err} > {rtol}, or its "
                                 f"out_a-only path with its out_a: {same}")
        if shape == TIMED_SHAPE and dtype == torch.float32:
            main_err = max(main_err, abs_err)

    a, b, carry = _inputs(TIMED_SHAPE, torch.float32, gen)
    both_ms = _time_ms(lambda: kernel.maxplus_scan_cuda(a, b, carry))
    ms = _time_ms(lambda: kernel.maxplus_scan_cuda(a, b, carry,
                                                   with_b=False))
    plain_ms = _time_ms(lambda: ops.maxplus_scan_seeded(a, b, carry,
                                                        impl="torch"))

    def yardstick():             # timed only; the port never calls it
        big_b = torch.cumsum(b, -1)
        return big_b + torch.cummax(a - big_b, -1).values
    library_ms = _time_ms(yardstick)
    rows, length = TIMED_SHAPE
    # what the path asks for: a, b in, out_a out (out_b as well: + 4 B)
    moved = rows * length * 3 * a.element_size()
    moved_both = rows * length * 4 * a.element_size()
    ops_ms = rows * length * 3 / FP32_OPS_PER_S * 1e3   # add, add, max
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    both_bound = max(moved_both / HBM_BYTES_PER_S * 1e3, ops_ms)
    print(f"  at {TIMED_SHAPE} float32, mean of {N_TIMED} launches "
          f"[{card}]:")
    print(f"    out_a only (the main path's): kernel {ms:.4f} ms  bound "
          f"{bound_ms:.4f} ms ({moved / 1e6:.1f} MB at 3.35 TB/s), "
          f"{100 * bound_ms / ms:.1f} %; kernel at "
          f"{moved / (ms * 1e-3) / 1e9:.0f} GB/s")
    print(f"    both outputs: kernel {both_ms:.4f} ms  bound "
          f"{both_bound:.4f} ms ({moved_both / 1e6:.1f} MB), "
          f"{100 * both_bound / both_ms:.1f} %")
    print(f"    plain {plain_ms:.4f} ms  yardstick (cumsum+cummax) "
          f"{library_ms:.4f} ms")
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


def phase_profile(card: str, wall: float, run, title: str,
                  trace_host: bool = True) -> dict:
    """Where a path's device time goes (one run of ``run()``); returns
    {kernel name: (device ms, launches)} of the kernels the trace lists.
    ``trace_host=False`` traces the device alone (no host ops, no host
    summary): a training step's ~100,000 host events take longer to
    trace and sum than the step.

    Only device-side events are summed: `key_averages` also lists each
    aten op with the time of the kernels it launched, which would count
    them twice.  ``wall`` is the unprofiled run's wall time.  A warm-up
    step (a few small kernels, discarded) starts the device tracing
    before ``run()``: started cold, the trace lost the first kernels of a
    run (an xDeepFM call's two bags and a sum, after earlier sessions).
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    print(f"== {title}")
    activities = ([ProfilerActivity.CPU, ProfilerActivity.CUDA]
                  if trace_host else [ProfilerActivity.CUDA])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 ) as prof:
        warm = torch.ones(1, device="cuda")
        for _ in range(8):
            warm.add_(1)
        torch.cuda.synchronize()
        prof.step()
        run()
        torch.cuda.synchronize()
        prof.step()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith("ProfilerStep")]
    if not kernels:
        print("  the profiler recorded no device-side events")
        return {}
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"  device busy {busy_ms:.2f} ms in {len(kernels)} kernels; "
          f"unprofiled wall {wall * 1e3:.2f} ms, so the card idles "
          f"{100 * (1 - busy_ms / (wall * 1e3)):.1f} % of it [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d}x  {e.key[:100]}")
    if not trace_host:
        return {e.key: (e.self_device_time_total / 1e3, e.count)
                for e in kernels}
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU
            and not e.key.startswith("ProfilerStep")]   # the step's span
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3
    print(f"  host: {host_ms:.2f} ms of self time in {len(host)} op kinds "
          f"(profiled); the largest:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"    {e.self_cpu_time_total / 1e3:8.3f} ms "
              f"{e.count:5d}x  {e.key[:80]}")
    return {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in kernels}


def _kernel_share(traced: dict, key: str, what: str) -> None:
    """Print the device time of the kernels whose name holds ``key`` in a
    `phase_profile` trace; fail if the trace has none (every traced path
    launches the kernels it is asked about)."""
    hits = [v for k, v in traced.items() if key in k]
    if not hits:
        raise AssertionError(f"the trace lists no {key} kernel, though the "
                             "path launched it")
    ms = sum(t for t, _ in hits)
    busy = sum(t for t, _ in traced.values())
    print(f"  {what}: {ms:.3f} ms in {sum(n for _, n in hits)} launches, "
          f"{100 * ms / busy:.1f} % of {busy:.2f} ms busy")


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
        oa, none = ops.maxplus_segment_scan(a, b, f, impl="cuda",
                                            with_b=False)
        pa, pb = ops.maxplus_segment_scan(a, b, f, impl="torch")
        torch.cuda.synchronize()
        if none is not None or not torch.equal(oa, ka):
            raise AssertionError(f"the out_a-only scan differs from the "
                                 f"two-output out_a at {shape} {dtype}")
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
    plain_ms = _time_ms(lambda: ops.maxplus_segment_scan(
        a, b, f[:, None, :].expand(N_SCEN, P, CHUNK).reshape(TIMED_SHAPE),
        impl="torch"), n=10)
    rows, length = TIMED_SHAPE
    ops_ms = rows * length * 3 / FP32_OPS_PER_S * 1e3   # add, add, max
    print(f"  at {TIMED_SHAPE} float32, {tuple(f8.shape)} uint8 flags, "
          f"mean of {N_TIMED} launches [{card}]; plain {plain_ms:.4f} ms, "
          "library: none (no PyTorch call computes a segmented (max,+) "
          "scan):")
    # out_a only is what the simulator calls: a, b read, out_a written
    for with_b, what in ((False, "out_a only (the main path)"),
                         (True, "out_a and out_b")):
        t = _time_ms(lambda: kernel.maxplus_segment_scan_cuda(
            a, b, f8, with_b=with_b))
        moved = rows * length * (4 if with_b else 3) * a.element_size() \
            + f8.numel()
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_bound = max(t_bytes, ops_ms)
        print(f"    {what}: kernel {t:.4f} ms  bound {t_bound:.4f} ms "
              f"({moved / 1e6:.1f} MB at 3.35 TB/s; "
              f"{100 * t_bound / t:.1f} %); kernel at "
              f"{moved / (t * 1e-3) / 1e9:.0f} GB/s")
        if not with_b:
            ms, bytes_ms, bound_ms = t, t_bytes, t_bound
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
    width (N_SCEN scenarios, r = R, p = P, one CHUNK-query chunk), in
    float32 and float64."""
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
        # start from the tracker a chunk leaves, so that every replica is
        # busy and the choices are not ties
        w = ops.jsq_route(w, gaps, svc, live, impl="cuda")[1]
        before = ops.launch_count()
        kc, kw = ops.jsq_route(w, gaps, svc, live, impl="cuda")
        if ops.launch_count() != before + 1:
            raise AssertionError("the JSQ call did not launch the kernel once")
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
        plan = kernel.jsq_plan(R, P, w.element_size())
        ms = _time_ms(lambda: kernel.jsq_route_cuda(w, gaps, svc, live),
                      n=20)
        print(f"    {dtype} [{card}]: {ms:.4f} ms a chunk (mean of 20), "
              f"{ms * 1e6 / CHUNK:.1f} ns a step; plan: tracker in "
              f"{'registers' if plan.registers else 'shared memory'}, "
              f"32 lanes x {plan.per} servers, "
              f"{'redux.sync' if dtype == torch.float32 else 'shuffle'} "
              f"warp max, "
              f"{plan.tile}-query tiles")
        if dtype != torch.float32:
            continue
        plain_ms = _time_ms(lambda: ops.jsq_route(w, gaps, svc, live,
                                                  impl="torch"),
                            n=2, warm=0)
        moved = ((w.numel() * 2 + gaps.numel() + svc.numel()
                  + live.numel()) * w.element_size() + kc.numel() * 8)
        # per query and scenario: drain (sub, max) and reduce over r x p,
        # argmin over r, deposit (mul, add) over p
        n_ops = N_SCEN * CHUNK * (3 * R * P + R + 2 * P)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / FP32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"  at ({N_SCEN}, r={R}, p={P}, {CHUNK}) float32 [{card}]: "
              f"kernel {ms:.4f} ms (mean of 20)  plain loop "
              f"{plain_ms:.1f} ms  library: none  bound "
              f"{bound_ms:.4f} ms ({moved / 1e6:.1f} MB at 3.35 TB/s; "
              f"the chain is {CHUNK} dependent steps, "
              f"{ms * 1e6 / CHUNK:.1f} ns each)")
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


SAMPLE_SHAPES = ((256, P, CHUNK),       # the benchmark cells' chunk
                 (N_SCEN, P, CHUNK))    # the main path's


def phase_sample_kernel(card: str) -> dict:
    """The service sampler against the plain draws (torch's generators,
    the broadcast products, the mixture), bit for bit, in cache and
    exponential mode at the benchmark cells' and the main path's chunk,
    each scenario its own means and hit ratio."""
    import dataclasses
    import torch
    from repro_torch.core import capacity, simulator
    print("== phase 5c: service sampler vs plain draws on the card")
    report = None
    for shape in SAMPLE_SHAPES:
        n_scen, p, n = shape
        gen = torch.Generator().manual_seed(n_scen)

        def spread(lo, hi):
            return lo + (hi - lo) * torch.rand(n_scen, generator=gen,
                                               dtype=torch.float64)
        params = simulator._vec_params(dataclasses.replace(
            capacity.TABLE5_PARAMS, s_hit=spread(1e-3, 9e-3),
            s_miss=spread(5e-3, 2e-2), s_disk=spread(1e-3, 3e-2),
            hit=spread(0.05, 0.95)), torch.device("cuda"), torch.float32)
        for mode in ("cache", "exponential"):
            seed = simulator._mix(5, n_scen, p, n)

            def run(impl):
                return simulator.sample_service_times_batch(
                    seed, n_scen, n, p, params, mode, device="cuda",
                    impl=impl)
            before = _sample_counts()
            got = run("cuda")
            after = _sample_counts()
            want = run("torch")
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want))
            steps = {k: after[k] - before[k] for k in after}
            if not same or steps != {"service_sample": 1, "plain": 0}:
                raise AssertionError(f"5c {shape} {mode}: kernel equals the "
                                     f"plain draws: {same}; counts {steps}")
            ms = _device_ms(lambda: run("cuda"), n=20)
            plain_ms = _time_ms(lambda: run("torch"), n=5, warm=1)
            bound_ms = got.numel() * 4 / HBM_BYTES_PER_S * 1e3
            print(f"  {str(shape):18s} {mode:11s} equal bit for bit; kernel "
                  f"{ms:.4f} ms (device, mean of 20)  plain draws "
                  f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms (one 4-byte "
                  f"write an element at 3.35 TB/s), {100 * bound_ms / ms:.1f}"
                  f" % [{card}]")
            if report is None:
                report = {"name": "service_sample", "route": "cuda",
                          "source": "src/repro_torch/kernels/service_sample/"
                                    "csrc/service_sample.cu",
                          "replaces": "src/repro/core/simulator.py:360 "
                                      "(jax.random and XLA ops, no Pallas "
                                      "kernel)",
                          "launches": None, "max_abs_err": 0.0, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": "bytes", "library_ms": None}
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
                  "jsq_route": N_CHUNKS if routing == "jsq" else 0,
                  "fleet_scan": 0}
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


def phase_memory_law(card: str, telemetry=None) -> dict:
    """Fused peak memory against r: the slope per replica stays under the
    reference's allowance of 10 S x p x chunk float32 buffers (with
    ``telemetry``, phase 18a's run of the same law).  Returns the peaks
    above baseline by r."""
    import torch
    from repro_torch.core import simulator
    from repro_torch.core.cluster import ClusterSpec
    print("== phase 7: r-free memory law of the fused engine"
          + ("" if telemetry is None else f", with telemetry ({telemetry})"))
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
                                result_cache=RESULT_CACHE),
            telemetry=telemetry)
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
    return peaks


# ------------------------------------------------------------ LM serving
HEADS, KV_HEADS, D_HEAD = 32, 8, 128   # Qwen3-8B's attention
SLOTS, MAX_SEQ, MAX_NEW = 8, 4096, 32
MAX_NEW21 = 16            # phase 21's new tokens a request (cut 32 -> 16
                          # for the run's time)
PROMPTS = (512, 1024, 1536, 2048) * 3
PROFILE_PROMPT, CHECK_PROMPT = 512, 128   # phases 10b and 11
# Attention kernels against their plain version in float32 on the same
# values: the largest relative L2 error of one output row (one query and
# head, D values), so the limit scales with the output, which shrinks as
# (positions)^-1/2 (~0.01 at 32k positions; an absolute limit would not).
# bfloat16 rounds at u = 2^-8: the output's rounding gives ~u/sqrt(3) a
# row, the bf16 probabilities of the flash kernel's mma products as much
# again; 1e-2 holds both in the worst row, and fails a kernel that drops
# one split of positions or one K tile (0.2 and more), or even one of
# 32k positions (~0.02, where a row's softmax is peaked).  float32: 1e-4 holds
# float32 rounding over 32k-term sums, and fails anything rounded to
# bfloat16 on the way (>= 1e-3).
ATTN_ROW_RTOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-4}
# Logits of two paths through the whole model, relative L2 error.
# bfloat16 keeps 8 significant bits (relative rounding up to 2^-9); the
# kernel path and the plain prefill round at different places (matmul
# shapes M = 8 vs M = 8 x S, the attention kernels), and a few such
# roundings per layer compound over 36 layers as a random walk to a few
# per cent: 5e-2.  float32 rounds at 2^-24: 1e-4 holds float32 rounding
# with room, and fails anything computed in bfloat16 (~4e-3 per op).
BF16_LOGITS_RTOL = 5e-2
F32_LOGITS_RTOL = 1e-4
PLAN_RATE, PLAN_SLO = 500.0, 0.6   # examples/plan_llm_serving.py, decode


def _attn_check(out, expect, dtype, what) -> float:
    """The largest relative L2 error of an output row against the plain
    version's float32 output, held to ATTN_ROW_RTOL; returns max abs
    err."""
    tol = ATTN_ROW_RTOL[str(dtype)]
    diff = out.float() - expect
    row_err = float((diff.norm(dim=-1) / expect.norm(dim=-1)).max())
    abs_err = float(diff.abs().max())
    print(f"  {what}: max row relative L2 err {row_err:.3e} (limit {tol:g}),"
          f" max abs err {abs_err:.3e}, output std "
          f"{float(expect.std()):.3e}")
    if not row_err <= tol:
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version by {row_err} > {tol} (row relative "
                             "L2)")
    return abs_err


def _sdpa(q, k, v, **kw):
    """The library yardstick, timed only: one SDPA call on the model
    layout's (B, heads, S, D) views.  Returns (fn, note)."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
        return (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **kw)), "enable_gqa=True"
    except TypeError:            # torch without enable_gqa
        rep = q.shape[2] // k.shape[2]
        kr, vr = (x.repeat_interleave(rep, dim=1) for x in (kt, vt))
        torch.cuda.synchronize()
        return (lambda: F.scaled_dot_product_attention(qt, kr, vr, **kw)), \
            "K/V repeat_interleave'd first (no enable_gqa)"


def phase_flash_kernel(card: str) -> dict:
    """The flash kernel against its plain version at the prefill's
    shapes (one prompt, Qwen3-8B's heads), then timings at S = 2048."""
    import torch
    from repro_torch.kernels.flash_attention import kernel, ops
    print("== phase 8: flash-attention kernel vs plain version on the card")
    _ptxas_report(kernel.LIB)
    _tile_check("phase 8")
    gen = torch.Generator(device="cuda").manual_seed(8)
    main = None
    for s, dtype in itertools.product((2048, 1000),
                                      (torch.bfloat16, torch.float32)):
        q = torch.randn((1, s, HEADS, D_HEAD), generator=gen,
                        device="cuda").to(dtype)
        k, v = (torch.randn((1, s, KV_HEADS, D_HEAD), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        out = ops.flash_attention(q, k, v, impl="cuda")
        expect = ops.flash_attention(q.float(), k.float(), v.float(),
                                     impl="torch")
        torch.cuda.synchronize()
        err = _attn_check(out, expect, dtype,
                          f"(1, {s}, {HEADS}, {KV_HEADS}, {D_HEAD}) {dtype}")
        if s == 2048 and dtype == torch.bfloat16:
            main = (q, k, v, err)
    # the reference's other heads: granite-moe-3b-a800m (G 3, D 64),
    # command-r-plus-104b (G 12, D 128), their SMOKE sizes' D 8
    for s, h, kv, d in ((1000, 24, 8, 64), (1000, 96, 8, 128),
                        (300, 6, 2, 8), (300, 8, 2, 8)):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((1, s, h, d), generator=gen,
                            device="cuda").to(dtype)
            k, v = (torch.randn((1, s, kv, d), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            out = ops.flash_attention(q, k, v, impl="cuda")
            expect = ops.flash_attention(q.float(), k.float(), v.float(),
                                         impl="torch")
            torch.cuda.synchronize()
            _attn_check(out, expect, dtype,
                        f"(1, {s}, {h}, {kv}, {d}) G={h // kv} {dtype}")
    q, k, v, main_err = main
    b, s, h, d = q.shape
    ms = _device_ms(lambda: kernel.flash_attention_cuda(q, k, v), n=20)
    plain_ms = _device_ms(lambda: ops.flash_attention(q, k, v,
                                                      impl="torch"), n=5)
    library, note = _sdpa(q, k, v, is_causal=True)
    library_ms = _device_ms(library, n=20)
    flops = 4 * b * h * d * s * (s + 1) // 2     # QK^T and PV, causal pairs
    moved = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"  at (1, {s}, {h}, {KV_HEADS}, {d}) bfloat16 causal, one layer, "
          f"device time [{card}]:")
    print(f"    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  SDPA "
          f"({note}) {library_ms:.4f} ms  bound {bound_ms:.4f} ms "
          f"({flops / 1e9:.1f} GFLOP at 989 TFLOP/s; {moved / 1e6:.1f} MB "
          f"= {bytes_ms:.4f} ms); kernel at "
          f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:84",
            "launches": None, "max_abs_err": main_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms}


def phase_decode_kernel(card: str) -> dict:
    """The decode kernel against its plain version: the serving batch at
    ~2100 positions, and decode_32k's sequence at a one-chip batch."""
    import torch
    from repro_torch.kernels.decode_attention import kernel, ops
    print("== phase 9: decode-attention kernel vs plain version on the card")
    gen = torch.Generator(device="cuda").manual_seed(9)
    # the reference's other heads: granite-moe-3b-a800m (G 3, D 64),
    # command-r-plus-104b (G 12, D 128), their SMOKE sizes' D 8 (G 3, 4)
    for b, s, length, h, kv, d in ((8, 4096, 2100, 24, 8, 64),
                                   (8, 4096, 2100, 96, 8, 128),
                                   (4, 1000, 777, 6, 2, 8),
                                   (4, 1000, 999, 8, 2, 8)):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, 1, h, d), generator=gen,
                            device="cuda").to(dtype)
            k, v = (torch.randn((b, s, kv, d), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            before = ops.launch_count()
            out = ops.decode_attention(q, k, v, length, impl="cuda")
            if ops.launch_count() != before + 1:
                raise AssertionError("a decode call did not launch once")
            expect = ops.decode_attention(q.float(), k.float(), v.float(),
                                          length, impl="torch")
            torch.cuda.synchronize()
            _attn_check(out, expect, dtype, f"B={b} S={s} length={length} "
                        f"G={h // kv} D={d} {dtype}")
    report = None
    for b, s, length, dtype in ((8, 4096, 2100, torch.bfloat16),
                                (8, 4096, 2100, torch.float32),
                                (8, 32768, 32767, torch.bfloat16)):
        q = torch.randn((b, 1, HEADS, D_HEAD), generator=gen,
                        device="cuda").to(dtype)
        k, v = (torch.randn((b, s, KV_HEADS, D_HEAD), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        before = ops.launch_count()
        out = ops.decode_attention(q, k, v, length, impl="cuda")
        if ops.launch_count() != before + 1:
            raise AssertionError("a decode call did not launch once")
        expect = ops.decode_attention(q.float(), k.float(), v.float(),
                                      length, impl="torch")
        torch.cuda.synchronize()
        what = f"B={b} S={s} length={length} {dtype}"
        err = _attn_check(out, expect, dtype, what)
        if dtype == torch.float32:
            continue
        def call():
            return kernel.decode_attention_cuda(q, k, v, length)
        ms = _device_ms(call)
        host_ms = _time_ms(call)
        plain_ms = _device_ms(lambda: ops.decode_attention(
            q, k, v, length, impl="torch"), n=3)
        mask = (torch.arange(s, device="cuda") <= length).view(1, 1, 1, s)
        library, note = _sdpa(q, k, v, attn_mask=mask)
        library_ms = _device_ms(library, n=10)
        n = length + 1
        moved = (2 * b * n * KV_HEADS * D_HEAD + 2 * q.numel()) \
            * q.element_size()
        flops = 4 * b * HEADS * n * D_HEAD
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        chunk, splits = kernel.split_plan(
            n, b * KV_HEADS, torch.cuda.get_device_properties(0)
            .multi_processor_count)
        before = ops.launch_count()
        call()
        if ops.launch_count() != before + 1:
            raise AssertionError("a decode call did not launch once")
        print(f"    one layer, device time [{card}]: kernel {ms:.4f} ms "
              f"({host_ms:.4f} ms a call back to back, its host cost "
              f"included)  plain "
              f"{plain_ms:.4f} ms  SDPA with a boolean mask ({note}) "
              f"{library_ms:.4f} ms  bound {bound_ms:.4f} ms "
              f"({moved / 1e6:.1f} MB of K/V at 3.35 TB/s); kernel at "
              f"{moved / (ms * 1e-3) / 1e9:.0f} GB/s "
              f"({100 * bound_ms / ms:.0f} % of the bound); one launch a "
              f"call, {splits} splits of {chunk} positions")
        if report is None:
            report = {"name": "decode_attention", "route": "cuda",
                      "source": "src/repro_torch/kernels/decode_attention/"
                                "csrc/decode_attention.cu",
                      "replaces": "src/repro/kernels/decode_attention/"
                                  "kernel.py:69",
                      "launches": None, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": ("bytes" if bytes_ms >= ops_ms
                                   else "operations"),
                      "library_ms": library_ms}
    return report


def _kv_bytes(cfg, rows: int, positions: int) -> int:
    """K and V of ``positions`` cache positions for ``rows`` sequences,
    all layers, in the config's dtype."""
    return (2 * cfg.n_layers * rows * positions * cfg.n_kv_heads
            * cfg.d_head * (2 if cfg.dtype == "bfloat16" else 4))


def phase_lm_server(card: str) -> dict:
    """`LMServer` at Qwen3-8B's full width: 12 requests through 8 slots,
    admitted as slots free (continuous batching), greedy decoding."""
    from repro_torch.configs import qwen3_8b
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import LMServer
    cfg = qwen3_8b.FULL
    print(f"== phase 10: LMServer, {cfg.name} at full width ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads, vocab {cfg.vocab_padded}), {cfg.dtype}, random weights "
          f"(seed 0); {SLOTS} slots, max_seq {MAX_SEQ}, {len(PROMPTS)} "
          f"requests of {sorted(set(PROMPTS))} prompt tokens, {MAX_NEW} new "
          "tokens each")
    t0 = time.perf_counter()
    model = T.init_params(0, cfg)
    srv = LMServer(cfg, model, slots=SLOTS, max_seq=MAX_SEQ)
    return _serve_requests(card, cfg, model, srv, t0)


def _serve_requests(card: str, cfg, model, srv, t0: float,
                    max_new: int = MAX_NEW) -> dict:
    """Drive ``srv`` (weights drawn since ``t0``): a warm-up request, then
    the PROMPTS requests of ``max_new`` new tokens admitted as slots free,
    greedy decoding; the attention launches asserted, tokens/s and the
    step against its bytes bound printed."""
    import numpy as np
    import torch
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    # a decode step reads every weight once (an MoE layer every expert's:
    # the expert products are dense over the experts), but of the
    # embedding table only the SLOTS rows it gathers
    step_weight_bytes = weight_bytes - model.embed.element_size() * (
        model.embed.numel() - SLOTS * cfg.d_model)
    print(f"  weights {weight_bytes / 1e9:.2f} GB and cache "
          f"{_kv_bytes(cfg, SLOTS, MAX_SEQ) / 1e9:.2f} GB allocated and drawn "
          f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(10)
    # warm-up (cuBLAS handles, allocator, first launches), uncounted
    srv.admit(-1, rng.integers(0, cfg.vocab_size, 64).astype(np.int32), 2)
    while srv.step():
        pass
    srv.completed.clear()

    queue = [(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
              max_new) for i, n in enumerate(PROMPTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    prefill_s = 0.0
    admits, decode_tokens, step_s, step_bound_s, lens = 0, 0, [], [], []
    while queue or any(sl.remaining > 0 for sl in srv.slots):
        while queue:
            t0 = time.perf_counter()
            if not srv.admit(*queue[0]):     # admit syncs (first token)
                break
            prefill_s += time.perf_counter() - t0
            queue.pop(0)
            admits += 1
        _, length = srv.decode_inputs()
        t0 = time.perf_counter()
        active = srv.step()                  # step syncs (greedy tokens)
        step_s.append(time.perf_counter() - t0)
        decode_tokens += active
        lens.append(length)
        step_bound_s.append((step_weight_bytes
                             + _kv_bytes(cfg, SLOTS, length + 1))
                            / HBM_BYTES_PER_S)
    decode_s = sum(step_s)
    peak = torch.cuda.max_memory_allocated()
    counts = _attention_counts()
    steps = len(step_s)
    done = {c["req_id"]: c["tokens"] for c in srv.completed}
    want = {i: n + 1 + max_new for i, n in enumerate(PROMPTS)}
    if {i: len(t) for i, t in done.items()} != want:
        raise AssertionError(f"completions {sorted(done)} with lengths "
                             f"{[len(t) for t in done.values()]}, expected "
                             f"{want}")
    expect = {"flash_attention": cfg.n_layers * admits,
              "decode_attention": cfg.n_layers * steps, "plain": 0}
    if counts != expect:
        raise AssertionError(f"attention launches {counts}, expected "
                             f"{expect} ({admits} admits, {steps} steps)")
    mean_step = decode_s / steps
    mean_bound = sum(step_bound_s) / steps
    print(f"  {admits} admits, {steps} decode steps; launches {counts} "
          f"[{card}]")
    print(f"  prefill: {sum(PROMPTS)} tokens in {prefill_s:.3f} s = "
          f"{sum(PROMPTS) / prefill_s:.0f} tokens/s")
    print(f"  decode: {decode_tokens} tokens in {decode_s:.3f} s = "
          f"{decode_tokens / decode_s:.1f} tokens/s; {mean_step * 1e3:.2f} "
          f"ms per step (median {sorted(step_s)[steps // 2] * 1e3:.2f}, "
          f"cache length {min(lens)}..{max(lens)}) against a bound of "
          f"{mean_bound * 1e3:.2f} ms ({step_weight_bytes / 1e9:.2f} GB of "
          f"weights, the embedding's {SLOTS} gathered rows only, + K/V read "
          "at 3.35 TB/s)")
    print(f"  peak memory {peak / 1e9:.2f} GB (weights "
          f"{weight_bytes / 1e9:.2f} GB, cache "
          f"{_kv_bytes(cfg, SLOTS, MAX_SEQ) / 1e9:.2f} GB)")
    return {"cfg": cfg, "model": model, "srv": srv, "rng": rng,
            "counts": counts, "step_s": mean_step,
            "mean_len": sum(lens) / steps,
            "step_weight_bytes": step_weight_bytes,
            "decode_tok_s": decode_tokens / decode_s}


def phase_lm_profile(card: str, lm: dict, phase: str = "10b") -> dict:
    """Where a decode step's time goes: 8 fresh prompts, 4 steps timed,
    then the same 4-step window under the profiler."""
    import numpy as np
    srv, cfg, rng = lm["srv"], lm["cfg"], lm["rng"]
    for i in range(SLOTS):
        if not srv.admit(100 + i, rng.integers(0, cfg.vocab_size,
                                               PROFILE_PROMPT)
                         .astype(np.int32), 14):
            raise AssertionError("a slot did not free up")
    srv.step()
    srv.step()

    def four():
        for _ in range(4):
            srv.step()
    wall = _wall(four)
    traced = phase_profile(card, wall, four,
                           f"phase {phase}: device time by kernel, 4 decode "
                           "steps "
                           f"({cfg.name}, {SLOTS} slots, cache length "
                           f"~{PROFILE_PROMPT + 4})")
    attn = {k: v for k, v in traced.items() if "decode_mma_kernel" in k}
    if not attn or any("combine" in k for k in traced):
        raise AssertionError("the decode steps' trace lists no decode "
                             "attention kernel, or a combine kernel: "
                             f"{sorted(traced)[:20]}")
    busy = sum(ms for ms, _ in traced.values())
    attn_ms = sum(ms for ms, _ in attn.values())
    launches = sum(n for _, n in attn.values())
    print(f"  decode attention: {attn_ms:.3f} ms in {launches} launches "
          f"(one a layer a step, no combine kernel), "
          f"{100 * attn_ms / busy:.1f} % of the steps' device time, "
          f"{attn_ms / 4:.3f} ms a step [{card}]")
    return traced


def _logits_through_cache(model, cfg, prompts, steps: int = 3):
    """Prefill ``prompts`` and decode ``steps`` greedy tokens through the
    cache (the kernel path); hold each step's logits against the plain
    path's prefill over the whole sequence so far.  Returns the relative
    L2 errors."""
    import torch
    from repro_torch.models import transformer as T
    b, s = prompts.shape
    logits, pre = T.prefill(model, cfg, prompts, chunk=s)
    cache = T.init_kv_cache(cfg, b, s + steps)
    cache["k"][:, :, :s], cache["v"][:, :, :s] = pre["k"], pre["v"]
    cache["len"] = s
    seq, errs = prompts, []
    for _ in range(steps):
        nxt = logits[:, -1].argmax(dim=-1, keepdim=True)
        seq = torch.cat([seq, nxt], dim=1)
        logits, cache = T.decode_step(model, cfg, nxt, cache)
        plain, _ = T.prefill(model, cfg, seq, chunk=seq.shape[1],
                             impl="torch")
        errs.append(_rel_l2(logits[:, 0], plain[:, 0]))
    return errs


def _logits_kernel_vs_plain(model, cfg, prompts, steps: int = 3):
    """Prefill ``prompts`` and decode ``steps`` greedy tokens twice, each
    path through its own cache: the kernels, and impl="torch"; returns
    the relative L2 errors of the prefill's and each step's logits.  An
    MoE model's expert capacity grows with the routing group's length,
    so its cached steps (one token a group) and a prefill over the whole
    sequence drop different tokens: the two paths are held on the same
    computation instead."""
    import torch
    from repro_torch.models import transformer as T
    b, s = prompts.shape
    caches, logits = [], []
    for impl in ("auto", "torch"):
        lg, pre = T.prefill(model, cfg, prompts, chunk=s, impl=impl)
        cache = T.init_kv_cache(cfg, b, s + steps)
        cache["k"][:, :, :s], cache["v"][:, :, :s] = pre["k"], pre["v"]
        cache["len"] = s
        caches.append(cache)
        logits.append(lg)
    errs = [_rel_l2(logits[0][:, -1], logits[1][:, -1])]
    for _ in range(steps):
        nxt = logits[1][:, -1].argmax(dim=-1, keepdim=True)
        for j, impl in enumerate(("auto", "torch")):
            logits[j], caches[j] = T.decode_step(model, cfg, nxt, caches[j],
                                                 impl=impl)
        errs.append(_rel_l2(logits[0][:, 0], logits[1][:, 0]))
    del caches
    torch.cuda.empty_cache()
    return errs


def _rel_l2(x, y) -> float:
    return float((x.float() - y.float()).norm() / y.float().norm())


def phase_lm_correctness(card: str, lm: dict) -> None:
    """Full-width logits through the kernel path against the plain path."""
    print("== phase 11: full-width logits, kernel path vs plain path")
    _check_cache_path(card, lm["cfg"], lm["model"], "1.")
    _check_f32_layers(card, lm["cfg"], "2.")
    _check_server_step(card, lm["cfg"], lm["model"], lm["srv"], "3.")


def _model_paths(model, cfg, prompts):
    """(relative L2 errors, what was compared) of the kernel path against
    the plain path: a dense model's cache against the plain prefill of
    the whole sequence, an MoE model's two paths step by step."""
    if cfg.moe is None:
        return (_logits_through_cache(model, cfg, prompts),
                "3 steps through the cache vs plain prefill of the whole "
                "sequence")
    return (_logits_kernel_vs_plain(model, cfg, prompts),
            "prefill + 3 steps, kernels vs impl=\"torch\", each through "
            "its own cache")


def _check_prompts(cfg):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(11)
    return torch.randint(0, cfg.vocab_size, (SLOTS, CHECK_PROMPT),
                         device="cuda", generator=gen)


def _check_cache_path(card: str, cfg, model, label: str) -> None:
    """Prefill and 3 steps through the cache (the kernels) against the
    plain prefill of the whole sequence, in the model's bfloat16; an MoE
    model against the plain path's own prefill and steps
    (`_logits_kernel_vs_plain`)."""
    errs, how = _model_paths(model, cfg, _check_prompts(cfg))
    print(f"  {label} {cfg.name} bfloat16, {SLOTS} equal {CHECK_PROMPT}-"
          f"token prompts, {how}: relative L2 "
          f"{', '.join(f'{e:.2e}' for e in errs)} (limit "
          f"{BF16_LOGITS_RTOL:g}) [{card}]")
    if not max(errs) <= BF16_LOGITS_RTOL:
        raise AssertionError(f"{cfg.name}: bfloat16 logits differ by "
                             f"{max(errs)}")


def _check_f32_layers(card: str, cfg, label: str) -> None:
    """The same check on a 2-layer float32 model at the config's width."""
    import dataclasses
    from repro_torch.models import transformer as T
    cfg2 = dataclasses.replace(cfg, name=f"{cfg.name}-2-layer-f32",
                               n_layers=2, dtype="float32")
    model2 = T.init_params(1, cfg2)
    errs, _ = _model_paths(model2, cfg2, _check_prompts(cfg))
    print(f"  {label} {cfg2.name} (full width), same check: relative L2 "
          f"{', '.join(f'{e:.2e}' for e in errs)} (limit "
          f"{F32_LOGITS_RTOL:g}) [{card}]")
    if not max(errs) <= F32_LOGITS_RTOL:
        raise AssertionError(f"{cfg2.name}: float32 logits differ by "
                             f"{max(errs)}")


def _check_server_step(card: str, cfg, model, srv, label: str) -> None:
    """The server's next decode step, kernels against impl="torch"."""
    from repro_torch.models import transformer as T
    cur, length = srv.decode_inputs()
    cache = {"k": srv.cache["k"], "v": srv.cache["v"], "len": length}
    plain, _ = T.decode_step(model, cfg, cur, cache, impl="torch")
    kern, _ = T.decode_step(model, cfg, cur, cache)
    err = _rel_l2(kern[:, 0], plain[:, 0])
    print(f"  {label} the server's next step (cache length {length}), "
          f"kernel vs impl=\"torch\": relative L2 {err:.2e} (limit "
          f"{BF16_LOGITS_RTOL:g}) [{card}]")
    if not err <= BF16_LOGITS_RTOL:
        raise AssertionError(f"{cfg.name}: server step logits differ by "
                             f"{err}")


def phase_planner(card: str, lm: dict) -> None:
    """The serving planner on one decode step: counted FLOPs and bytes on
    H100_SXM, and the measured step, as one-chip cells of batch 8."""
    from repro_torch.core import planner
    print("== phase 12: serving planner on the decode step")
    cfg = lm["cfg"]
    n = lm["mean_len"] + 1
    flops = (2 * (cfg.n_params - cfg.vocab_size * cfg.d_model) * SLOTS
             + 4 * SLOTS * cfg.n_heads * n * cfg.d_head * cfg.n_layers)
    nbytes = lm["step_weight_bytes"] + _kv_bytes(cfg, SLOTS, n)
    counted = planner.terms_from_analysis(
        hlo_flops=flops, hlo_bytes=nbytes, collective_bytes=0.0, n_chips=1,
        hw=planner.H100_SXM)
    measured = planner.RooflineTerms(compute_s=0.0, memory_s=lm["step_s"],
                                     collective_s=0.0)
    for what, terms in (("counted bound", counted),
                        ("measured step", measured)):
        model = planner.ServingModel(name=f"{cfg.name} decode, {what}",
                                     terms=terms, n_chips=1,
                                     batch_per_step=SLOTS)
        plan = planner.plan_serving(model, PLAN_RATE, PLAN_SLO)
        print(f"  {what}: step {terms.step_time_lower_bound * 1e3:.2f} ms "
              f"({terms.bound}-bound) -> {plan.cells} cells for "
              f"{PLAN_RATE:g} req/s under {PLAN_SLO * 1e3:.0f} ms: "
              f"{plan.per_cell_rate:.1f} req/s a cell, utilization "
              f"{plan.utilization:.3f}, response <= "
              f"{plan.response_upper_ms:.1f} ms [{card}]")
        if plan.cells < 1:
            raise AssertionError(f"{what}: no feasible plan")


# ------------------------------------------------------------ CTR serving
REC_P99, REC_BULK, N_P99 = 512, 262_144, 4   # serve_p99, serve_bulk
CIN_BATCHES = (512, 4096, 1000, 3)   # p99, a larger batch, B D ragged,
                                     # tiny (512 and 3 split K)
CIN_BULK_SLICE = 4096   # serve_bulk samples the plain CIN can hold
# Kernels against their plain version's float32 output on the same values,
# the largest relative L2 error of one output row: a bag's D values, a
# sample's O x D CIN outputs (a row of D = 10 can cancel to near zero; a
# sample's 2,000 values cannot).  A bag of bfloat16 rows sums in float32
# and rounds once (2^-9); the CIN kernel rounds each product and the
# output to bfloat16 (~2^-9 each, the products' errors averaging out over
# K terms): 1e-2 holds both, and fails a kernel that drops one of a bag's
# rows (~0.25 and more) or one (h, j) slice of K (~0.1).  float32: the bag
# sums up to 4 rows in the plain version's order (1e-5); the CIN sums K =
# 7,800 products in another order than the plain einsum (1e-4).
BAG_ROW_RTOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-5}
CIN_ROW_RTOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-4}


def _row_check(out, expect, tol, what, row_dims: int = 1) -> float:
    """The largest relative L2 error of a row (the last ``row_dims`` axes)
    against the plain version's float32 output, held to ``tol``; a row
    that should be all zeros must be exactly zero.  Returns max abs err."""
    diff = (out.float() - expect).flatten(start_dim=expect.ndim - row_dims)
    ref = expect.flatten(start_dim=expect.ndim - row_dims)
    num, den = diff.norm(dim=-1), ref.norm(dim=-1)
    zero = den == 0
    # rows that should be zeros are checked apart: exactly zero
    row_err = float((num / den.masked_fill(zero, 1.0)).masked_fill(zero, 0.0)
                    .max())
    abs_err = float(diff.abs().max())
    print(f"  {what}: max row relative L2 err {row_err:.3e} (limit {tol:g}),"
          f" max abs err {abs_err:.3e}, {int(zero.sum())} all-zero rows "
          f"exact: {not bool((num[zero] > 0).any())}")
    if not row_err <= tol or bool((num[zero] > 0).any()):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version by {row_err} > {tol} (row relative "
                             "L2), or a zero row is not zero")
    return abs_err


def _ctr_batches(cfg):
    """N_P99 serve_p99 batches and one serve_bulk batch of ctr_batch
    requests on the card: (ids int32, mask bool) each, made before any
    timed window (step i for the i-th, seed 0)."""
    import numpy as np
    import torch
    from repro_torch.data.recsys_data import ctr_batch
    t0 = time.perf_counter()
    out = []
    for step, b in enumerate((REC_P99,) * N_P99 + (REC_BULK,)):
        ids, mask, _ = ctr_batch(cfg, b, step=step, seed=0)
        out.append((torch.from_numpy(ids.astype(np.int32)).to(device="cuda"),
                    torch.from_numpy(mask).to(device="cuda")))
    torch.cuda.synchronize()
    print(f"  {N_P99} x {REC_P99} + 1 x {REC_BULK} ctr_batch requests made "
          f"and moved to the card in {time.perf_counter() - t0:.1f} s "
          "(set-up, outside every timed window)")
    return out


def _bag_bytes(table, ids, mask):
    """Bytes of one embedding-bag call: (distinct valid rows once; valid
    ids, mask and output; the valid rows as gathered; the same at 32-byte
    sectors)."""
    import torch
    valid = ids[mask].long()
    row_bytes = table.shape[1] * table.element_size()
    first = valid * row_bytes
    sectors = (first + row_bytes - 1) // 32 - first // 32 + 1
    rest = (valid.numel() * ids.element_size() + mask.numel()
            + ids[..., 0].numel() * row_bytes)
    return (torch.unique(valid).numel() * row_bytes, rest,
            valid.numel() * row_bytes, int(sectors.sum()) * 32)


def phase_bag_kernel(card: str, table, wide, batches) -> dict:
    """The embedding-bag kernel against its plain version: the model's
    33.8 M-row tables (D = 10 and the wide D = 1) with ctr_batch ids (int32
    and int64), D = 16, float32, a non-prefix mask with an all-masked bag
    and ids past the table's end under the mask; then timings of both
    tables' calls at both serving batches."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import kernel, ops, ref
    print("== phase 13: embedding-bag kernel vs plain version on the card")
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = table.shape[0]
    (p_ids, p_mask), (b_ids, b_mask) = batches[0], batches[-1]
    # a non-prefix mask; bag (0, 0) all masked; past-the-end ids under it
    odd_mask = torch.rand(p_mask.shape, generator=gen, device="cuda") < 0.5
    odd_mask[0, 0] = False
    odd_ids = torch.where(odd_mask, p_ids, rows + 12_345)
    t32 = table.float()
    cases = [("D=10 bf16, serve_p99", table, t32, p_ids, p_mask),
             ("D=10 bf16, serve_bulk", table, t32, b_ids, b_mask),
             ("D=1 bf16 (wide), serve_p99", wide, wide.float(), p_ids,
              p_mask),
             ("D=1 bf16 (wide), serve_bulk", wide, wide.float(), b_ids,
              b_mask),
             ("D=10 bf16, serve_bulk, int64 ids", table, t32, b_ids.long(),
              b_mask),
             ("D=10 float32, serve_p99", t32, t32, p_ids, p_mask),
             ("D=10 bf16, non-prefix mask, an empty bag, past-the-end ids "
              "masked", table, t32, odd_ids, odd_mask)]
    t16 = (0.01 * torch.randn((1 << 20, 16), generator=gen, device="cuda")
           ).to(torch.bfloat16)
    ids16 = torch.randint(0, 1 << 20, p_ids.shape, generator=gen,
                          device="cuda", dtype=torch.int32)
    cases.append(("D=16 bf16, 2^20 rows", t16, t16.float(), ids16, p_mask))
    for what, tab, tab32, ids, mask in cases:
        out = ops.embedding_bag(tab, ids, mask, impl="cuda")
        expect = ref.embedding_bag_masked(tab32, ids, mask)
        torch.cuda.synchronize()
        err = _row_check(out, expect, BAG_ROW_RTOL[str(tab.dtype)], what)
        if what == "D=10 bf16, serve_bulk":
            main_err = err
    del t32, t16
    report = None
    for (what, (ids, mask)), (d_what, tab) in itertools.product(
            (("serve_p99", batches[0]), ("serve_bulk", batches[-1])),
            (("D = 10 bf16", table), ("D = 1 bf16 (wide)", wide))):
        ms = _device_ms(lambda: kernel.embedding_bag_cuda(tab, ids, mask))
        plain_ms = _device_ms(lambda: ops.embedding_bag(tab, ids, mask,
                                                        impl="torch"), n=5)
        flat = ids[mask]
        counts = mask.sum(-1).flatten()
        offsets = torch.cumsum(counts, 0) - counts
        library_ms = _device_ms(lambda: F.embedding_bag(
            flat, tab, offsets, mode="mean"))
        distinct, other, gathered, sectors = _bag_bytes(tab, ids, mask)
        least = distinct + other
        bound_ms = least / HBM_BYTES_PER_S * 1e3
        print(f"  {what} (B = {ids.shape[0]}, {flat.numel()} valid ids), "
              f"{d_what}, {kernel.bag_plan(tab, ids, mask)}, device time "
              f"[{card}]:")
        print(f"    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"F.embedding_bag(mode='mean') {library_ms:.4f} ms  bound "
              f"{bound_ms:.4f} ms ({least / 1e6:.2f} MB: distinct rows, "
              f"valid ids, mask, output at 3.35 TB/s; DRAM traffic, as hot "
              f"rows stay in L2; {100 * bound_ms / ms:.1f} %); gathered "
              f"rows {gathered / 1e6:.2f} MB "
              f"({(gathered + other) / HBM_BYTES_PER_S * 1e3:.4f} ms with "
              f"the rest), at 32-byte sectors {sectors / 1e6:.2f} MB "
              f"({(sectors + other) / HBM_BYTES_PER_S * 1e3:.4f} ms)")
        if what == "serve_bulk" and tab is table:
            report = {"name": "embedding_bag", "route": "cuda",
                      "source": "src/repro_torch/kernels/embedding_bag/"
                                "csrc/embedding_bag.cu",
                      "replaces": "src/repro/kernels/embedding_bag/"
                                  "kernel.py:47",
                      "launches": None, "max_abs_err": main_err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": "bytes", "library_ms": library_ms}
    return report


def _cin_inputs(b, hk, m, d, o, dtype, gen):
    import torch
    xk, x0 = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
              for shape in ((b, hk, d), (b, m, d)))
    w = (torch.randn((hk * m, o), generator=gen, device="cuda")
         * (hk * m) ** -0.5).to(dtype)
    return xk, x0, w


def _cin_costs(b, hk, m, d, o, el):
    """(FLOP, bytes: xk, x0, W read once, y written once) of a layer."""
    flops = 2 * b * d * hk * m * o
    moved = (b * hk * d + b * m * d + hk * m * o + b * o * d) * el
    return flops, moved


def phase_cin_kernel(card: str, cfg) -> dict:
    """The CIN kernel against its plain version at the three xDeepFM
    layers, then timings at serve_p99 (kernel, plain, library) and
    serve_bulk (kernel)."""
    import torch
    from repro_torch.kernels.cin_fuse import kernel, ops
    print("== phase 14: CIN kernel vs plain version on the card")
    _ptxas_report(kernel.LIB)
    _tile_check("phase 14")
    gen = torch.Generator(device="cuda").manual_seed(14)
    m, d = cfg.n_sparse, cfg.embed_dim
    layers = list(zip((m,) + cfg.cin_layers[:-1], cfg.cin_layers))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for b in CIN_BATCHES:
        plan = kernel.cin_plan(b, layers[-1][0], m, d, layers[-1][1],
                               n_sm=n_sm)
        if (plan.splits > 1) != (b <= REC_P99):
            raise AssertionError(f"B={b}: {plan.splits} split(s) of K")
        print(f"  B={b}: bf16 plan grid {plan.grid}, N {plan.n_tile}, "
              f"{plan.k_steps} k16 steps an h, {plan.splits} split(s) of "
              f"K, {plan.smem_bytes} B of shared memory")
    main_err = None
    for b, (hk, o), dtype in itertools.product(
            CIN_BATCHES, layers, (torch.bfloat16, torch.float32)):
        xk, x0, w = _cin_inputs(b, hk, m, d, o, dtype, gen)
        out = ops.cin_layer(xk, x0, w, impl="cuda")
        expect = ops.cin_layer(xk.float(), x0.float(), w.float(),
                               impl="torch")
        torch.cuda.synchronize()
        what = f"B={b} {hk}x{m} -> {o} {dtype}"
        err = _row_check(out, expect, CIN_ROW_RTOL[str(dtype)], what,
                         row_dims=2)
        if dtype == torch.bfloat16 and b == REC_P99 and (hk, o) == layers[-1]:
            main_err = err

    hk, o = layers[-1]
    xk, x0, w = _cin_inputs(REC_P99, hk, m, d, o, torch.bfloat16, gen)
    ms = _device_ms(lambda: kernel.cin_layer_cuda(xk, x0, w))
    plain_ms = _device_ms(lambda: ops.cin_layer(xk, x0, w, impl="torch"),
                          n=5)
    outer = (xk[:, :, None, :] * x0[:, None, :, :]).permute(0, 3, 1, 2
                                                            ).reshape(
        REC_P99 * d, hk * m).contiguous()
    library_ms = _device_ms(lambda: torch.matmul(outer, w))
    del outer
    flops, moved = _cin_costs(REC_P99, hk, m, d, o, 2)
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"  serve_p99 (B = {REC_P99}), {hk}x{m} -> {o} bf16, device time "
          f"[{card}]:")
    print(f"    kernel {ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} "
          f"TFLOP/s)  plain {plain_ms:.4f} "
          f"ms  torch.matmul over the outer product materialized as (B D, "
          f"Hk m) beforehand {library_ms:.4f} ms  bound {bound_ms:.4f} ms "
          f"({flops / 1e9:.2f} GFLOP at 989 TFLOP/s; {moved / 1e6:.1f} MB = "
          f"{bytes_ms:.4f} ms)")
    total_ms = total_bound = 0.0
    for hk_l, o_l in layers:
        xk, x0, w = _cin_inputs(REC_BULK, hk_l, m, d, o_l, torch.bfloat16,
                                gen)
        t = _device_ms(lambda: kernel.cin_layer_cuda(xk, x0, w), n=3,
                       warm=1)
        fl, mv = _cin_costs(REC_BULK, hk_l, m, d, o_l, 2)
        bd = max(fl / BF16_OPS_PER_S, mv / HBM_BYTES_PER_S) * 1e3
        total_ms, total_bound = total_ms + t, total_bound + bd
        print(f"  serve_bulk (B = {REC_BULK}), {hk_l}x{m} -> {o_l} bf16: "
              f"kernel {t:.3f} ms ({fl / (t * 1e-3) / 1e12:.1f} TFLOP/s) "
              f"bound {bd:.3f} ms ({fl / 1e12:.2f} TFLOP; {mv / 1e9:.2f} "
              f"GB) [{card}]")
    del xk, x0, w
    print(f"  serve_bulk, three layers: kernel {total_ms:.2f} ms, bound "
          f"{total_bound:.2f} ms ({100 * total_bound / total_ms:.1f} %)")
    return {"name": "cin_layer", "route": "cuda",
            "source": "src/repro_torch/kernels/cin_fuse/csrc/cin_fuse.cu",
            "replaces": "src/repro/kernels/cin_fuse/kernel.py:41",
            "launches": None, "max_abs_err": main_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms}


def _recsys_counts() -> dict:
    from repro_torch.kernels.cin_fuse import ops as cin_ops
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    return {"embedding_bag": bag_ops.launch_count(),
            "cin_layer": cin_ops.launch_count(),
            "plain": bag_ops.plain_count() + cin_ops.plain_count()}


def _reset_recsys_counts() -> None:
    from repro_torch.kernels.cin_fuse import ops as cin_ops
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    bag_ops.reset_counts()
    cin_ops.reset_counts()


def _served_cin_check(params, ids, mask, what) -> None:
    """Each CIN layer on the values the served model feeds it (the bag's
    output and the kernel path's previous layer) against the plain
    version's float32 output.  The logits cannot show the CIN: with the
    tables at 0.01 its share of a logit is ~1e-4, below bfloat16's
    resolution at logits of ~0.05."""
    from repro_torch.kernels.cin_fuse import ops as cin_ops
    from repro_torch.models import recsys as RS
    v = RS.embedding_bag(params["embedding"]["table"], ids, mask)
    xk = v
    for i, w in enumerate(params["cin"]):
        out = cin_ops.cin_layer(xk, v, w, impl="cuda")
        expect = cin_ops.cin_layer(xk.float(), v.float(), w.float(),
                                   impl="torch")
        _row_check(out, expect, CIN_ROW_RTOL[str(out.dtype)],
                   f"{what}, CIN layer {i + 1} on the served values",
                   row_dims=2)
        xk = out


def phase_ctr_serving(card: str, cfg, params, batches) -> dict:
    """xDeepFM at full width serves N_P99 serve_p99 batches and one
    serve_bulk batch through `xdeepfm_logits`; DeepFM and AutoInt serve
    the first serve_p99 batch."""
    import torch
    from repro_torch.configs import autoint, deepfm
    from repro_torch.models import recsys as RS
    print(f"== phase 15: CTR serving, {cfg.name} at full width "
          f"({cfg.n_sparse} fields, {RS.padded_rows(cfg.total_rows)} rows x "
          f"D = {cfg.embed_dim}, CIN {cfg.cin_layers}, MLP {cfg.mlp}), "
          f"{cfg.dtype}, random weights (seed 0); {N_P99} x serve_p99 "
          f"(B = {REC_P99}) + 1 x serve_bulk (B = {REC_BULK})")
    RS.xdeepfm_logits(params, cfg, *batches[0])       # warm-up, uncounted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _reset_recsys_counts()
    walls, outs = [], []
    for ids, mask in batches:
        t0 = time.perf_counter()
        outs.append(RS.xdeepfm_logits(params, cfg, ids, mask))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = _recsys_counts()
    peak = torch.cuda.max_memory_allocated()
    n = len(batches)
    expect = {"embedding_bag": 2 * n, "cin_layer": len(cfg.cin_layers) * n,
              "plain": 0}
    if counts != expect:
        raise AssertionError(f"CTR launches {counts}, expected {expect} "
                             f"({n} batches)")
    for (ids, _), out in zip(batches, outs):
        if out.shape != (ids.shape[0],) or out.dtype != torch.float32 \
                or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"logits {tuple(out.shape)} {out.dtype}, "
                                 f"finite {bool(torch.isfinite(out).all())}")
    p99 = walls[:N_P99]
    print(f"  launches {counts} for {n} batches [{card}]")
    print(f"  serve_p99: {', '.join(f'{w * 1e3:.2f}' for w in p99)} ms a "
          f"batch = {REC_P99 * N_P99 / sum(p99):.0f} samples/s")
    print(f"  serve_bulk: {walls[-1] * 1e3:.1f} ms = "
          f"{REC_BULK / walls[-1]:.0f} samples/s")
    unfused = (REC_BULK * max(cfg.cin_layers) * cfg.n_sparse * cfg.embed_dim
               * params["cin"][0].element_size())
    print(f"  peak memory {peak / 1e9:.2f} GB ({base / 1e9:.2f} GB of "
          "weights and batches before the run); the unfused CIN's outer "
          f"product would be {unfused / 1e9:.1f} GB a layer at serve_bulk")

    bulk_ids, bulk_mask = batches[-1]
    for what, (ids, mask) in (
            (f"serve_p99 (B = {REC_P99})", batches[0]),
            (f"serve_bulk's first {CIN_BULK_SLICE} samples",
             (bulk_ids[:CIN_BULK_SLICE], bulk_mask[:CIN_BULK_SLICE]))):
        _served_cin_check(params, ids, mask, what)

    ids, mask = batches[0]
    plain = RS.xdeepfm_logits(params, cfg, ids, mask, impl="torch")
    errs = {cfg.name: _rel_l2(outs[0], plain)}
    for name, mod, seed in (("deepfm", deepfm, 1), ("autoint", autoint, 2)):
        other = getattr(RS, f"init_{name}")(seed, mod.FULL)
        logits = getattr(RS, f"{name}_logits")
        _reset_recsys_counts()
        t0 = time.perf_counter()
        out = logits(other, mod.FULL, ids, mask)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _recsys_counts()
        if got != {"embedding_bag": 2, "cin_layer": 0, "plain": 0}:
            raise AssertionError(f"{name}: launches {got}, expected 2 bags")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: non-finite logits")
        errs[name] = _rel_l2(out, logits(other, mod.FULL, ids, mask,
                                          impl="torch"))
        print(f"  {name} (full width, D = {mod.FULL.embed_dim}), serve_p99: "
              f"launches {got}; {wall * 1e3:.2f} ms (first call)")
        del other
    print(f"  logits, kernel path vs plain path at serve_p99, bf16: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" relative L2 (limit {BF16_LOGITS_RTOL:g})")
    if not max(errs.values()) <= BF16_LOGITS_RTOL:
        raise AssertionError(f"bf16 CTR logits differ: {errs}")
    import dataclasses
    cfg2 = dataclasses.replace(cfg, name=f"{cfg.name}-2-cin-f32",
                               cin_layers=cfg.cin_layers[:2],
                               dtype="float32")
    params2 = RS.init_xdeepfm(1, cfg2)
    err = _rel_l2(RS.xdeepfm_logits(params2, cfg2, ids, mask),
                  RS.xdeepfm_logits(params2, cfg2, ids, mask, impl="torch"))
    print(f"  {cfg2.name} (full field count and width), same check: "
          f"relative L2 {err:.2e} (limit {F32_LOGITS_RTOL:g}) [{card}]")
    if not err <= F32_LOGITS_RTOL:
        raise AssertionError(f"float32 CTR logits differ by {err}")
    return {"counts": counts, "walls": walls}


# ------------------------------------------------------------ planning layer
ANSWER_SLO = 0.300        # the paper's 300 ms answer-time constraint (Sec 6)
SIM16_LAM = (20.0, 40.0, 80.0, 160.0)
SIM16_SPEEDS = (1.0, 2.0, 3.0, 4.0)
SIM16_R = (1.0, 2.0, 4.0)
SIM16_QUERIES = 256 * CHUNK        # 1,048,576: the paper's order of 10^6
IMB_P = (25, 50, 100, 200)
IMB_CACHE_BYTES = 1e6      # per server: hit 0.61 at p = 25, 0.92 at 200
IMB_RTOL = 1e-4            # card vs CPU, tests/test_torch_imbalance.py


def _same_surface(x, y, what: str, rtol: float = 1e-5) -> float:
    """Hold a card surface against the CPU's: the same cells infinite, the
    finite ones within ``rtol``; returns the largest relative error."""
    import torch
    y = y.to(x.device)
    if not torch.equal(torch.isinf(x), torch.isinf(y)):
        raise AssertionError(f"{what}: infinite cells differ from the CPU's")
    fin = torch.isfinite(y)
    err = _rel_err(x[fin], y[fin]) if bool(fin.any()) else 0.0
    if not err <= rtol:
        raise AssertionError(f"{what}: card vs CPU rel err {err} > {rtol}")
    return err


def _global_grid(device):
    """examples/global_sweep.py's 1,000,000-scenario grid (Table 5 base,
    the result cache)."""
    import torch
    from repro_torch.core import capacity, sweep
    return sweep.SweepGrid.build(
        lam=torch.linspace(10.0, 120.0, 100),
        p=[50.0, 100.0, 200.0, 400.0], cpu=torch.linspace(1.0, 3.0, 5),
        disk=torch.linspace(1.0, 3.0, 5),
        hit=torch.linspace(0.05, 0.95, 20), r=[1.0, 2.0, 4.0, 8.0, 16.0],
        base=capacity.TABLE5_PARAMS, result_cache=RESULT_CACHE,
        device=device)


def phase_whatif(card: str) -> None:
    """16a: examples/whatif_sweep.py's Table 6 columns through
    plan_over_grid, the Scenario 4 point, upgrade_grid against the CPU,
    and examples/global_sweep.py's 1,000,000-scenario grid in one call."""
    import torch
    from repro_torch.core import capacity, planner, sweep
    print("== phase 16a: analytic what-if sweeps on the card")
    lam = [16.0, 32.0, 56.0, 80.0]
    for mem in (1, 2, 3, 4):
        grid = sweep.SweepGrid.build(
            lam=lam, p=[50.0, 100.0, 150.0, 200.0],
            cpu=torch.linspace(1.0, 4.0, 7),
            disk=torch.linspace(1.0, 4.0, 7), memory=mem, device="cuda")
        res, fr = planner.plan_over_grid(grid, ANSWER_SLO)
        ok = float(torch.mean((res.response_upper <= ANSWER_SLO).float()))
        print(f"  memory {mem}x, {grid.n_scenarios} scenarios, {ok:.1%} "
              "meet 300 ms:")
        for i in range(len(lam)):
            print(f"    {fr.describe(i)}")
    grid4 = sweep.SweepGrid.build(lam=[56.0], p=[100.0], cpu=[4.0],
                                  disk=[4.0], memory=4, device="cuda")
    r4 = float(sweep.sweep_analytical(grid4).response_upper.reshape(())) \
        * 1e3
    print(f"  R_upper(56 qps | memory 4x, cpu 4x, disk 4x, p = 100) = "
          f"{r4:.1f} ms (paper: 286 ms)")
    if not abs(r4 - 286.0) < 3.0:
        raise AssertionError(f"Scenario 4 point {r4} ms, paper 286 ms")
    err = max(_same_surface(capacity.upgrade_grid(56.0, memory=m),
                            capacity.upgrade_grid(56.0, memory=m,
                                                  device="cpu"),
                            f"upgrade_grid memory {m}")
              for m in (1, 2, 3, 4))
    print(f"  upgrade_grid(56 qps), memory 1-4: card vs CPU max rel err "
          f"{err:.2e} (rtol 1e-5)")

    grid = _global_grid("cuda")
    n = grid.n_scenarios
    if n != 1_000_000:
        raise AssertionError(f"the global grid has {n} scenarios")
    sweep.sweep_analytical(grid)                    # warm-up
    wall = _wall(lambda: sweep.sweep_analytical(grid))
    ms = _time_ms(lambda: sweep.sweep_analytical(grid), n=20)
    res = sweep.sweep_analytical(grid)
    ref = sweep.sweep_analytical(_global_grid("cpu"))
    errs = [_same_surface(getattr(res, f), getattr(ref, f), f"global {f}")
            for f in ("response_lower", "response_upper", "utilization")]
    phase_profile(card, wall, lambda: sweep.sweep_analytical(grid),
                  "phase 16a: device time by kernel, one sweep_analytical "
                  "call on the 1,000,000-scenario grid")
    fr = sweep.extract_frontier(res, 0.650)
    print(f"  global grid, {n:,} scenarios (Table 5 base, result cache "
          f"{RESULT_CACHE}), one sweep_analytical call: {wall * 1e3:.2f} ms "
          f"wall = {n / wall:.4g} scenarios/s; mean of 20 calls "
          f"{ms:.3f} ms = {n / ms * 1e3:.4g} scenarios/s [{card}]")
    print(f"    card vs CPU: lower/upper/utilization max rel err "
          f"{max(errs):.2e} (rtol 1e-5), the same cells infinite; "
          f"{float(res.feasible_fraction):.1%} below saturation; cheapest "
          f"650 ms cell at 120 qps: {fr.describe(99)}")


class _DispatchWalls:
    """Times each `simulate_fork_join_batch` call the sweep makes (a sync
    before and after each), while in a ``with`` block."""

    def __enter__(self):
        import torch
        from repro_torch.core import simulator
        self.walls, self._orig = [], simulator.simulate_fork_join_batch

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = self._orig(*args, **kw)
            torch.cuda.synchronize()
            self.walls.append((kw["cluster"].r, time.perf_counter() - t0))
            return res
        simulator.simulate_fork_join_batch = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.core import simulator
        simulator.simulate_fork_join_batch = self._orig


def phase_sim_sweep(card: str) -> dict:
    """16b: the simulated sweep over Table 6 memory 1 at p = 100: lam 4 x
    cpu 4 x disk 4 = 64 scenarios a dispatch, r 1 / 2 / 4, the result
    cache, 1,048,576 queries a scenario, random and JSQ routing; then the
    plain-path check, Eq 7, the p95 frontier and a diurnal plan."""
    import torch
    from repro_torch.core import planner, sweep
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.workloadgen import loadgen
    print(f"== phase 16b: simulated sweep, Table 6 memory 1, p = {P}, "
          f"{len(SIM16_LAM) * len(SIM16_SPEEDS) ** 2} scenarios x r "
          f"{SIM16_R}, result cache {RESULT_CACHE}, {SIM16_QUERIES:,} "
          "queries a scenario")

    def grid_of(r):
        return sweep.SweepGrid.build(
            lam=SIM16_LAM, p=[float(P)], cpu=SIM16_SPEEDS,
            disk=SIM16_SPEEDS, memory=1, r=r, result_cache=RESULT_CACHE,
            device="cuda")
    grid = grid_of(SIM16_R)
    ana = sweep.sweep_analytical(grid)
    lo, hi = ana.response_lower, ana.response_upper
    n_chunks = SIM16_QUERIES // CHUNK
    n_rep = sum(r > 1 for r in SIM16_R)
    for routing in ("random", "jsq"):     # warm-up, uncounted
        sweep.sweep_simulated(grid, 16, n_queries=CHUNK, chunk_size=CHUNK,
                              cluster=ClusterSpec(routing=routing))
    out = {}
    for routing in ("random", "jsq"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        with _DispatchWalls() as walls:
            t0 = time.perf_counter()
            res = sweep.sweep_simulated(
                grid, 16, n_queries=SIM16_QUERIES, chunk_size=CHUNK,
                cluster=ClusterSpec(routing=routing))
            mean = res.mean
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        counts = _counts()
        sampled = _sample_counts()
        peak = torch.cuda.max_memory_allocated()
        # r = 1: cache, broker and servers on the plain scan; r > 1: the
        # same three levels segmented; JSQ routes each r > 1 chunk once
        expect = {"maxplus_scan": 3 * n_chunks,
                  "maxplus_segment_scan": 3 * n_chunks * n_rep,
                  "jsq_route": n_chunks * n_rep if routing == "jsq" else 0,
                  "fleet_scan": 0}
        if counts != expect:
            raise AssertionError(f"16b {routing}: launches {counts}, "
                                 f"expected {expect}")
        # one sampler launch a chunk of each of the 3 dispatches, and no
        # call to the plain draws
        if sampled != {"service_sample": 3 * n_chunks, "plain": 0}:
            raise AssertionError(f"16b {routing}: sampler {sampled}, "
                                 f"expected {3 * n_chunks} launches and no "
                                 "plain draws")
        n_scen = math.prod(grid.shape) // len(SIM16_R)
        print(f"  {routing}: launches {counts}, {sampled}; {total:.3f} s "
              f"for 3 dispatches = {3 * n_scen * SIM16_QUERIES / total:.4g} "
              f"queries/s; peak {peak / 2**20:.0f} MiB [{card}]")
        for r, wall in walls.walls:
            print(f"    r = {r}: {wall:.3f} s = "
                  f"{n_scen * SIM16_QUERIES / wall:.4g} queries/s, "
                  f"{n_scen * SIM16_QUERIES * P / wall:.4g} "
                  f"server-events/s")
        if not bool(torch.isfinite(mean).all()):
            raise AssertionError(f"16b {routing}: non-finite means")
        fin = torch.isfinite(hi)
        inside = (mean > 0.95 * lo) & (mean < 1.05 * hi)
        print(f"    Eq 7: {int((inside & fin).sum())} of {int(fin.sum())} "
              f"cells with a finite bound hold 0.95 lower < mean < 1.05 "
              f"upper; p95 {float(res.quantile(0.95)[fin].min()) * 1e3:.1f}"
              f"..{float(res.quantile(0.95)[fin].max()) * 1e3:.1f} ms")
        if not bool(inside[fin].all()):
            bad = torch.nonzero(fin & ~inside).tolist()
            raise AssertionError(f"16b {routing}: means outside Eq 7 at "
                                 f"{bad}")
        fr_sim = sweep.extract_frontier(res, ANSWER_SLO, quantile=0.95)
        fr_ana = sweep.extract_frontier(ana, ANSWER_SLO, quantile=0.95)
        print("    frontier, simulated p95 <= 300 ms (analytic p95 "
              "estimate where it differs):")
        for i in range(len(SIM16_LAM)):
            sim_s, ana_s = fr_sim.describe(i), fr_ana.describe(i)
            print(f"      {sim_s}" + ("" if ana_s == sim_s
                                      else f"\n        analytic: {ana_s}"))
        out[routing] = {"counts": counts, "sampled": sampled,
                        "walls": walls.walls}
    wall_r4 = next(w for r, w in out["random"]["walls"] if r == 4)
    traced = phase_profile(
        card, wall_r4, lambda: sweep.sweep_simulated(
            grid_of([4.0]), 16, n_queries=SIM16_QUERIES, chunk_size=CHUNK,
            cluster=ClusterSpec(routing="random")),
        f"phase 16b: device time by kernel, one dispatch (random, r = 4, "
        f"{SIM16_QUERIES:,} queries)")
    _kernel_share(traced, "maxplus_segment_scan_kernel", "segmented scan")

    # the kernel path against the plain path on the same draws, on the
    # r = 2 dispatch; JSQ's plain loop is ~8 launches a query: 2 chunks.
    # The plain path samples with the plain draws, the kernel path with
    # the sampler: one call a chunk each
    sub = grid_of([2.0])
    for routing, n in (("random", 25 * CHUNK), ("jsq", 2 * CHUNK)):
        kw = dict(n_queries=n, chunk_size=CHUNK,
                  cluster=ClusterSpec(routing=routing))
        before = _sample_counts()
        kern = sweep.sweep_simulated(sub, 16, **kw).mean
        mid = _sample_counts()
        plain = sweep.sweep_simulated(sub, 16, impl="torch", **kw).mean
        after = _sample_counts()
        steps = [{k: b[k] - a[k] for k in a}
                 for a, b in ((before, mid), (mid, after))]
        want = [{"service_sample": n // CHUNK, "plain": 0},
                {"service_sample": 0, "plain": n // CHUNK}]
        if steps != want:
            raise AssertionError(f"16b {routing}: sampler calls of the "
                                 f"kernel and plain paths {steps}, "
                                 f"expected {want}")
        err = _rel_err(kern, plain)
        print(f"  {routing}, r = 2 dispatch, {n:,} queries: kernel path vs "
              f"plain path means max rel err {err:.2e} (limit 1e-4)")
        if not err <= 1e-4:
            raise AssertionError(f"16b {routing}: kernel vs plain means "
                                 f"differ by {err}")

    # the daily peak: the r = 1 slab under the weekly diurnal profile,
    # the week compressed so the lowest rate's horizon covers it once
    profile = loadgen.diurnal_rates(device="cuda")
    bin_s = SIM16_QUERIES / SIM16_LAM[0] / profile.shape[0]
    t0 = time.perf_counter()
    res1, fr_day = planner.plan_over_grid(
        grid_of([1.0]), ANSWER_SLO, simulate=True, seed=16, quantile=0.95,
        n_queries=SIM16_QUERIES, profile=profile, profile_bin_seconds=bin_s,
        chunk_size=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not bool(torch.isfinite(res1.mean).all()):
        raise AssertionError("16b diurnal: non-finite means")
    print(f"  diurnal (168 bins of {bin_s:.0f} s, peak/mean "
          f"{float(profile.max() / profile.mean()):.2f}), r = 1 slab, p95 "
          f"<= 300 ms: {wall:.3f} s [{card}]")
    best = res1.quantile(0.95).reshape(len(SIM16_LAM), -1).amin(1)
    for i in range(len(SIM16_LAM)):
        print(f"    {fr_day.describe(i)} (lowest p95 "
              f"{float(best[i]) * 1e3:.0f} ms)")
    return out


def phase_plans(card: str) -> None:
    """16c: Scenario 4 sized for 200 qps with the simulated cross-check
    (tests/test_capacity.py:22's case), and Scenario 6's cached plan."""
    import torch
    from repro_torch.core import capacity
    from repro_torch.core.cluster import ClusterSpec
    print("== phase 16c: capacity plans")
    p4 = capacity.scenario("memory+cpus+disks", device="cuda")
    _reset_counts()
    t0 = time.perf_counter()
    plan = capacity.plan_capacity(p4, 200.0, ANSWER_SLO, simulate=True,
                                  cluster=ClusterSpec(routing="random"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    print(f"  Scenario 4, 200 qps under 300 ms: {plan.n_replicas} replicas "
          f"x {plan.servers_per_replica} = {plan.total_servers} servers "
          f"(paper: 4 x 100); Eq 7 [{plan.response_lower_ms:.1f}, "
          f"{plan.response_upper_ms:.1f}] ms; simulated (random routing, "
          f"60,000 queries) mean {plan.response_simulated_ms:.1f} ms, p95 "
          f"{plan.response_simulated_p95_ms:.1f} ms; launches {counts}; "
          f"{wall:.3f} s [{card}]")
    if (plan.n_replicas, plan.total_servers) != (4, 400):
        raise AssertionError(f"Scenario 4 plan {plan}")
    if not plan.response_simulated_ms <= ANSWER_SLO * 1e3:
        raise AssertionError(f"simulated mean {plan.response_simulated_ms} "
                             "ms over the SLO")
    if counts["maxplus_segment_scan"] == 0:
        raise AssertionError("the plan's cross-check launched no "
                             "segmented scan")
    plan6 = capacity.plan_capacity(
        p4, 195.0, ANSWER_SLO,
        cluster=ClusterSpec(result_cache=(0.5, 0.069e-3)))
    print(f"  Scenario 6, 195 qps with result caching: {plan6.n_replicas} "
          f"x 100 (paper: 3 x 100)")
    if plan6.n_replicas != 3:
        raise AssertionError(f"Scenario 6 plan {plan6}")


def phase_imbalance(card: str) -> None:
    """16d: Eq 1's parameters from the disk-cache model over the TodoBR
    universe (50,000 queries over 50,000 terms, term Zipf 0.98), list
    sizes as tests/test_engine.py:146 builds them, card against CPU."""
    import numpy as np
    import torch
    from repro_torch.core import imbalance, queueing
    from repro_torch.workloadgen import querygen
    print("== phase 16d: imbalance model, TodoBR universe")
    cfg = querygen.TODOBR
    t0 = time.perf_counter()
    uni = querygen.build_universe(cfg)
    setup = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    rates = np.diff(np.concatenate(
        [[0], querygen._zipf_cdf(cfg.vocab_size, cfg.term_zipf_alpha)])
    ) * 10.0
    sizes = (rng.pareto(1.2, cfg.vocab_size) + 1) * 2e4
    print(f"  universe {cfg.n_unique_queries:,} queries x "
          f"{cfg.vocab_size:,} terms built on the host in {setup:.2f} s; "
          f"lists {sizes.sum() / 1e9:.2f} GB, cache "
          f"{IMB_CACHE_BYTES / 1e6:g} MB a server [{card}]")

    def params(p, device):
        geom = imbalance.CacheGeometry(
            torch.tensor(rates, dtype=torch.float32, device=device),
            torch.tensor(sizes, dtype=torch.float32, device=device),
            IMB_CACHE_BYTES, p)
        return imbalance.service_params_from_cache_model(
            geom, torch.from_numpy(uni.terms).to(device),
            torch.from_numpy(uni.lengths).to(device))

    for p in IMB_P:
        card_p, cpu_p = params(p, "cuda"), params(p, "cpu")
        err = max(_rel_err(getattr(card_p, f).cpu(), getattr(cpu_p, f))
                  for f in ("hit", "s_hit", "s_miss", "s_disk"))
        cv = float(imbalance.service_time_cv(card_p))
        s = float(queueing.service_time_server(card_p))
        print(f"  p = {p:3d}: hit {float(card_p.hit):.4f}, S_disk "
              f"{float(card_p.s_disk) * 1e3:.3f} ms, S_hit "
              f"{float(card_p.s_hit) * 1e3:.3f} ms, S_miss "
              f"{float(card_p.s_miss) * 1e3:.3f} ms, S_server "
              f"{s * 1e3:.3f} ms, CV {cv:.3f}; card vs CPU max rel err "
              f"{err:.2e} (rtol {IMB_RTOL:g})")
        if not err <= IMB_RTOL:
            raise AssertionError(f"imbalance p = {p}: card vs CPU {err}")


# ------------------------------------------------------------ the fleet
# 17a: the fleet scan at the replicated path's width, r = R and the
# widest warp (16 replicas), in both float types, three ways
FLEET_R = (R, 16)
FLEET_FAULT = dict(outages=((0, 500.0, 1500.0),), mtbf_seconds=2000.0,
                   mttr_seconds=200.0)
FLEET_GAP = 0.5                 # seconds between arrivals, on average
FLEET_WIDE = 4 * 132            # a slab of four scenarios an SM
# latency of a dependent FP32 add or max, in SM cycles (assumed: the
# figure microbenchmarks of Volta through Hopper report; not measured here)
FLEET_DEP_CYCLES = 4
# 17b-d: the 16b slab (Table 6 memory 1, p = 100, lam x cpu x disk = 64
# scenarios, the result cache) under the weekly profile, 168 bins of
# 1,048,576 / 20 / 168 = 312 s; the profile clamps the chunk to the
# slowest bin's queries (~1,935)
SIM17_QUERIES = SIM16_QUERIES
SIM17_BIN_S = SIM17_QUERIES / SIM16_LAM[0] / 168
SIM17_SEED = 17
SIM17_POLICY = dict(min_r=1, max_r=R, target_utilization=0.7,
                    decision_interval_seconds=SIM17_BIN_S,
                    stabilization_intervals=2)
SIM17_PLAIN_CHUNKS = 2          # the plain loops take ~1 s a chunk (cut
                                # 4 -> 2 for the run's time)
SIM17_IDENTITY_CHUNKS = 16      # the bit-identity checks
SIM17_TRACE_CHUNKS = 128        # the traced dispatch: a quarter of the
                                # queries (its trace, ~100k events at full
                                # length, took ~50 s to gather and sum)
# 17d's slab: the fastest 16b hardware (cpu and disk x4, ~23 qps a
# replica under 300 ms by Eq 7), four loads, 262,144 queries a scenario
PLANS17_LAM = (10.0, 20.0, 30.0, 40.0)
PLANS17_QUERIES = 64 * CHUNK
# past 16 replicas: the wide instances, held exactly on chunks of 256
# queries, eight tiles of 32 (the plain loops step a query at a time; cut
# 512 -> 256 for the run's time) and, at r = 64, masked and
# float32, on a full chunk of the timed shape; timed at full width
WIDE_R = (17, 32, 64, 256)
WIDE_CHECK_N = 256
WIDE_FULL_R = 64
WIDE_WINDOWS = 64               # outage windows past the narrow 32
# 17e: Table 5's hardware at 500 qps needs 19 replicas by Eq 7 (+1 for
# N+1); 16,384 queries a simulation, on the card and on the CPU
PLAN17E_RATE = 500.0
PLAN17E_SLO = 0.9
PLAN17E_QUERIES = 16_384
P95_REL_TOL = 1e-6              # card vs CPU p95 on the same draws
# 18: telemetry, 64 bins over each scenario's horizon, the paper's SLO
OBS_BINS = 64
OBS_TRACE_CHUNKS = 8            # the traced runs that count launches
OBS_CPU_SCEN, OBS_CPU_CHUNKS, OBS_CPU_CHUNK = 4, 8, 1024   # 18c's slab
OBS_SPANS = 2_000               # 18d's window of queries


def _walled(phase, card: str):
    """Run one phase and print its wall seconds."""
    t0 = time.perf_counter()
    out = phase(card)
    print(f"  ({phase.__name__}: {time.perf_counter() - t0:.1f} s)")
    return out


def _fleet_case(r, dtype, what, gen, s=N_SCEN, real=False, n=CHUNK,
                windows=0):
    """Inputs of one fleet-scan call at (s, n): an outage of replica 0
    and the MTBF/MTTR chain, and/or the policy (min 1, max r, the queue
    trigger) fed ~r/2 replicas' worth of demand.  A decision every 20 s
    at 2 queries a second (one in ~40 queries), or with ``real`` 17b's:
    one a profile bin (SIM17_BIN_S) at the slab's 20-160 queries a
    second (one in ~6,000-50,000).  ``windows`` > 0: that many outage
    windows (replica 7 w mod r, 10 s each, every 3 s from the start)
    with the chain."""
    import torch
    from repro_torch.core.faults import FaultSpec
    from repro_torch.launch.elastic import AutoscalePolicy, autoscale_init
    shape = (s, n)
    mean_gap = torch.full((s, 1), FLEET_GAP, dtype=dtype, device="cuda")
    if real:
        lam = torch.tensor(SIM16_LAM, dtype=dtype, device="cuda")
        mean_gap = 1.0 / lam.repeat(-(-s // len(SIM16_LAM)))[:s, None]
    gaps = torch.empty(shape, dtype=dtype, device="cuda").exponential_(
        generator=gen) * mean_gap
    dem = torch.empty(shape, dtype=dtype, device="cuda").exponential_(
        generator=gen) * (mean_gap * P * 0.7 * r / 2)
    kw = dict(t_arr=torch.cumsum(gaps, -1) + 100.0, demand=dem, p=P, r=r,
              u=torch.rand(shape + (r,), dtype=dtype, device="cuda",
                           generator=gen),
              up_state=torch.randint(0, 2, (s, r), dtype=torch.int32,
                                     device="cuda", generator=gen),
              n_valid=n - 100)
    if what in ("fault", "both"):
        kw["fault"] = FaultSpec(**FLEET_FAULT)
        if windows:
            kw["fault"] = FaultSpec(
                outages=tuple((7 * w % r, 100.0 + 3.0 * w, 110.0 + 3.0 * w)
                              for w in range(windows)),
                mtbf_seconds=FLEET_FAULT["mtbf_seconds"],
                mttr_seconds=FLEET_FAULT["mttr_seconds"])
    if what in ("policy", "both"):
        pol = AutoscalePolicy(
            min_r=1, max_r=r, target_utilization=0.7,
            decision_interval_seconds=SIM17_BIN_S if real else 20.0,
            stabilization_intervals=2, queue_trigger_seconds=30.0)
        kw.update(policy=pol,
                  as_state=autoscale_init(pol, s, dtype, device="cuda"))
    return gaps, kw


def _max_sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi's clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0].split()[0]) * 1e6


def _fleet_exact(case, what_label, check_moved=True) -> float:
    """The fleet scan against its plain loop on one case: masks, counts
    and integer carries equal, float carries within 1e-6; one launch.
    Returns the float carries' max abs error."""
    import torch
    from repro_torch.kernels.fleet_scan import ops as fleet_ops
    gaps, kw = case
    before = fleet_ops.launch_count()
    k_up, k_n, k_st, k_as = fleet_ops.fleet_scan(gaps, impl="cuda", **kw)
    p_up, p_n, p_st, p_as = fleet_ops.fleet_scan(gaps, impl="torch", **kw)
    torch.cuda.synchronize()
    if fleet_ops.launch_count() != before + 1:
        raise AssertionError("the fleet scan did not launch once")
    same, err, worst, moved = True, 0.0, 0.0, ""
    if "fault" in kw:
        same &= bool(torch.equal(k_up, p_up) and torch.equal(k_st, p_st))
        moved += f"up {float(p_up.float().mean()):.3f} "
    if "policy" in kw:
        same &= bool(torch.equal(k_n, p_n))
        for kt, pt in zip(k_as, p_as):
            if kt.dtype == torch.int32:
                same &= bool(torch.equal(kt, pt))
            else:
                err = max(err, _rel_err(kt, pt))
                worst = max(worst, float((kt - pt).abs().max()))
        moved += (f"n_act {int(p_n.min())}..{int(p_n.max())} (mean "
                  f"{float(p_n.float().mean()):.2f})")
    print(f"  {what_label}: masks, counts and integer carries equal {same}; "
          f"float carries max rel err {err:.1e} (limit 1e-6); {moved}")
    if not same or not err <= 1e-6:
        raise AssertionError(f"fleet scan {what_label}: equal {same}, "
                             f"float carries {err}")
    if (check_moved and "policy" in kw and kw["r"] > 1
            and int(p_n.min()) == int(p_n.max())):
        raise AssertionError(f"fleet scan {what_label}: the policy never "
                             "moved")
    return worst


def phase_fleet_kernel(card: str) -> dict:
    """17a: the fleet scan against its plain loop at (64, 4096), r = 4
    and 16, float32 and float64, the policy without an up fraction and
    with the outage mask's (both recurrences at once), and at 17b's
    decision rate and a 528-scenario slab; then its times: the mask
    alone, the policy alone and both, at a decision every 20 s and at
    17b's rate, float64, and 528 scenarios (4 x 132 SMs)."""
    import torch
    from repro_torch.kernels.fleet_scan import ops as fleet_ops
    print("== phase 17a: fleet scan vs plain loop on the card")
    gen = torch.Generator(device="cuda").manual_seed(17)
    worst = 0.0
    for r, dtype, what in itertools.product(
            FLEET_R, (torch.float32, torch.float64), ("policy", "both")):
        worst = max(worst, _fleet_exact(
            _fleet_case(r, dtype, what, gen), f"r={r:2d} {str(dtype):14s} "
            f"{what:6s}"))
    for s, what in ((N_SCEN, "both"), (FLEET_WIDE, "both")):
        # at 17b's rate a 4096-query chunk holds at most one decision a
        # scenario, and the slowest scenarios none: the policy may not move
        _fleet_exact(_fleet_case(R, torch.float32, what, gen, s=s,
                                 real=True),
                     f"S={s} r={R} float32 {what} at 17b's rate",
                     check_moved=False)
    # past 16 replicas (the wide instance), and past 32 windows
    for r, dtype, what in itertools.product(
            WIDE_R, (torch.float32, torch.float64),
            ("fault", "policy", "both")):
        worst = max(worst, _fleet_exact(
            _fleet_case(r, dtype, what, gen, n=WIDE_CHECK_N),
            f"r={r:3d} {str(dtype):14s} {what:6s} ({WIDE_CHECK_N} queries)"))
    for r, dtype in itertools.product((R, 64, 256),
                                      (torch.float32, torch.float64)):
        _fleet_exact(_fleet_case(r, dtype, "both", gen, n=WIDE_CHECK_N,
                                 windows=WIDE_WINDOWS),
                     f"r={r:3d} {str(dtype):14s} both, {WIDE_WINDOWS} "
                     f"windows ({WIDE_CHECK_N} queries)")
    worst = max(worst, _fleet_exact(
        _fleet_case(WIDE_FULL_R, torch.float32, "both", gen),
        f"r={WIDE_FULL_R:3d} torch.float32  both   ({N_SCEN} x {CHUNK} "
        "queries, the timed shape)"))
    clock = _max_sm_clock_hz()
    times = {}
    for label, dtype, what, s, real in (
            ("mask alone", torch.float32, "fault", N_SCEN, False),
            ("policy alone", torch.float32, "policy", N_SCEN, False),
            ("both", torch.float32, "both", N_SCEN, False),
            ("both, float64", torch.float64, "both", N_SCEN, False),
            ("policy alone, 17b's rate", torch.float32, "policy", N_SCEN,
             True),
            ("both, 17b's rate", torch.float32, "both", N_SCEN, True),
            (f"both, S = {FLEET_WIDE}", torch.float32, "both", FLEET_WIDE,
             False),
            (f"policy alone, 17b's rate, S = {FLEET_WIDE}", torch.float32,
             "policy", FLEET_WIDE, True)):
        gaps, kw = _fleet_case(R, dtype, what, gen, s=s, real=real)
        ms = _device_ms(lambda: fleet_ops.fleet_scan(gaps, impl="cuda",
                                                     **kw), n=20)
        times[label] = ms
        print(f"    ({s}, {CHUNK}), r={R} {label:40s} [{card}]: {ms:.4f} ms "
              f"a chunk (device time, mean of 20), {ms * 1e6 / CHUNK:.1f} "
              "ns a step")
        if label == "both":
            gaps_both, kw_both = gaps, kw
    print(f"  by replica count at ({N_SCEN}, {CHUNK}) float32, a decision "
          f"every 20 s (device time, mean of 20) [{card}]:")
    for r in (R, 16) + WIDE_R:
        row = []
        for what in ("fault", "both"):
            gaps, kw = _fleet_case(r, torch.float32, what, gen)
            ms = _device_ms(lambda: fleet_ops.fleet_scan(
                gaps, impl="cuda", **kw), n=20)
            row.append(f"{'mask alone' if what == 'fault' else what} "
                       f"{ms:.4f} ms ({ms * 1e6 / CHUNK:.1f} ns a step)")
        print(f"    r = {r:3d}: " + "; ".join(row))
    t_both = times["both"]
    plain_ms = _time_ms(lambda: fleet_ops.fleet_scan(
        gaps_both, impl="torch", **kw_both), n=1, warm=0)
    el = 4
    # gaps, times, demand and u (r a query) read; up (r bytes a query)
    # and n_act written; per step ~24 controller operations and ~3 a
    # replica of the chain
    moved = N_SCEN * CHUNK * ((3 + R) * el + R + 4)
    n_ops = N_SCEN * CHUNK * (24 + 3 * R)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    # the dependency chain: a step's backlog sub, max and add, each waiting
    # on the one before, FLEET_DEP_CYCLES apiece at the card's top clock
    chain_ms = CHUNK * 3 * FLEET_DEP_CYCLES / clock * 1e3
    print(f"  at ({N_SCEN}, {CHUNK}, r={R}) float32, both [{card}]: kernel "
          f"{t_both:.4f} ms  plain loop {plain_ms:.1f} ms  library: none")
    print(f"    bounds: bytes {bytes_ms:.4f} ms ({moved / 1e6:.1f} MB at "
          f"3.35 TB/s), operations {ops_ms:.4f} ms; dependency chain "
          f"{chain_ms:.4f} ms ({CHUNK} steps x 3 dependent ops x "
          f"{FLEET_DEP_CYCLES} cycles at {clock / 1e6:.0f} MHz); the kernel "
          f"at {100 * max(bound_ms, chain_ms) / t_both:.1f} % of the larger")
    return {"name": "fleet_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/fleet_scan/csrc/"
                      "fleet_scan.cu",
            "replaces": "src/repro/core/faults.py:168 and "
                        "src/repro/launch/elastic.py:164 (lax.scan, no "
                        "Pallas kernel)",
            "launches": None, "max_abs_err": worst, "ms": t_both,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def phase_masked_jsq(card: str) -> None:
    """17a': the JSQ router with the autoscaler's active counts and the
    fault injector's up mask against its plain loop at (64, r = 4,
    p = 100, 4096), float32."""
    import torch
    from repro_torch.kernels.jsq_route import kernel, ops
    print("== phase 17a': masked JSQ router vs plain loop on the card")
    gen = torch.Generator(device="cuda").manual_seed(18)
    s_mean = 0.02
    dtype = torch.float32
    w = torch.zeros((N_SCEN, R, P), dtype=dtype, device="cuda")
    gaps = torch.empty((N_SCEN, CHUNK), dtype=dtype, device="cuda"
                       ).exponential_(generator=gen) * (s_mean / R / 0.8)
    svc = torch.empty((N_SCEN, P, CHUNK), dtype=dtype, device="cuda"
                      ).exponential_(generator=gen) * s_mean
    live = (torch.rand((N_SCEN, CHUNK), device="cuda", generator=gen)
            >= RESULT_CACHE[0]).to(dtype)
    w = ops.jsq_route(w, gaps, svc, live, impl="cuda")[1]
    n_act = torch.randint(1, R + 1, (N_SCEN, CHUNK), dtype=torch.int32,
                          device="cuda", generator=gen)
    up = torch.rand((N_SCEN, CHUNK, R), device="cuda", generator=gen) < 0.8
    up[:, 1000:1100] = False                 # nothing up: unavailable
    plain_unmasked = _time_ms(lambda: kernel.jsq_route_cuda(w, gaps, svc,
                                                            live), n=20)
    for what, masks in (("n_act", dict(n_act=n_act)), ("up", dict(up=up)),
                        ("both", dict(n_act=n_act, up=up))):
        before = ops.launch_count()
        k = ops.jsq_route(w, gaps, svc, live, impl="cuda", **masks)
        if ops.launch_count() != before + 1:
            raise AssertionError("the masked JSQ call did not launch once")
        pl = ops.jsq_route(w, gaps, svc, live, impl="torch", **masks)
        torch.cuda.synchronize()
        same = bool(torch.equal(k[0], pl[0])) and all(
            bool(torch.equal(a, b)) for a, b in zip(k[2:], pl[2:]))
        err = _rel_err(k[1], pl[1])
        ms = _time_ms(lambda: kernel.jsq_route_cuda(w, gaps, svc, live,
                                                    **masks), n=20)
        flags = ("" if len(k) == 2 else
                 f"; spill {float(pl[2].float().mean()):.3f}, unavail "
                 f"{float(pl[3].float().mean()):.3f}")
        print(f"  {what:5s}: choices{', spill, unavail' if len(k) > 2 else ''}"
              f" equal {same}; tracker max rel err {err:.1e} (limit 1e-6)"
              f"{flags}; {ms:.4f} ms a chunk (mean of 20) against the "
              f"unmasked {plain_unmasked:.4f} ms in this run [{card}]")
        if not same or not err <= 1e-6:
            raise AssertionError(f"masked JSQ ({what}) disagrees with the "
                                 f"plain loop: equal {same}, tracker {err}")
    # past 16 replicas: the wide instance, at 80 % utilization a replica
    def inputs(r, dtype, n):
        g = torch.Generator(device="cuda").manual_seed(r)
        w0 = torch.zeros((N_SCEN, r, P), dtype=dtype, device="cuda")
        gp = torch.empty((N_SCEN, n), dtype=dtype, device="cuda"
                         ).exponential_(generator=g) * (s_mean / r / 0.8)
        sv = torch.empty((N_SCEN, P, n), dtype=dtype, device="cuda"
                         ).exponential_(generator=g) * s_mean
        lv = (torch.rand((N_SCEN, n), device="cuda", generator=g)
              >= RESULT_CACHE[0]).to(dtype)
        w0 = ops.jsq_route(w0, gp, sv, lv, impl="cuda")[1]   # warm state
        na = torch.randint(1, r + 1, (N_SCEN, n), dtype=torch.int32,
                           device="cuda", generator=g)
        u = torch.rand((N_SCEN, n, r), device="cuda", generator=g) < 0.8
        u[:, 100:120] = False
        return w0, gp, sv, lv, dict(n_act=na, up=u)
    for r, dtype in itertools.product(WIDE_R, (torch.float32,
                                               torch.float64)):
        w0, gp, sv, lv, masks = inputs(r, dtype, WIDE_CHECK_N)
        for label, kw in (("unmasked", {}), ("masked", masks)):
            before = ops.launch_count()
            k = ops.jsq_route(w0, gp, sv, lv, impl="cuda", **kw)
            if ops.launch_count() != before + 1:
                raise AssertionError("the wide JSQ call did not launch once")
            pl = ops.jsq_route(w0, gp, sv, lv, impl="torch", **kw)
            torch.cuda.synchronize()
            same = all(bool(torch.equal(a, b)) for a, b in zip(k, pl))
            print(f"  r = {r:3d} {str(dtype):14s} {label:8s}: choices, "
                  f"tracker{' and flags' if kw else ''} equal the plain "
                  f"loop's exactly: {same} ({WIDE_CHECK_N} queries; "
                  f"{int(pl[0].max()) + 1} replicas chosen at most)")
            if not same:
                raise AssertionError(f"wide JSQ r={r} {dtype} {label} "
                                     "disagrees with the plain loop")
    # and a full chunk of the timed shape, masked, float32
    w0, gp, sv, lv, masks = inputs(WIDE_FULL_R, torch.float32, CHUNK)
    k = ops.jsq_route(w0, gp, sv, lv, impl="cuda", **masks)
    pl = ops.jsq_route(w0, gp, sv, lv, impl="torch", **masks)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, b)) for a, b in zip(k, pl))
    print(f"  r = {WIDE_FULL_R:3d} torch.float32  masked  at ({N_SCEN}, "
          f"{WIDE_FULL_R}, {P}, {CHUNK}): choices, tracker and flags equal "
          f"the plain loop's exactly: {same} ({int(pl[0].max()) + 1} "
          "replicas chosen at most)")
    if not same:
        raise AssertionError(f"wide JSQ r={WIDE_FULL_R} at the timed shape "
                             "disagrees with the plain loop")
    print(f"  by replica count at ({N_SCEN}, r, {P}, {CHUNK}) float32, 80 % "
          f"utilization a replica (mean of 5) [{card}]:")
    for r in (R, 16) + WIDE_R:
        w0, gp, sv, lv, masks = inputs(r, torch.float32, CHUNK)
        t_plain = _time_ms(lambda: kernel.jsq_route_cuda(w0, gp, sv, lv),
                           n=5, warm=1)
        t_mask = _time_ms(lambda: kernel.jsq_route_cuda(w0, gp, sv, lv,
                                                        **masks),
                          n=5, warm=1)
        print(f"    r = {r:3d}: unmasked {t_plain:.4f} ms, masked (both) "
              f"{t_mask:.4f} ms a chunk ({t_plain * 1e6 / CHUNK:.0f} / "
              f"{t_mask * 1e6 / CHUNK:.0f} ns a step)")


def _slab17(lam_axis, speeds):
    """(lam (S,), ServerParams (S,)) of Table 6 memory 1 at p = P over
    lam x cpu x disk, as the 16b sweep's slab."""
    import dataclasses
    from repro_torch.core import sweep
    from repro_torch.core.queueing import ServerParams
    grid = sweep.SweepGrid.build(lam=lam_axis, p=[float(P)], cpu=speeds,
                                 disk=speeds, memory=1, device="cuda")
    lam, params = grid.broadcast_full()
    return lam.reshape(-1), ServerParams(p=P, **{
        f.name: getattr(params, f.name).reshape(-1)
        for f in dataclasses.fields(ServerParams) if f.name != "p"})


def _profile17(lam):
    """The weekly profile scaled to each scenario's mean rate, and the
    chunk the engine clamps it to."""
    import warnings
    from repro_torch.core import simulator
    from repro_torch.core.arrivals import ArrivalProcess
    from repro_torch.workloadgen import loadgen
    profile = loadgen.diurnal_rates(device="cuda")
    arrival = ArrivalProcess.piecewise(profile, SIM17_BIN_S, device="cuda"
                                       ).normalized().scaled_by(lam)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        chunk = simulator._clamp_chunk_for_profile(arrival, CHUNK)
    return profile, arrival, chunk


def _sim17(arrival, params, cluster, n=None, impl="auto"):
    import warnings
    from repro_torch.core import simulator
    n = SIM17_QUERIES if n is None else n
    with warnings.catch_warnings():     # the profile's chunk clamp
        warnings.simplefilter("ignore", UserWarning)
        return simulator.simulate_fork_join_batch(
            SIM17_SEED, arrival, params, n, p=P, chunk_size=CHUNK,
            impl=impl, cluster=cluster)


_SHARED17 = ("count", "sum_response", "sumsq_response", "sum_broker",
             "sum_cluster", "sum_server", "hist", "hist_log_lo",
             "hist_log_step")


def _bit_identical(a, b, what: str) -> None:
    import torch
    bad = [f for f in _SHARED17 if not torch.equal(getattr(a, f),
                                                   getattr(b, f))]
    if bad:
        raise AssertionError(f"{what}: not bit-identical in {bad}")


def _expect17(n_chunks, routing, fleet=True):
    return {"maxplus_scan": 0, "maxplus_segment_scan": 3 * n_chunks,
            "jsq_route": n_chunks if routing == "jsq" else 0,
            "fleet_scan": n_chunks if fleet else 0}


def phase_elastic_fleet(card: str) -> dict:
    """17b: the autoscaled fleet at full width: the 16b slab under the
    weekly profile, AutoscalePolicy(1..4, a decision a profile bin),
    1,048,576 queries a scenario, JSQ and random routing; the pinned
    policy against static r = 4, the cost integral's bounds, the plain
    path on the first chunks and the launch counts."""
    import torch
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.launch.elastic import AutoscalePolicy
    lam, params = _slab17(SIM16_LAM, SIM16_SPEEDS)
    profile, arrival, chunk = _profile17(lam)
    n_chunks = -(-SIM17_QUERIES // chunk)
    pol = AutoscalePolicy(**SIM17_POLICY)
    print(f"== phase 17b: autoscaled fleet, {lam.shape[0]} scenarios x "
          f"{SIM17_QUERIES:,} queries, weekly profile (168 bins of "
          f"{SIM17_BIN_S:.0f} s, chunk clamped to {chunk}: {n_chunks} "
          f"chunks), policy {pol.min_r}..{pol.max_r} @ "
          f"{pol.target_utilization:.0%}, result cache {RESULT_CACHE}")

    def cluster(routing, **kw):
        return ClusterSpec(routing=routing, result_cache=RESULT_CACHE, **kw)
    for routing in ("jsq", "random"):        # warm-up, uncounted
        _sim17(arrival, params, cluster(routing, autoscale=pol), n=chunk)
    out = {}
    for routing in ("jsq", "random"):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res = _sim17(arrival, params, cluster(routing, autoscale=pol))
        active = res.mean_active_replicas
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        if counts != _expect17(n_chunks, routing):
            raise AssertionError(f"17b {routing}: launches {counts}, "
                                 f"expected {_expect17(n_chunks, routing)}")
        rs, el = res.replica_seconds, res.elapsed_seconds
        if not bool(((pol.min_r * el <= rs)
                     & (rs <= pol.max_r * el * (1 + 1e-6))).all()):
            raise AssertionError(f"17b {routing}: replica_seconds outside "
                                 "[min_r, max_r] x elapsed")
        inside = (active > pol.min_r + 1e-3) & (active < pol.max_r - 1e-3)
        if not bool(inside.any()):
            raise AssertionError(f"17b {routing}: the policy never moved")
        if not bool(torch.isfinite(res.mean_response).all()):
            raise AssertionError(f"17b {routing}: non-finite means")
        n_total = lam.shape[0] * SIM17_QUERIES
        p95 = res.quantile(0.95)
        print(f"  {routing}: launches {counts}; {wall:.3f} s = "
              f"{n_total / wall:.4g} queries/s [{card}]; mean active "
              f"replicas {float(active.min()):.2f}..{float(active.max()):.2f}"
              f" (mean {float(active.mean()):.2f} of {pol.max_r}; "
              f"{int(inside.sum())} scenarios strictly inside); p95 "
              f"{float(p95.min()) * 1e3:.1f}..{float(p95.max()) * 1e3:.1f} "
              "ms")
        out[routing] = {"counts": counts, "wall": wall}

    # a pinned policy (min = max = 4) is the static r = 4 engine
    pinned = AutoscalePolicy(**dict(SIM17_POLICY, min_r=R))
    a = _sim17(arrival, params, cluster("jsq", autoscale=pinned))
    b = _sim17(arrival, params, cluster("jsq", r=R))
    _bit_identical(a, b, "17b pinned policy vs static r = 4")
    print(f"  jsq: pinned policy {R}..{R} bit-identical to static r = {R} "
          f"in {', '.join(_SHARED17)}; mean active "
          f"{float(a.mean_active_replicas.min()):.6f}.."
          f"{float(a.mean_active_replicas.max()):.6f}")
    # the kernel path against the plain path on the first chunks
    n = SIM17_PLAIN_CHUNKS * chunk
    for routing in ("jsq", "random"):
        kern = _sim17(arrival, params, cluster(routing, autoscale=pol), n=n)
        t0 = time.perf_counter()
        plain = _sim17(arrival, params, cluster(routing, autoscale=pol),
                       n=n, impl="torch")
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        err = max(_rel_err(kern.mean_response, plain.mean_response),
                  _rel_err(kern.replica_seconds, plain.replica_seconds))
        print(f"  {routing}: kernel path vs plain path over "
              f"{SIM17_PLAIN_CHUNKS} chunks: means and replica-seconds max "
              f"rel err {err:.2e} (limit 1e-5; plain path {plain_wall:.2f} s)")
        if not err <= 1e-5:
            raise AssertionError(f"17b {routing}: kernel vs plain {err}")
    return out


def _fault17(profile):
    """One FaultSpec with all four channels over the weekly profile:
    replica 0 down over the busiest bins of the first two days (five
    bins round each peak: the slab's horizons run from 21 bins at 160 qps
    to the whole week at 20 qps, and its warmup from 2 to 17 bins, so
    every scenario meets one window after warmup), the MTBF/MTTR chain, a
    degraded server, a k = p - 1 broker timeout and one hedge."""
    from repro_torch.core.faults import FaultSpec
    peaks = [d * 24 + int(profile[d * 24:(d + 1) * 24].argmax())
             for d in (0, 1)]
    return FaultSpec(
        outages=tuple((0, (b - 2) * SIM17_BIN_S, (b + 3) * SIM17_BIN_S)
                      for b in peaks),
        mtbf_seconds=20_000.0, mttr_seconds=2_000.0, degraded=((7, 1.5),),
        broker_timeout_seconds=0.25, quorum_k=P - 1,
        hedge_after_seconds=0.3, hedge_attempts=1)


def phase_faulted_fleet(card: str) -> dict:
    """17c: faults at full width: the 17b slab at r = 4 with one
    FaultSpec holding all four channels, under round-robin, random and
    JSQ; the identities, the plain path on the first chunks, the launch
    counts and a trace of the JSQ dispatch."""
    import torch
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.faults import FaultSpec
    lam, params = _slab17(SIM16_LAM, SIM16_SPEEDS)
    profile, arrival, chunk = _profile17(lam)
    n_chunks = -(-SIM17_QUERIES // chunk)
    fault = _fault17(profile)
    print(f"== phase 17c: faulted fleet, r = {R}, {lam.shape[0]} scenarios"
          f" x {SIM17_QUERIES:,} queries ({n_chunks} chunks of {chunk}), "
          f"{fault}")

    def cluster(routing, **kw):
        return ClusterSpec(r=R, routing=routing, result_cache=RESULT_CACHE,
                           **kw)
    # identities on the first chunks: fault=None is the fault-free
    # program, an all-up FaultSpec() is bit-identical in the shared stats
    n_id = SIM17_IDENTITY_CHUNKS * chunk
    for routing in ("round_robin", "random", "jsq"):
        base = _sim17(arrival, params, cluster(routing), n=n_id)
        none = _sim17(arrival, params, cluster(routing, fault=None), n=n_id)
        allup = _sim17(arrival, params, cluster(routing, fault=FaultSpec()),
                       n=n_id)
        _bit_identical(base, none, f"17c {routing} fault=None")
        _bit_identical(base, allup, f"17c {routing} all-up FaultSpec()")
        if float(allup.spill_count.sum()) or float(allup.unavail_count.sum()):
            raise AssertionError(f"17c {routing}: an all-up spec spilled")
    print(f"  fault=None and an all-up FaultSpec() bit-identical to the "
          f"fault-free run under round-robin, random and JSQ "
          f"({SIM17_IDENTITY_CHUNKS} chunks)")
    for routing in ("jsq", "random", "round_robin"):   # warm-up
        _sim17(arrival, params, cluster(routing, fault=fault), n=chunk)
    out = {}
    for routing in ("jsq", "random", "round_robin"):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res = _sim17(arrival, params, cluster(routing, fault=fault))
        spill = res.spill_fraction
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        if counts != _expect17(n_chunks, routing):
            raise AssertionError(f"17c {routing}: launches {counts}, "
                                 f"expected {_expect17(n_chunks, routing)}")
        if not bool((spill > 0).all()):
            raise AssertionError(f"17c {routing}: no spill under the "
                                 "outage")
        if not bool(torch.isfinite(res.mean_response).all()):
            raise AssertionError(f"17c {routing}: non-finite means")
        n_total = lam.shape[0] * SIM17_QUERIES
        p95 = res.quantile(0.95)
        print(f"  {routing}: launches {counts}; {wall:.3f} s = "
              f"{n_total / wall:.4g} queries/s [{card}]; availability "
              f"{float(res.availability.min()):.5f}..1, spill "
              f"{float(spill.min()):.4f}..{float(spill.max()):.4f}, "
              f"degraded {float(res.degraded_fraction.min()):.4f}.."
              f"{float(res.degraded_fraction.max()):.4f}, p95 "
              f"{float(p95.min()) * 1e3:.1f}..{float(p95.max()) * 1e3:.1f} "
              "ms")
        out[routing] = {"counts": counts, "wall": wall}
    free_wall = _wall(lambda: _sim17(arrival, params, cluster("jsq")))
    print(f"  jsq fault-free: {free_wall:.3f} s = "
          f"{lam.shape[0] * SIM17_QUERIES / free_wall:.4g} queries/s; the "
          f"faults cost x{out['jsq']['wall'] / free_wall:.2f} [{card}]")
    n = SIM17_PLAIN_CHUNKS * chunk
    for routing in ("jsq", "random"):
        kern = _sim17(arrival, params, cluster(routing, fault=fault), n=n)
        plain = _sim17(arrival, params, cluster(routing, fault=fault), n=n,
                       impl="torch")
        err = max(_rel_err(kern.mean_response, plain.mean_response),
                  _rel_err(kern.spill_count + 1, plain.spill_count + 1),
                  _rel_err(kern.degraded_count + 1,
                           plain.degraded_count + 1))
        print(f"  {routing}: kernel path vs plain path over "
              f"{SIM17_PLAIN_CHUNKS} chunks: means, spills and degraded "
              f"counts max rel err {err:.2e} (limit 1e-5)")
        if not err <= 1e-5:
            raise AssertionError(f"17c {routing}: kernel vs plain {err}")
    n = SIM17_TRACE_CHUNKS * chunk

    def traced_run():
        return _sim17(arrival, params, cluster("jsq", fault=fault), n=n)
    traced = phase_profile(
        card, _wall(traced_run), traced_run,
        f"phase 17c: device time by kernel, one faulted dispatch cut to "
        f"its first {SIM17_TRACE_CHUNKS} chunks (jsq, r = {R}, {n:,} "
        "queries)")
    _kernel_share(traced, "fleet_scan_kernel", "fleet scan")
    _kernel_share(traced, "jsq_reg_kernel", "JSQ router (masked)")
    return out


def phase_plans17(card: str) -> None:
    """17d: the N+1 plan for Scenario 4 at 200 qps; four policies through
    plan_over_grid priced by replica-seconds against the static-r
    frontier; and a fault axis, on a 4-scenario slab (cpu and disk x4)
    under the weekly profile."""
    import warnings

    import torch
    from repro_torch.core import capacity, planner, sweep
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.faults import FaultSpec
    from repro_torch.launch.elastic import AutoscalePolicy
    from repro_torch.workloadgen import loadgen
    print("== phase 17d: plans under change")
    p4 = capacity.scenario("memory+cpus+disks", device="cuda")
    t0 = time.perf_counter()
    plan = capacity.plan_capacity(p4, 200.0, ANSWER_SLO, simulate=True,
                                  survive_faults=1,
                                  cluster=ClusterSpec(routing="random"))
    wall = time.perf_counter() - t0
    print(f"  Scenario 4, 200 qps, N+1: {plan.n_replicas} replicas x "
          f"{plan.servers_per_replica} = {plan.total_servers} servers; "
          f"simulated p95 {plan.response_simulated_p95_ms:.1f} ms, with "
          f"{plan.survive_faults} replica down "
          f"{plan.response_faulted_p95_ms:.1f} ms (SLO "
          f"{ANSWER_SLO * 1e3:.0f} ms); {wall:.2f} s [{card}]")
    if plan.n_replicas < 5 or plan.response_faulted_p95_ms is None:
        raise AssertionError(f"N+1 plan {plan}")
    kw = dict(simulate=True, seed=17, quantile=0.95,
              n_queries=PLANS17_QUERIES,
              profile=loadgen.diurnal_rates(device="cuda"),
              profile_bin_seconds=SIM17_BIN_S, chunk_size=CHUNK)

    def grid(**axes):
        return sweep.SweepGrid.build(lam=PLANS17_LAM, p=[float(P)],
                                     cpu=[4.0], disk=[4.0], memory=1,
                                     result_cache=RESULT_CACHE,
                                     device="cuda", **axes)
    policies = tuple(AutoscalePolicy(min_r=1, max_r=mx,
                                     target_utilization=trig,
                                     decision_interval_seconds=SIM17_BIN_S,
                                     stabilization_intervals=2)
                     for mx in (2, R) for trig in (0.5, 0.7))
    with warnings.catch_warnings():   # the profile's chunk clamp
        warnings.simplefilter("ignore", UserWarning)
        t0 = time.perf_counter()
        res_pol, fr_pol = planner.plan_over_grid(
            grid(autoscale=policies), ANSWER_SLO,
            cluster=ClusterSpec(routing="jsq"), **kw)
        _, fr_static = planner.plan_over_grid(
            grid(r=[1.0, 2.0, float(R)]), ANSWER_SLO,
            cluster=ClusterSpec(routing="jsq"), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eff = (res_pol.stats.replica_seconds
           / res_pol.stats.elapsed_seconds).reshape(len(PLANS17_LAM), -1)
    print(f"  {len(policies)} policies vs static r (1, 2, {R}) over "
          f"{len(PLANS17_LAM)} rates (cpu, disk x4), JSQ, p95 <= "
          f"{ANSWER_SLO * 1e3:.0f} ms under the weekly profile, "
          f"{PLANS17_QUERIES:,} queries a scenario: {wall:.2f} s [{card}]")
    for i in range(len(PLANS17_LAM)):
        print(f"    elastic: {fr_pol.describe(i)}\n"
              f"    static:  {fr_static.describe(i)}\n"
              f"      mean active by policy "
              f"{[round(float(x), 2) for x in eff[i]]}")
    if not bool(torch.isfinite(eff).all()):
        raise AssertionError("17d: non-finite replica-seconds")
    scenarios = (None, FaultSpec(broker_timeout_seconds=0.25,
                                 quorum_k=P - 1),
                 FaultSpec(outages=((0, 0.0, 1e9),)),
                 FaultSpec(outages=((0, 0.0, 1e9),),
                           broker_timeout_seconds=0.25, quorum_k=P - 1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res_f, fr_f = planner.plan_over_grid(
            grid(r=[float(R)], fault=scenarios), ANSWER_SLO,
            cluster=ClusterSpec(routing="random"), **kw)
    p95 = res_f.quantile(0.95).reshape(len(PLANS17_LAM), -1)
    spill = res_f.stats.spill_fraction.reshape(len(PLANS17_LAM), -1)
    degr = res_f.stats.degraded_fraction.reshape(len(PLANS17_LAM), -1)
    print(f"  fault axis (None, quorum {P - 1}/{P}, replica 0 down, both) "
          f"at r = {R}, random:")
    for i in range(len(PLANS17_LAM)):
        print(f"    lam={PLANS17_LAM[i]:g}: p95 "
              f"{[round(float(x) * 1e3, 1) for x in p95[i]]} ms, spill "
              f"{[round(float(x), 3) for x in spill[i]]}, degraded "
              f"{[round(float(x), 3) for x in degr[i]]}")
    if not (float(spill[:, 0].max()) == 0.0 and float(spill[:, 2].min()) > 0
            and float(degr[:, 1].min()) >= 0.0):
        raise AssertionError("17d: the fault axis' channels are wrong")


def phase_plans_wide(card: str) -> None:
    """17e: plan_capacity(survive_faults=1, simulate=True) on Table 5's
    hardware at 500 qps, whose N+1 plan needs more than 16 replicas,
    under random and JSQ routing: the faulted cross-check runs the fleet
    scan (and the router) past 16 replicas on the card; the replica
    count equals the CPU's at the same cut query count, and at that count
    the card's simulated and faulted p95 equal the CPU's on the same
    draws."""
    import torch
    from repro_torch.core import capacity
    from repro_torch.core.cluster import ClusterSpec
    print(f"== phase 17e: N+1 plans past 16 replicas ({PLAN17E_RATE:g} qps, "
          f"SLO {PLAN17E_SLO:g} s, {PLAN17E_QUERIES:,} queries a "
          "simulation)")
    for routing in ("random", "jsq"):
        kw = dict(simulate=True, survive_faults=1, n_queries=PLAN17E_QUERIES,
                  cluster=ClusterSpec(routing=routing))
        _reset_counts()
        t0 = time.perf_counter()
        card_plan = capacity.plan_capacity(
            capacity.TABLE5_PARAMS, PLAN17E_RATE, PLAN17E_SLO,
            device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        t0 = time.perf_counter()
        cpu_plan = capacity.plan_capacity(
            capacity.TABLE5_PARAMS, PLAN17E_RATE, PLAN17E_SLO, device="cpu",
            **kw)
        cpu_wall = time.perf_counter() - t0
        print(f"  {routing}: {card_plan.n_replicas} replicas x "
              f"{card_plan.servers_per_replica} (N+{card_plan.survive_faults})"
              f"; simulated p95 {card_plan.response_simulated_p95_ms:.1f} ms,"
              f" with 1 replica down {card_plan.response_faulted_p95_ms:.1f}"
              f" ms; {wall:.2f} s [{card}]; launches {counts}; the CPU's "
              f"plan {cpu_plan.n_replicas} replicas (faulted p95 "
              f"{cpu_plan.response_faulted_p95_ms:.1f} ms, {cpu_wall:.2f} s)")
        if not (card_plan.n_replicas > 16
                and card_plan.n_replicas == cpu_plan.n_replicas):
            raise AssertionError(f"17e {routing}: plan {card_plan} vs the "
                                 f"CPU's {cpu_plan.n_replicas} replicas")
        if not math.isfinite(card_plan.response_faulted_p95_ms):
            raise AssertionError(f"17e {routing}: no faulted p95")
        if counts["fleet_scan"] == 0 or (
                (counts["jsq_route"] > 0) != (routing == "jsq")):
            raise AssertionError(f"17e {routing}: launches {counts}")
        _plan_p95_vs_cpu(card, routing, card_plan.n_replicas)


def _plan_p95_vs_cpu(card: str, routing: str, n: int) -> None:
    """17e's p95s at the plan's replica count, as the plan's last two
    simulations run them (all up; replica 0 down the whole run), on the
    card and on the CPU from the same draws: made on the card in float64
    (so that no JSQ choice or histogram bin turns on the two devices'
    rounding) and copied."""
    import torch
    from repro_torch.core import capacity, simulator
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.faults import FaultSpec
    f64, params = torch.float64, capacity.TABLE5_PARAMS
    chunk = min(simulator.DEFAULT_CHUNK, PLAN17E_QUERIES)
    vp = simulator._vec_params(params, torch.device("cuda"), f64)
    on_card = []
    for c in range(-(-PLAN17E_QUERIES // chunk)):
        base = simulator.chunk_random_draws(
            17, c, 1, chunk, int(params.p), vp, "exponential",
            device="cuda", dtype=f64)
        side = simulator.chunk_side_draws(
            17, c, 1, chunk, route_r=n if routing == "random" else None,
            device="cuda", dtype=f64)
        on_card.append((*base, side))
    on_cpu = [tuple(t.cpu() for t in d[:3])
              + ({k: v.cpu() for k, v in d[3].items()},) for d in on_card]
    draws = {"cuda": on_card, "cpu": on_cpu}
    horizon = 2.0 * PLAN17E_QUERIES / PLAN17E_RATE
    row = []
    for label, fault in (("all up", None),
                         ("1 down", FaultSpec(outages=((0, 0.0, horizon),)))):
        cl = ClusterSpec(r=n, routing=routing, fault=fault)
        p95 = {dev: float(simulator.simulate_fork_join(
            17, PLAN17E_RATE, PLAN17E_QUERIES, params, cluster=cl,
            draws=lambda c, dev=dev: draws[dev][c], device=dev,
            dtype=f64).quantile(0.95)) * 1e3 for dev in draws}
        err = abs(p95["cuda"] - p95["cpu"]) / p95["cpu"]
        row.append(f"{label} card {p95['cuda']:.3f} ms, CPU "
                   f"{p95['cpu']:.3f} ms (rel diff {err:.1e})")
        if not err <= P95_REL_TOL:
            raise AssertionError(f"17e {routing} r={n} {label}: p95 card "
                                 f"{p95['cuda']} vs CPU {p95['cpu']}")
    print(f"    r = {n}, same float64 draws, p95 [{card}]: "
          + "; ".join(row) + f" (limit {P95_REL_TOL:g} relative)")


# ------------------------------------------------------------ observability
def _trace_busy(run) -> tuple[float, int]:
    """(device busy ms, kernel launches) of one ``run()`` under the
    profiler (after a discarded warm-up step, as `phase_profile`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 ) as prof:
        warm = torch.ones(1, device="cuda")
        for _ in range(8):
            warm.add_(1)
        torch.cuda.synchronize()
        prof.step()
        run()
        torch.cuda.synchronize()
        prof.step()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith("ProfilerStep")]
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def _busy_totals(seed, lam, params, n, cache):
    """Each scenario's summed effective server and broker service seconds
    (misses only) over the first ``n`` queries, from the engine's own
    draws in float64: what the timeline's busy tallies must add up to."""
    import torch
    from repro_torch.core import simulator
    vp = simulator._vec_params(params, torch.device("cuda"), torch.float32)
    n_scen = lam.shape[0]
    hit = torch.full((n_scen,), cache[0], device="cuda")
    srv = torch.zeros(n_scen, dtype=torch.float64, device="cuda")
    brk = torch.zeros_like(srv)
    for c in range(-(-n // CHUNK)):
        _, u_brk, svc = simulator.chunk_random_draws(
            seed, c, n_scen, CHUNK, P, vp, "exponential", device="cuda")
        side = simulator.chunk_side_draws(seed, c, n_scen, CHUNK,
                                          cache_hit=hit, device="cuda")
        miss = 1.0 - side["cache_hit"].to(torch.float32)
        srv += (svc * miss[:, None, :]).sum((1, 2), dtype=torch.float64)
        brk += (u_brk * vp.s_broker[:, None] * miss).sum(
            1, dtype=torch.float64)
    return srv, brk


def phase_observability(card: str, mem7: dict) -> None:
    """18: the telemetry layer on the card.  (a) 16b's 64-scenario slab
    at r = 1 and r = 4 (random, JSQ), one dispatch each with and without
    telemetry; (b) 17b's autoscaled and 17c's faulted dispatches, first
    128 chunks; (c) card against CPU on a small slab; (d) a JSQ span
    trace; (e) the kernel profiles; (f) a rendered timeline."""
    import dataclasses
    import warnings

    import torch
    from repro_torch.core import simulator
    from repro_torch.core.arrivals import ArrivalProcess
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.faults import FaultSpec
    from repro_torch.launch.elastic import AutoscalePolicy
    from repro_torch.obs import TelemetrySpec
    from repro_torch.obs import profile as obs_profile
    from repro_torch.obs import report as obs_report
    from repro_torch.obs import trace_export
    spec = TelemetrySpec(n_bins=OBS_BINS, slo_seconds=ANSWER_SLO)
    lam, params = _slab17(SIM16_LAM, SIM16_SPEEDS)
    n_scen, n = lam.shape[0], SIM16_QUERIES
    print(f"== phase 18a: telemetry on 16b's slab ({n_scen} scenarios x "
          f"{n:,} queries, result cache {RESULT_CACHE}), {spec}")
    srv_tot, brk_tot = _busy_totals(18, lam, params, n, RESULT_CACHE)
    shown = None
    for r, routing in ((1, "round_robin"), (R, "random"), (R, "jsq")):
        cluster = ClusterSpec(r=r, routing=routing,
                              result_cache=RESULT_CACHE)

        def run(tel, n=n):
            return simulator.simulate_fork_join_batch(
                18, lam, params, n, p=P, chunk_size=CHUNK, cluster=cluster,
                telemetry=tel)
        run(None, CHUNK)                                      # warm-up
        run(spec, CHUNK)
        walls, res = {}, {}
        for key, tel in (("off", None), ("on", spec)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[key] = run(tel)
            torch.cuda.synchronize()
            walls[key] = time.perf_counter() - t0
        _bit_identical(res["off"], res["on"], f"18a r={r} {routing}")
        tl = res["on"].timeline
        if not bool((tl.count.sum(-1) == float(n)).all()) or not bool(
                (tl.replica_count.sum((-2, -1)) == float(n)).all()):
            raise AssertionError(f"18a r={r} {routing}: counts do not sum "
                                 f"to {n}")
        busy_err = max(
            _rel_err(tl.busy_server.double().sum((1, 2, 3)), srv_tot),
            _rel_err(tl.busy_broker.double().sum((1, 2)), brk_tot))
        worst = max(obs_report.oplaw_check(tl.map(lambda x, i=i: x[i]))[1]
                    for i in range(n_scen))
        m = OBS_TRACE_CHUNKS
        off_ms, off_k = _trace_busy(lambda: run(None, m * CHUNK))
        on_ms, on_k = _trace_busy(lambda: run(spec, m * CHUNK))
        print(f"  r = {r} {routing}: base statistics bit-identical with and "
              f"without telemetry; counts sum to {n:,} in every scenario; "
              f"busy sums vs the draws' effective service max rel err "
              f"{busy_err:.1e} (limit 1e-5); operational laws worst per-bin "
              f"deviation {worst:.1e} (limit 1e-6)")
        print(f"    wall {walls['off']:.3f} s without, {walls['on']:.3f} s "
              f"with telemetry [{card}]; over {m} chunks the device is busy "
              f"{off_ms:.2f} / {on_ms:.2f} ms in {off_k} / {on_k} launches: "
              f"+{(on_ms - off_ms) / m:.3f} ms and +{(on_k - off_k) / m:.1f} "
              f"launches a chunk")
        if not busy_err <= 1e-5 or not worst <= 1e-6:
            raise AssertionError(f"18a r={r} {routing}: busy {busy_err}, "
                                 f"laws {worst}")
        if r == R and routing == "jsq":
            shown = tl.map(lambda x: x[n_scen - 1])
    peaks = phase_memory_law(card, telemetry=spec)
    print(f"  peak above baseline at r = {R}: {peaks[R] / 2**20:.1f} MiB "
          f"with telemetry, {mem7[R] / 2**20:.1f} MiB without (phase 7) "
          f"[{card}]")

    # (b) the cluster under change, every query counted (no warmup)
    profile, arrival, chunk = _profile17(lam)
    n17 = SIM17_TRACE_CHUNKS * chunk
    pol = AutoscalePolicy(**SIM17_POLICY)
    fault = _fault17(profile)
    print(f"== phase 18b: telemetry under change, 17b's and 17c's JSQ "
          f"dispatches cut to {SIM17_TRACE_CHUNKS} chunks ({n17:,} queries"
          f" a scenario), warmup 0")
    for label, cl in (("autoscaled", dict(autoscale=pol)),
                      ("faulted", dict(r=R, fault=fault))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            t0 = time.perf_counter()
            res = simulator.simulate_fork_join_batch(
                SIM17_SEED, arrival, params, n17, p=P, chunk_size=CHUNK,
                warmup_fraction=0.0, telemetry=spec,
                cluster=ClusterSpec(routing="jsq",
                                    result_cache=RESULT_CACHE, **cl))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        tl = res.timeline
        cnt = tl.count.sum(-1)
        if not bool((cnt == float(n17)).all()):
            raise AssertionError(f"18b {label}: counts {cnt}")
        if label == "autoscaled":
            act = tl.active_sum.sum(-1) / cnt
            tw = res.replica_seconds / res.elapsed_seconds
            bins = tl.active_replicas[tl.count > 0]
            ok = bool(((bins >= pol.min_r - 1e-6)
                       & (bins <= pol.max_r + 1e-6)).all())
            print(f"  autoscaled: active replicas a bin "
                  f"{float(bins.min()):.2f}..{float(bins.max()):.2f} within "
                  f"[{pol.min_r}, {pol.max_r}]: {ok}; arrival-weighted mean "
                  f"{float(act.min()):.3f}..{float(act.max()):.3f} beside "
                  f"SimResult's time-weighted {float(tw.min()):.3f}.."
                  f"{float(tw.max()):.3f}; {wall:.2f} s [{card}]")
            if not ok or float(bins.max()) <= float(bins.min()):
                raise AssertionError("18b: the active trajectory is wrong")
        else:
            spill = tl.spill_sum.double().sum(-1)
            degr = tl.degraded_sum.double().sum(-1)
            up = tl.up_sum.double().sum(-1)
            avail = cnt.double() - res.unavail_count.double()
            same = (bool(torch.equal(spill, res.spill_count.double()))
                    and bool(torch.equal(degr, res.degraded_count.double())))
            bounded = bool(((up >= avail) & (up <= R * cnt.double())).all())
            print(f"  faulted: spill and degraded sums equal SimResult's "
                  f"spill_count and degraded_count: {same} (spill "
                  f"{float(spill.sum()):.0f}, degraded "
                  f"{float(degr.sum()):.0f}); up-replica sums within "
                  f"[available queries, {R} x count]: {bounded}, mean up "
                  f"{float((up / cnt).min()):.3f}.."
                  f"{float((up / cnt).max()):.3f}; {wall:.2f} s [{card}]")
            if not same or not bounded or not float(spill.sum()) > 0:
                raise AssertionError("18b: the fault channels disagree")

    # (c) card against CPU on the same draws, in float64 (so that no
    # arrival's bin depends on the two cumulative sums' rounding)
    s_c, f64 = OBS_CPU_SCEN, torch.float64

    def params_on(dev):
        return type(params)(p=P, **{
            f.name: getattr(params, f.name)[:s_c].to(dev, f64)
            for f in dataclasses.fields(params) if f.name != "p"})
    small = FaultSpec(outages=((0, 20.0, 200.0),), mtbf_seconds=2000.0,
                      mttr_seconds=200.0, broker_timeout_seconds=0.25,
                      quorum_k=P - 1)
    cl = ClusterSpec(r=R, routing="jsq", result_cache=RESULT_CACHE,
                     fault=small)
    vp = simulator._vec_params(params_on("cuda"), torch.device("cuda"), f64)
    hit = torch.full((s_c,), RESULT_CACHE[0], dtype=f64, device="cuda")
    per_chunk = []
    for c in range(OBS_CPU_CHUNKS):
        base = simulator.chunk_random_draws(18, c, s_c, OBS_CPU_CHUNK, P, vp,
                                            "exponential", device="cuda",
                                            dtype=f64)
        side = simulator.chunk_side_draws(18, c, s_c, OBS_CPU_CHUNK,
                                          cache_hit=hit, fault_r=R,
                                          device="cuda", dtype=f64)
        per_chunk.append((*base, side))
    cpu_chunks = [tuple(t.cpu() for t in d[:3])
                  + ({k: v.cpu() for k, v in d[3].items()},)
                  for d in per_chunk]
    n_c = OBS_CPU_CHUNKS * OBS_CPU_CHUNK
    spec_c = TelemetrySpec(n_bins=16)
    on_card = simulator.simulate_fork_join_batch(
        18, lam[:s_c].to(f64), params_on("cuda"), n_c, p=P,
        chunk_size=OBS_CPU_CHUNK, cluster=cl, telemetry=spec_c,
        draws=lambda c: per_chunk[c], dtype=f64).timeline
    on_cpu = simulator.simulate_fork_join_batch(
        18, lam[:s_c].to("cpu", f64), params_on("cpu"), n_c, p=P,
        chunk_size=OBS_CPU_CHUNK, cluster=cl, telemetry=spec_c,
        draws=lambda c: cpu_chunks[c], device="cpu", dtype=f64).timeline
    worst = 0.0
    for f in dataclasses.fields(on_card):
        a, b = getattr(on_card, f.name), getattr(on_cpu, f.name)
        if a is None:
            continue
        a, b = a.cpu().double(), b.double()
        if f.name in ("count", "replica_count", "up_sum", "spill_sum"):
            if not torch.equal(a, b):
                raise AssertionError(f"18c: {f.name} differs card vs CPU")
            continue
        err = float(((a - b).abs() / (b.abs() + b.abs().max() + 1e-300)
                     ).max())
        worst = max(worst, err)
    print(f"== phase 18c: card vs CPU timelines on the same draws ({s_c} "
          f"scenarios x {n_c:,} queries, r = {R}, JSQ, cache, faults, "
          f"float64): counts, routing, up and spill sums equal; float sums "
          f"max error {worst:.1e} of the bin plus the largest bin (limit "
          f"1e-12)")
    if not worst <= 1e-12:
        raise AssertionError(f"18c: card vs CPU {worst}")

    # (d) a span trace through the router and the segmented scan
    horizon = OBS_SPANS / (24.0 * 1.6)
    flash = ArrivalProcess.flash_crowd(
        24.0, burst_starts=0.35 * horizon, burst_seconds=0.2 * horizon,
        burst_multiplier=4.0, period_seconds=horizon,
        bin_seconds=horizon / 64, device="cuda")
    from repro_torch.core import capacity
    _reset_counts()
    t0 = time.perf_counter()
    spans = trace_export.simulate_spans(0, flash, OBS_SPANS,
                                        capacity.TABLE5_PARAMS, r=R,
                                        routing="jsq", device="cuda")
    wall = time.perf_counter() - t0
    counts = _counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = trace_export.export_chrome_trace(
            spans, pathlib.Path(tmp) / "phase18_spans.json")
        checked = trace_export.validate_chrome_trace(path)
    print(f"== phase 18d: span trace, {OBS_SPANS} queries of a flash crowd, "
          f"r = {R}, JSQ: launches {counts}; {checked['X']} service spans, "
          f"{checked['async_pairs']} lifetimes, {checked['lanes']} lanes, "
          f"schema OK; {wall:.2f} s [{card}]")
    if counts["jsq_route"] != 1 or counts["maxplus_segment_scan"] != 2:
        raise AssertionError(f"18d: launches {counts}")

    # (e) the kernel profiles, (f) one rendered timeline
    print("== phase 18e: kernel profiles (first call, CUDA-event median of "
          f"3, peak memory) [{card}]")
    print(obs_report.render_profiles(obs_profile.profile_kernels(
        device="cuda")))
    print("== phase 18f: a rendered timeline")
    print(obs_report.render_timeline(
        shown, f"16b slab's last scenario, r = {R}, JSQ, {n:,} queries"))


# -- phase 19: the calibration loop ------------------------------------------

ENGINE_CORPUS = dict(n_docs=400_000, vocab_size=50_000, mean_doc_len=150,
                     seed=0)           # 50,000 pages a server (Table 5: 1.25 M)
ENGINE_P = 8                    # Table 5's index servers
ENGINE_K = 10                   # local top-k, the broker's k
ENGINE_BATCH = 64
ENGINE_QUERIES = 128 * ENGINE_BATCH     # 8,192 queries a measured run
ENGINE_WARM = 16 * ENGINE_BATCH         # the warm pass that sets the rates
ENGINE_RHO = (0.3, 0.5, 0.7)
ENGINE_WINDOWS = 15             # 5 a run
ENGINE_TARGET_QPS = 200.0
CAL_SLO = 0.300
SCORE_RTOL = 1e-6               # card vs CPU scores, tests/test_torch_engine
T5_QUERIES = 60_000             # calibrate_and_plan.py's trace, nothing cut
T5_CROWD = dict(burst_starts=[900.0], burst_seconds=450.0,
                burst_multiplier=2.2, period_seconds=1800.0,
                bin_seconds=60.0)
T5_WINDOWS, T5_HOLDOUT, T5_SIM_QUERIES = 24, 0.25, 40_000
T5_TARGET_QPS = 120.0
CAL_RTOL = 1e-5                 # card vs CPU fit on the same trace
SCAN_RTOL = {"torch.float32": 1e-5, "torch.float64": 1e-12}   # phase 2's
# float32 tangents are held outside busy periods that hold a near-tie: an
# arrival within this many ulps of its server going idle, where the two
# paths' rounding may take opposite sides of the max
TIE_ULPS = 16


def _same_topk(card_out, cpu_out, what: str) -> None:
    import torch
    (cs, cd), (ps, pd) = ((x.cpu() for x in o) for o in (card_out, cpu_out))
    if not torch.equal(cd, pd):
        raise AssertionError(f"{what}: top-k ids differ from the CPU's")
    if not torch.equal(torch.isneginf(cs), torch.isneginf(ps)):
        raise AssertionError(f"{what}: -inf padding differs from the CPU's")
    fin = torch.isfinite(ps)
    err = _rel_err(cs[fin], ps[fin]) if bool(fin.any()) else 0.0
    if not err <= SCORE_RTOL:
        raise AssertionError(f"{what}: scores differ by {err} > "
                             f"{SCORE_RTOL}")
    print(f"  {what}: ids equal, scores max rel err {err:.2e} "
          f"(rtol {SCORE_RTOL:g}), {int((~fin).sum())} -inf entries")


def phase_engine(card: str) -> dict:
    """19a: the toy engine at Table 5's layout, card against CPU."""
    import dataclasses
    import torch
    from repro_torch.engine import corpus as corpus_lib
    from repro_torch.engine import distributed, partition, server
    from repro_torch.engine import index as index_lib
    from repro_torch.workloadgen import querygen
    print(f"== phase 19a: the toy engine, p = {ENGINE_P} index servers")
    t0 = time.perf_counter()
    corp = corpus_lib.generate_corpus(corpus_lib.CorpusConfig(
        **ENGINE_CORPUS))
    t1 = time.perf_counter()
    part = partition.partition_documents(corp, ENGINE_P)
    t2 = time.perf_counter()
    shards = [server.IndexServer(ix, k_local=ENGINE_K, device="cuda")
              for ix in part.shards]
    uni = querygen.build_universe(dataclasses.replace(
        querygen.TODOBR, vocab_size=ENGINE_CORPUS["vocab_size"]))
    n_q = ENGINE_WARM + len(ENGINE_RHO) * ENGINE_QUERIES
    _, qterms = querygen.sample_query_stream(uni, n_q, seed=1)
    t3 = time.perf_counter()
    budgets = [s.budget for s in shards]
    print(f"  corpus {corp.n_docs:,} docs, {corp.n_postings:,} postings "
          f"({t1 - t0:.1f} s, host); {ENGINE_P} shards of "
          f"{part.shards[0].n_docs:,}-{max(s.n_docs for s in part.shards):,}"
          f" docs, budgets {min(budgets):,}-{max(budgets):,} ({t2 - t1:.1f}"
          f" s); TodoBR queries, {n_q:,} ({t3 - t2:.1f} s)")

    batch = torch.as_tensor(qterms[:ENGINE_BATCH], device="cuda")
    _same_topk(shards[0].process(batch),
               server.IndexServer(part.shards[0], k_local=ENGINE_K,
                                  device="cpu").process(qterms[:ENGINE_BATCH]),
               f"shard 0, one batch of {ENGINE_BATCH}, card vs CPU")
    t0 = time.perf_counter()
    whole = server.IndexServer(index_lib.build_index(corp), k_local=ENGINE_K,
                               device="cuda")
    single_s, single_d = whole.process(batch)
    dist_s, dist_d = distributed.make_search_fn(
        None, distributed.stack_shards(part, device="cuda"),
        k=ENGINE_K)(batch)
    fin = torch.isfinite(single_s)
    if not torch.equal(fin, torch.isfinite(dist_s)):
        raise AssertionError("stacked search: -inf entries differ from the "
                             "single index's")
    err = _rel_err(dist_s[fin], single_s[fin])
    same_ids = float((dist_d == single_d)[fin].float().mean())
    if not err <= 1e-4:                     # the reference test's rtol
        raise AssertionError(f"stacked 8-shard search vs single index: "
                             f"scores differ by {err} > 1e-4")
    print(f"  stacked 8-shard search == single index ({whole.budget:,} "
          f"budget): scores max rel err {err:.2e} (rtol 1e-4), ids equal "
          f"at {100 * same_ids:.1f} % of the finite entries "
          f"({time.perf_counter() - t0:.1f} s with the host build)")
    del whole, single_s, single_d, dist_s, dist_d
    torch.cuda.empty_cache()

    ms = _time_ms(lambda: shards[0].process(batch), n=20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    shards[0].process(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"  scorer: {ms:.3f} ms a batch of {ENGINE_BATCH} at budget "
          f"{shards[0].budget:,} (one shard), peak {peak / 2**20:.0f} MiB "
          f"above the index [{card}]")
    phase_profile(card, _wall(lambda: shards[0].process(batch)),
                  lambda: shards[0].process(batch),
                  "phase 19a: device time by kernel, one scorer batch")
    return dict(part=part, shards=shards, qterms=qterms)


def phase_engine_calibration(card: str, eng: dict) -> None:
    """19b: measure -> fit -> plan on the engine, three Poisson rates."""
    import numpy as np
    import torch
    from repro_torch.calibrate import (calibrate, measure_engine_trace,
                                       plan_from_trace)
    from repro_torch.core.simulator import fcfs_completion_times
    from repro_torch.workloadgen import loadgen
    print(f"== phase 19b: measure -> fit -> plan on the engine, "
          f"{ENGINE_QUERIES:,} queries a rate")
    part, shards, qterms = eng["part"], eng["shards"], eng["qterms"]
    cache_bytes = sum(s.index_bytes() for s in part.shards) // (
        5 * ENGINE_P)
    t0 = time.perf_counter()
    warm = measure_engine_trace(
        shards, qterms[:ENGINE_WARM], np.arange(ENGINE_WARM, dtype=float),
        cache_bytes=cache_bytes, batch=ENGINE_BATCH)
    busy = float(warm.server_busy.mean())
    print(f"  warm pass: mean server busy {busy * 1e3:.3f} ms, hit "
          f"{float(warm.server_hit.mean()):.3f}, broker "
          f"{float(warm.broker_busy.mean()) * 1e3:.4f} ms "
          f"({time.perf_counter() - t0:.1f} s) [{card}]")
    traces = []
    for i, rho in enumerate(ENGINE_RHO):
        lam = rho / busy
        q = qterms[ENGINE_WARM + i * ENGINE_QUERIES:
                   ENGINE_WARM + (i + 1) * ENGINE_QUERIES]
        arr = loadgen.poisson_arrivals(lam, 1.2 * ENGINE_QUERIES / lam,
                                       seed=10 + i)
        if arr.shape[0] < ENGINE_QUERIES:
            raise AssertionError(f"only {arr.shape[0]} arrivals drawn")
        t0 = time.perf_counter()
        tr = measure_engine_trace(shards, q, arr[:ENGINE_QUERIES],
                                  cache_bytes=cache_bytes,
                                  batch=ENGINE_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        done = fcfs_completion_times(tr.arrival, tr.broker_busy,
                                     impl="torch")
        plain = torch.amax(fcfs_completion_times(
            done[None, :].expand(ENGINE_P, tr.n_queries), tr.server_busy.T,
            impl="torch"), dim=0)
        err = _rel_err(tr.response + tr.arrival, plain)
        if not err <= SCAN_RTOL["torch.float32"]:
            raise AssertionError(f"rho {rho}: the kernel's replay differs "
                                 f"from the plain scan's by {err}")
        print(f"  rho {rho}: {lam:.2f} qps, realized rho "
              f"{float(tr.server_busy.mean()) * float(tr.observed_rate):.3f}"
              f", hit {float(tr.server_hit.mean()):.3f}, mean response "
              f"{float(tr.response.mean()) * 1e3:.2f} ms; replay kernel vs "
              f"plain scan max rel err {err:.2e} (completions, rtol "
              f"{SCAN_RTOL['torch.float32']:g}); {wall:.1f} s [{card}]")
        traces.append(tr)
    cal = calibrate(traces, n_windows=ENGINE_WINDOWS)
    _reset_counts()
    t0 = time.perf_counter()
    mcal = calibrate(traces, n_windows=ENGINE_WINDOWS, residual="maxplus")
    torch.cuda.synchronize()
    launches = _counts()["maxplus_scan"]
    if launches == 0:
        raise AssertionError("refine(residual='maxplus') launched no scan")
    _, plan = plan_from_trace(traces, ENGINE_TARGET_QPS, CAL_SLO,
                              n_windows=ENGINE_WINDOWS)
    for tag, c in (("analytic", cal), ("maxplus", mcal)):
        p = c.params
        print(f"  {tag:8s}: S_broker {float(p.s_broker) * 1e3:.4f} ms, "
              f"S_hit {float(p.s_hit) * 1e3:.4f} ms, S_miss "
              f"{float(p.s_miss) * 1e3:.4f} ms, S_disk "
              f"{float(p.s_disk) * 1e3:.3f} ms, hit {float(p.hit):.4f}, "
              f"alpha {float(c.alpha):.4f}, s_scale {float(c.s_scale):.5f}")
    print(f"  the maxplus fit: {launches} scan launches "
          f"({time.perf_counter() - t0:.2f} s) [{card}]")
    print(f"  plan for {ENGINE_TARGET_QPS:.0f} qps under "
          f"{CAL_SLO * 1e3:.0f} ms: {plan.n_replicas} x "
          f"{plan.servers_per_replica} servers (R_upper "
          f"{plan.response_upper_ms:.2f} ms, util {plan.utilization:.3f})")


def _fields_close(a, b) -> float:
    """Largest relative difference of the Eq 1 fields of ``a`` from
    ``b``'s."""
    errs = {f: abs(float(getattr(a, f)) - float(getattr(b, f)))
            / abs(float(getattr(b, f)))
            for f in ("s_broker", "s_hit", "s_miss", "s_disk", "hit")}
    return max(errs.values())


def phase_table5_roundtrip(card: str):
    """19c: the 60,000-query Table 5 round trip, card against CPU."""
    import torch
    from repro_torch.calibrate import (calibrate_and_validate,
                                       simulate_trace, validate)
    from repro_torch.calibrate.measure import _sample_arrivals
    from repro_torch.core import capacity
    from repro_torch.core.arrivals import ArrivalProcess
    from repro_torch.core.cluster import ClusterSpec
    print(f"== phase 19c: Table 5 round trip (p = 8), {T5_QUERIES:,} "
          "queries of a flash crowd")
    true = capacity.TABLE5_PARAMS
    crowd = ArrivalProcess.flash_crowd(10.0, device="cuda", **T5_CROWD)
    u = torch.empty(T5_QUERIES, device="cuda").exponential_(
        generator=torch.Generator(device="cuda").manual_seed(0))
    arrivals_s = _wall(lambda: _sample_arrivals(u, crowd))
    t0 = time.perf_counter()
    trace = simulate_trace(0, crowd, T5_QUERIES, true, device="cuda")
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    print(f"  simulate_trace: {sim_s:.2f} s, of which the per-query "
          f"arrival recurrence (host) {arrivals_s:.2f} s; "
          f"{trace.n_queries:,} queries kept [{card}]")
    kw = dict(n_windows=T5_WINDOWS, holdout_fraction=T5_HOLDOUT,
              simulator_queries=T5_SIM_QUERIES)
    t0 = time.perf_counter()
    cal, report = calibrate_and_validate(trace, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(report.summary())
    err = _fields_close(cal.params, true)
    alpha = float(cal.alpha)
    print(f"  calibrate_and_validate {wall:.2f} s: Eq 1 parameters within "
          f"{100 * err:.2f} % of the truth, alpha {alpha:.4f}, held-out "
          f"max error vs the simulator {100 * report.max_rel_err_vs_sim:.2f}"
          f" % [{card}]")
    if not (err <= 0.05 and 0.0 < alpha < 1.0
            and report.max_rel_err_vs_sim <= 0.10):
        raise AssertionError("the round trip misses the reference's "
                             "acceptance (5 %, 0 < alpha < 1, 10 %)")
    _reset_counts()
    t0 = time.perf_counter()
    rep = validate(trace, cal, cluster=ClusterSpec(r=4, routing="jsq"), **kw)
    torch.cuda.synchronize()
    counts = _counts()
    if not (counts["maxplus_segment_scan"] > 0 and counts["jsq_route"] > 0):
        raise AssertionError(f"the replicated column missed a kernel: "
                             f"{counts}")
    print(f"  replicated column (r = 4, JSQ): max error vs it "
          f"{100 * float(rep.rel_err_replicated.max()):.2f} %; "
          f"{counts['maxplus_segment_scan']} segmented scans, "
          f"{counts['jsq_route']} router launches "
          f"({time.perf_counter() - t0:.2f} s) [{card}]")

    host = trace.map(lambda x: x.cpu())
    t0 = time.perf_counter()
    cal_c, _ = calibrate_and_validate(host, **kw)
    diff = _fields_close(cal.params, cal_c.params)
    for name in ("alpha", "s_scale"):
        x, y = float(getattr(cal, name)), float(getattr(cal_c, name))
        diff = max(diff, abs(x - y) / abs(y))
    plans = [capacity.plan_capacity(c.params, T5_TARGET_QPS, CAL_SLO)
             for c in (cal, cal_c)]
    print(f"  card vs CPU on the same trace: parameters, alpha and s_scale "
          f"within {diff:.2e} (rtol {CAL_RTOL:g}); plans "
          f"{plans[0].n_replicas} / {plans[1].n_replicas} replicas for "
          f"{T5_TARGET_QPS:.0f} qps ({time.perf_counter() - t0:.1f} s on "
          "the CPU)")
    if not (diff <= CAL_RTOL and plans[0].n_replicas == plans[1].n_replicas):
        raise AssertionError("the card's calibration differs from the CPU's")
    return trace


def _near_tie_taint(a, b, out):
    """Elements in busy periods that hold a near-tie (``TIE_ULPS``):
    there the two paths' rounding may decide the max differently."""
    import torch
    from repro_torch.kernels.maxplus_scan.ref import _shift_right
    c = _shift_right(out, 1, -math.inf) + b
    tol = TIE_ULPS * torch.finfo(a.dtype).eps * a.abs()
    near = (a - c).abs() <= tol
    seg = torch.cumsum((a - c > tol).to(torch.int64), dim=-1)
    tainted = torch.zeros(a.shape[0], a.shape[1] + 1, dtype=torch.int64,
                          device=a.device).scatter_add_(
        1, seg, near.to(torch.int64)) > 0
    return torch.gather(tainted, 1, seg)


def phase_scan_tangent(card: str, trace) -> None:
    """19d: the scan's forward-mode rule on the kernel, the scan's times at
    the calibration's shapes, and a profile of the maxplus fit."""
    import torch
    from repro_torch.calibrate import calibrate
    from repro_torch.core.simulator import fcfs_completion_times
    from repro_torch.kernels.maxplus_scan import kernel
    print(f"== phase 19d: the scan's tangent at ({ENGINE_P}, "
          f"{trace.n_queries:,}), kernel vs plain path")
    n = trace.n_queries
    for dtype in (torch.float32, torch.float64):
        tr = trace.map(lambda x: x.to(dtype))
        done = fcfs_completion_times(tr.arrival, tr.broker_busy,
                                     impl="torch")
        fork = done[None, :].expand(ENGINE_P, n)
        busy = tr.server_busy.T.contiguous()
        one = torch.ones((), dtype=dtype, device="cuda")

        def jvp(impl):
            return torch.func.jvp(
                lambda s: fcfs_completion_times(fork, busy * s, impl=impl),
                (one,), (one,))
        _reset_counts()
        ko, kt = jvp("cuda")
        torch.cuda.synchronize()
        launches = _counts()["maxplus_scan"]
        po, pt = jvp("torch")
        rtol = SCAN_RTOL[str(dtype)]
        primal = _rel_err(ko, po)
        if dtype == torch.float64:
            keep = torch.ones_like(pt, dtype=torch.bool)
        else:
            keep = ~_near_tie_taint(fork + busy, busy, po)
        tan = _rel_err(kt[keep], pt[keep])
        w = n // T5_WINDOWS
        win_k = kt[:, :T5_WINDOWS * w].reshape(ENGINE_P, T5_WINDOWS, w).mean(-1)
        win_p = pt[:, :T5_WINDOWS * w].reshape(ENGINE_P, T5_WINDOWS, w).mean(-1)
        ms = _time_ms(lambda: jvp("cuda"), n=10)
        print(f"  {str(dtype):14s}: {launches} kernel launch; primal max "
              f"rel err {primal:.2e}; tangent max rel err {tan:.2e} over "
              f"{100 * float(keep.float().mean()):.2f} % of the elements "
              f"(rtol {rtol:g}; the rest lie in busy periods with a "
              f"near-tie), window means' tangents {_rel_err(win_k, win_p):.2e}"
              f"; jvp {ms:.3f} ms [{card}]")
        if launches < 1 or not (primal <= rtol and tan <= rtol):
            raise AssertionError(f"{dtype}: the tangent through the kernel "
                                 "differs from the plain path's")
    a = (fork + busy).to(torch.float32).contiguous()
    b = busy.to(torch.float32)
    for rows in (1, ENGINE_P):
        ar, br = a[:rows].contiguous(), b[:rows].contiguous()
        ms = _time_ms(lambda: kernel.maxplus_scan_cuda(ar, br, with_b=False))
        bound = rows * n * 3 * 4 / HBM_BYTES_PER_S * 1e3
        print(f"  scan at ({rows}, {n:,}) float32, out_a only: {ms:.4f} ms "
              f"vs {bound:.5f} ms bytes bound ({100 * bound / ms:.2f} %) "
              f"[{card}]")
    n_iters = 20
    wall = _wall(lambda: calibrate(trace, n_windows=T5_WINDOWS,
                                   residual="maxplus", n_iters=n_iters))
    _reset_counts()
    calibrate(trace, n_windows=T5_WINDOWS, residual="maxplus",
              n_iters=n_iters)
    scans = _counts()["maxplus_scan"]
    traced = phase_profile(
        card, wall, lambda: calibrate(trace, n_windows=T5_WINDOWS,
                                      residual="maxplus", n_iters=n_iters),
        "phase 19d: device time by kernel, calibrate(residual='maxplus') "
        f"on the {trace.n_queries:,}-query trace")
    launches = sum(c for _, c in traced.values())
    print(f"  {scans} scan launches, {launches} kernel launches in all: "
          f"{launches / n_iters:.1f} a Gauss-Newton step ({n_iters} steps); "
          f"wall {wall:.3f} s [{card}]")
    _kernel_share(traced, "maxplus_scan_kernel", "(max,+) scan")


# -- phase 20: scenario sharding ---------------------------------------------
SHARD_WAYS = (2, 4)              # 20b: 16b's slab split 2 and 4 ways
SHARD20_QUERIES = 64 * CHUNK     # 262,144 queries a scenario (64 chunks)
SHARD20_SEED = 20
SEARCH_RTOL = 1e-6               # 20c: mesh vs stacked search scores


class _BatchPeaks:
    """Wall and peak device memory (above what was allocated before the
    call) of each `simulate_fork_join_batch` call, while in a ``with``
    block."""

    def __enter__(self):
        import torch
        from repro_torch.core import simulator
        self.calls, self._orig = [], simulator.simulate_fork_join_batch

        def measured(*args, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            res = self._orig(*args, **kw)
            torch.cuda.synchronize()
            self.calls.append((time.perf_counter() - t0,
                               torch.cuda.max_memory_allocated() - base))
            return res
        simulator.simulate_fork_join_batch = measured
        return self

    def __exit__(self, *exc):
        from repro_torch.core import simulator
        simulator.simulate_fork_join_batch = self._orig


def _same_result(a, b, what: str) -> None:
    """Every set field of two SimResults equal, bit for bit."""
    import dataclasses
    import torch
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if (x is None) != (y is None):
            raise AssertionError(f"{what}: {f.name} set on one side only")
        if x is not None and not torch.equal(x, y):
            raise AssertionError(f"{what}: {f.name} differs")


def phase_sharding(card: str, part, qterms) -> None:
    """20a-c: the analytic grid, 16b's slab and the engine over meshes."""
    import torch
    from repro_torch.core import simulator, sweep
    from repro_torch.core.arrivals import ArrivalProcess
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.queueing import ServerParams
    from repro_torch.engine import distributed
    from repro_torch.launch.mesh import make_mesh, make_sweep_mesh
    n_gpu = torch.cuda.device_count()
    print(f"== phase 20a: the 1,000,000-scenario analytic grid under "
          f"make_sweep_mesh() ({n_gpu} GPU{'s' * (n_gpu != 1)}) and an "
          "8-way mesh on cuda:0")
    grid = _global_grid("cuda")
    base = sweep.sweep_analytical(grid)
    fields = ("response_lower", "response_upper", "utilization")
    for what, mesh in (("make_sweep_mesh()", make_sweep_mesh()),
                       ("8 x cuda:0", make_sweep_mesh(
                           devices=["cuda:0"] * 8))):
        res = sweep.sweep_analytical(grid, mesh=mesh)       # warm-up
        for f in fields:
            if not torch.equal(getattr(res, f), getattr(base, f)):
                raise AssertionError(f"20a {what}: {f} is not bitwise the "
                                     "unsharded surface")
        wall = _wall(lambda: sweep.sweep_analytical(grid, mesh=mesh))
        ms = _time_ms(lambda: sweep.sweep_analytical(grid, mesh=mesh), n=20)
        print(f"  {what}, {mesh.size} shard{'s' * (mesh.size != 1)}: "
              f"bitwise the unsharded surfaces; {wall * 1e3:.2f} ms wall, "
              f"mean of 20 calls {ms:.3f} ms = "
              f"{grid.n_scenarios / ms * 1e3:.4g} scenarios/s [{card}]")
    ms = _time_ms(lambda: sweep.sweep_analytical(grid), n=20)
    print(f"  unsharded, same call: mean of 20 {ms:.3f} ms")

    n_chunks = SHARD20_QUERIES // CHUNK
    print(f"== phase 20b: 16b's slab (p = {P}, {len(SIM16_LAM) * len(SIM16_SPEEDS) ** 2}"
          f" scenarios, r = {R}, JSQ, result cache) sharded "
          f"{' and '.join(map(str, SHARD_WAYS))} ways on cuda:0, "
          f"{SHARD20_QUERIES:,} queries a scenario")
    grid = sweep.SweepGrid.build(
        lam=SIM16_LAM, p=[float(P)], cpu=SIM16_SPEEDS, disk=SIM16_SPEEDS,
        memory=1, r=[float(R)], result_cache=RESULT_CACHE, device="cuda")
    kw = dict(n_queries=SHARD20_QUERIES, chunk_size=CHUNK,
              cluster=ClusterSpec(routing="jsq"))
    sweep.sweep_simulated(grid, SHARD20_SEED, n_queries=CHUNK,
                          chunk_size=CHUNK, cluster=kw["cluster"])
    with _BatchPeaks() as one:
        sweep.sweep_simulated(grid, SHARD20_SEED, **kw)
    (wall1, peak1), = one.calls
    n_scen = grid.n_scenarios
    print(f"  unsharded: {wall1:.3f} s = {n_scen * SHARD20_QUERIES / wall1:.4g}"
          f" queries/s, peak {peak1 / 2**20:.1f} MiB above the inputs "
          f"[{card}]")
    lam_full, params_full = grid.broadcast_full()

    def slab(x):
        return x.movedim((1, 5), (0, 1))[0, 0].reshape(-1)
    lam = slab(lam_full)
    pfields = {f: slab(getattr(params_full, f))
               for f in ServerParams.__dataclass_fields__}
    cell = ClusterSpec(r=R, routing="jsq", result_cache=RESULT_CACHE)
    for ways in SHARD_WAYS:
        mesh = make_sweep_mesh(devices=["cuda:0"] * ways)
        _reset_counts()
        t0 = time.perf_counter()
        with _BatchPeaks() as pk:
            res = sweep.sweep_simulated(grid, SHARD20_SEED, mesh=mesh, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        expect = {"maxplus_scan": 0,
                  "maxplus_segment_scan": 3 * n_chunks * ways,
                  "jsq_route": n_chunks * ways, "fleet_scan": 0}
        if counts != expect:
            raise AssertionError(f"20b {ways} ways: launches {counts}, "
                                 f"expected {expect}")
        flat = res.stats.map(lambda x: x[:, 0, :, :, :, 0].reshape(
            (n_scen,) + x.shape[6:]))
        per = n_scen // ways
        seed_k = simulator._mix(SHARD20_SEED, 0)
        for d in range(ways):
            sl = slice(d * per, (d + 1) * per)
            direct = simulator.simulate_fork_join_batch(
                simulator._mix(seed_k, d),
                ArrivalProcess.stationary(lam[sl], device="cuda"),
                ServerParams(**{k: v[sl] for k, v in pfields.items()}),
                SHARD20_QUERIES, p=P, chunk_size=CHUNK, cluster=cell,
                device="cuda")
            _same_result(flat.map(lambda x: x[sl]), direct,
                         f"20b {ways} ways, shard {d}")
        if not bool(torch.isfinite(res.mean).all()):
            raise AssertionError(f"20b {ways} ways: non-finite means")
        print(f"  {ways} ways: each shard bitwise its direct batch run on "
              f"seed _mix(_mix({SHARD20_SEED}, 0), d); launches {counts}; "
              f"{wall:.3f} s = {n_scen * SHARD20_QUERIES / wall:.4g} "
              f"queries/s [{card}]")
        print(f"    shards: walls {', '.join(f'{w:.3f}' for w, _ in pk.calls)}"
              f" s; peaks {', '.join(f'{m / 2**20:.1f}' for _, m in pk.calls)}"
              f" MiB (unsharded {peak1 / 2**20:.1f} MiB, / {ways} = "
              f"{peak1 / ways / 2**20:.1f})")

    print(f"== phase 20c: phase 19a's {ENGINE_P}-shard engine under "
          f"make_search_fn(make_mesh(({n_gpu},), (\"servers\",)))")
    stacked = distributed.stack_shards(part, device="cuda")
    batch = torch.as_tensor(qterms[:ENGINE_BATCH], device="cuda")
    stack_fn = distributed.make_search_fn(None, stacked, k=ENGINE_K)
    mesh_fn = distributed.make_search_fn(
        make_mesh((n_gpu,), ("servers",)), stacked, k=ENGINE_K)
    (s1, d1), (s2, d2) = stack_fn(batch), mesh_fn(batch)
    if not torch.equal(d1.cpu(), d2.cpu()):
        raise AssertionError("20c: mesh search ids differ from the stacked "
                             "search's")
    if not torch.equal(torch.isneginf(s1).cpu(), torch.isneginf(s2).cpu()):
        raise AssertionError("20c: -inf entries differ")
    fin = torch.isfinite(s1)
    err = _rel_err(s2[fin].to(s1.device), s1[fin])
    if not err <= SEARCH_RTOL:
        raise AssertionError(f"20c: scores differ by {err} > {SEARCH_RTOL}")
    ms_stack = _time_ms(lambda: stack_fn(batch), n=10)
    ms_mesh = _time_ms(lambda: mesh_fn(batch), n=10)
    print(f"  ids equal, scores max rel err {err:.2e} (rtol {SEARCH_RTOL:g});"
          f" a batch of {ENGINE_BATCH}: stacked {ms_stack:.3f} ms, mesh "
          f"{ms_mesh:.3f} ms [{card}]")
    if n_gpu == 1:
        print("  one GPU: every shard ran on cuda:0 in turn; no "
              "cross-device overlap was measured")


# -- phase 21: MoE and Command-R serving ---------------------------------------
LM21 = ("qwen3-moe-30b-a3b", "granite-moe-3b-a800m", "command-r-plus-104b")
# device memory left free beside the weights and the cache: prefill and
# decode activations, the plain-path checks (an MoE prefill of 2,048
# tokens holds its (S*k, E) slot counts and (E, C, d) buffers)
LM21_RESERVE = 10 * 2**30


def _fit_depth(cfg) -> int:
    """The most layers of ``cfg`` whose bfloat16 weights and 8 x 4096
    cache fit the card's free memory beside LM21_RESERVE, or beside the
    float32 draw of the largest weight while `init_params` fills it, if
    that is larger."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as T
    meta = T.Transformer(dataclasses.replace(cfg, n_layers=1), device="meta")
    nbytes = [p.numel() * p.element_size() for p in meta.parameters()]
    layer = sum(p.numel() * p.element_size()
                for p in meta.layers[0].parameters())
    rest = sum(nbytes) - layer
    per = layer + _kv_bytes(dataclasses.replace(cfg, n_layers=1), SLOTS,
                            MAX_SEQ)
    reserve = max(LM21_RESERVE,
                  4 * max(p.numel() for p in meta.parameters()))
    free, _ = torch.cuda.mem_get_info()
    return min(cfg.n_layers, int((free - rest - reserve) // per))


GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")   # cuBLAS kernel names


def _moe_decode_split(card: str, cfg, model) -> None:
    """Where one MoE layer's decode time goes: `moe_ffn` at the decode
    shape (SLOTS, 1, d) traced, its cuBLAS kernels (the three expert
    products, dense over all E experts, one slot each) against the rest
    (routing, dispatch and combine), beside the products' bytes bound."""
    import torch
    from repro_torch.models import moe as moe_lib
    blk = model.layers[0].moe
    e = cfg.moe.n_experts_padded or cfg.moe.n_experts
    gen = torch.Generator(device="cuda").manual_seed(21)
    y = torch.randn(SLOTS, 1, cfg.d_model, device="cuda", generator=gen
                    ).to(torch.bfloat16)
    run = lambda: moe_lib.moe_ffn(blk, cfg.moe, y)      # noqa: E731
    run()
    traced = phase_profile(card, _wall(run), run,
                           f"phase 21b: one {cfg.name} MoE layer at decode "
                           f"({SLOTS} tokens, top-{cfg.moe.top_k} of {e})")
    busy = sum(ms for ms, _ in traced.values())
    launches = sum(n for _, n in traced.values())
    gemm = [v for k, v in traced.items()
            if any(g in k for g in GEMM_KERNELS)]
    prod = sum(ms for ms, _ in gemm)
    expert_bytes = sum(w.numel() * w.element_size()
                       for w in (blk.w_gate, blk.w_up, blk.w_down))
    bound = expert_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  one MoE layer: {busy:.4f} ms device in {launches} launches; "
          f"expert products {prod:.4f} ms in {sum(n for _, n in gemm)} "
          f"launches (bytes bound {bound:.4f} ms: every expert's "
          f"{expert_bytes / 1e6:.1f} MB read for 1 slot each), routing, "
          f"dispatch and combine {busy - prod:.4f} ms; x {cfg.n_layers} "
          f"layers = {busy * cfg.n_layers:.2f} ms a step [{card}]")


def _same_routing(blk, cfg, a, b) -> float:
    """Share of tokens whose top-k expert set is the same on the layer
    inputs ``a`` and ``b`` (the residual streams before the MoE)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_lib
    sets = [torch.sort(moe_lib._route(blk.moe, cfg.moe, L.rmsnorm(
        blk.ln_mlp, x))[2], dim=-1).values for x in (a, b)]
    return float((sets[0] == sets[1]).all(dim=-1).float().mean())


def _attention_layerwise(model, cfg, tokens, cache, length: int,
                         steps: int):
    """An MoE model's attention kernels held layer by layer on the plain
    path's inputs: from position ``length`` of ``cache`` (0: prefill
    ``tokens`` (B, S) first), each layer's attention through the kernel
    and the plain version on the same normed input, then the plain
    path's layer output goes on; ``steps`` greedy decode steps follow.
    Returns the relative L2 errors of every layer's attention output
    and the share of tokens routed to the same experts on the two."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    dims = T._dims(cfg)
    errs, agree = [], []

    def layer(i, blk, x, attend):
        xn = L.rmsnorm(blk.ln_attn, x)
        hk, hp = attend(xn, "auto"), attend(xn, "torch")
        errs.append(_rel_l2(hk, hp))
        agree.append(_same_routing(blk, cfg, x + hk, x + hp))
        return T._mlp_residual(blk, cfg, x + hp)

    if length == 0:
        s = tokens.shape[1]
        x = T._embed(model, cfg, tokens)
        for i, blk in enumerate(model.layers):
            def attend(xn, impl, blk=blk, i=i):
                h, k, v = L.attention_prefill_chunked(blk.attn, dims, xn,
                                                      chunk=s, impl=impl)
                cache["k"][i, :, :s], cache["v"][i, :, :s] = k, v
                return h
            x = layer(i, blk, x, attend)
        tokens = T._logits(model, cfg, x[:, -1:]).argmax(-1)
        length = s
    for _ in range(steps):
        x = T._embed(model, cfg, tokens)
        for i, blk in enumerate(model.layers):
            def attend(xn, impl, blk=blk, i=i):
                return L.attention_decode(blk.attn, dims, xn, cache["k"][i],
                                          cache["v"][i], length,
                                          impl=impl)[0]
            x = layer(i, blk, x, attend)
        tokens = T._logits(model, cfg, x).argmax(-1)
        length += 1
    return errs, agree


def _check_moe_layers(card: str, cfg, model, srv) -> None:
    """21.1-21.2 for an MoE model: its attention kernels layer by layer
    at full width and depth (`_attention_layerwise`), from fresh prompts
    and from the server's cache; and, for the record, the two paths run
    freely, whose logits part once a near-tie routes a token to another
    expert."""
    from repro_torch.models import transformer as T
    limit = ATTN_ROW_RTOL["torch.bfloat16"]
    prompts = _check_prompts(cfg)
    cache = T.init_kv_cache(cfg, SLOTS, CHECK_PROMPT + 3)
    runs = (("21.1", f"{SLOTS} equal {CHECK_PROMPT}-token prompts, prefill "
             "+ 3 steps", prompts, cache, 0, 3),)
    cur, length = srv.decode_inputs()
    runs += (("21.2", f"the server's next step (cache length {length})",
              cur, srv.cache, length, 1),)
    for label, what, tokens, kv, start, steps in runs:
        errs, agree = _attention_layerwise(model, cfg, tokens, kv, start,
                                           steps)
        print(f"  {label} {cfg.name} bfloat16, {what}: each of "
              f"{cfg.n_layers} layers' attention, kernel vs plain on the "
              f"plain path's input: relative L2 max {max(errs):.2e} (limit "
              f"{limit:g}); tokens routed alike {100 * min(agree):.1f}-"
              f"{100 * max(agree):.1f} % [{card}]")
        if not max(errs) <= limit:
            raise AssertionError(f"{cfg.name}: a layer's attention differs "
                                 f"by {max(errs)}")
    free = _logits_kernel_vs_plain(model, cfg, prompts)
    print(f"    free-running (recorded, not a gate): prefill + 3 steps, "
          f"kernels vs impl=\"torch\", each through its own cache: "
          f"relative L2 {', '.join(f'{e:.2e}' for e in free)}")


def phase_moe_serving(card: str) -> dict:
    """21: `LMServer` on Qwen3-MoE-30B-A3B (full width and depth),
    Granite-MoE-3B (whole) and Command-R+ (full width, depth cut to what
    fits), phase 10's slots, lengths and requests, random bfloat16
    weights; logits against the plain path, tokens/s, where a decode
    step's time goes.  Returns {arch: counts}."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import LMServer
    out = {}
    for arch in LM21:
        torch.cuda.empty_cache()
        cfg = registry.get_arch(arch).config
        depth = _fit_depth(cfg)
        cut = ""
        if depth < cfg.n_layers:
            cut = (f", DEPTH CUT {cfg.n_layers} -> {depth} layers (the "
                   f"full depth's bfloat16 weights exceed the card)")
            cfg = dataclasses.replace(cfg, n_layers=depth)
        moe = cfg.moe
        what = ("dense" if moe is None else
                f"MoE {moe.n_experts} experts (padded "
                f"{moe.n_experts_padded}) top-{moe.top_k}, d_expert "
                f"{moe.d_expert}")
        print(f"== phase 21: LMServer, {cfg.name} at full width "
              f"({cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}, "
              f"qk_norm {cfg.qk_norm}, {what}, vocab {cfg.vocab_padded})"
              f"{cut}; bfloat16, random weights (seed 0), {SLOTS} slots, "
              f"{len(PROMPTS)} requests of {MAX_NEW21} new tokens")
        t0 = time.perf_counter()
        model = T.init_params(0, cfg)
        srv = LMServer(cfg, model, slots=SLOTS, max_seq=MAX_SEQ)
        lm = _serve_requests(card, cfg, model, srv, t0, MAX_NEW21)
        traced = phase_lm_profile(card, lm, "21b")
        launches = sum(n for _, n in traced.values()) / 4
        print(f"  {launches:.0f} kernel launches a decode step (traced)")
        if moe is not None:
            _moe_decode_split(card, cfg, model)
            _check_moe_layers(card, cfg, model, srv)
        else:
            _check_cache_path(card, cfg, model, "21.1")
            _check_server_step(card, cfg, model, srv, "21.2")
        out[arch] = dict(lm["counts"], tok_s=lm["decode_tok_s"])
        del lm, srv, model, traced
        torch.cuda.empty_cache()
        _check_f32_layers(card, cfg, "21.3")
    return out


# -- phase 22: MIND retrieval -----------------------------------------------
MIND_K = 100                     # retrieval_cand's top-100
MIND_INTEREST_RTOL = 1e-2        # bfloat16 interests, card vs CPU, rel L2


def phase_mind(card: str) -> None:
    """22: MIND at FULL: a serve batch of interests, then retrieval_cand
    (one user, 1,000,000 candidates, top-100), card against CPU."""
    import torch
    from repro_torch.configs import mind
    from repro_torch.data import recsys_data
    from repro_torch.models import recsys as RS
    cfg = mind.FULL
    print(f"== phase 22: MIND at FULL ({cfg.item_vocab:,} items, D = "
          f"{cfg.embed_dim}, H = {cfg.hist_len}, K = {cfg.n_interests}, "
          f"{cfg.capsule_iters} routing iterations), {cfg.dtype}, random "
          "weights (seed 0)")
    params = RS.init_mind(0, cfg)
    cpu = {k: (v.cpu() if torch.is_tensor(v)
               else [{n: t.cpu() for n, t in lyr.items()} for lyr in v])
           for k, v in params.items()}
    hist, mask, _ = recsys_data.mind_batch(cfg, REC_P99)
    h, m = (torch.as_tensor(x, device="cuda") for x in (hist, mask))
    u = RS.mind_user_interests(params, cfg, h, m)
    err = _rel_l2(u.cpu(), RS.mind_user_interests(
        cpu, cfg, torch.as_tensor(hist), torch.as_tensor(mask)))
    if not err <= MIND_INTEREST_RTOL:
        raise AssertionError(f"22: interests card vs CPU rel L2 {err}")
    ms = _time_ms(lambda: RS.mind_user_interests(params, cfg, h, m), n=20)
    dev_ms = _device_ms(lambda: RS.mind_user_interests(params, cfg, h, m),
                        n=20)
    print(f"  interests of a serve batch (B = {REC_P99}): {ms:.3f} ms a call"
          f" ({dev_ms:.3f} ms device) = {REC_P99 / ms * 1e3:.4g} users/s; "
          f"card vs CPU rel L2 {err:.2e} (limit {MIND_INTEREST_RTOL:g}) "
          f"[{card}]")

    cand = torch.arange(cfg.item_vocab, device="cuda")
    s, i = RS.mind_retrieve(params, cfg, h[:1], m[:1], cand, k=MIND_K)
    if s.shape != (1, MIND_K) or not bool(torch.isfinite(s).all()):
        raise AssertionError(f"22: retrieval gave {tuple(s.shape)} scores, "
                             "or non-finite ones")
    ms = _time_ms(lambda: RS.mind_retrieve(params, cfg, h[:1], m[:1], cand,
                                           k=MIND_K), n=20)
    dev_ms = _device_ms(lambda: RS.mind_retrieve(params, cfg, h[:1], m[:1],
                                                 cand, k=MIND_K), n=20)
    # the ranking half on the same interests, card against CPU
    u1 = RS.mind_user_interests(params, cfg, h[:1], m[:1])
    cs, ci = (x[0].cpu() for x in RS.mind_topk(params, u1, cand, MIND_K))
    ps, pi = (x[0] for x in RS.mind_topk(cpu, u1.cpu(), cand.cpu(), MIND_K))
    kth = float(ps[-1])
    if float(cs[-1]) != kth:
        raise AssertionError(f"22: k-th score {float(cs[-1])} on the card, "
                             f"{kth} on the CPU")
    above = ps > kth
    if not (torch.equal(ci[above], pi[above])
            and torch.equal(cs[above], ps[above])):
        raise AssertionError("22: ids or scores above the k-th differ from "
                             "the CPU's")
    ties = int((ps == kth).sum())
    same_ties = int((ci[~above] == pi[~above]).sum())
    print(f"  retrieval_cand (B = 1, C = {cfg.item_vocab:,}, top-{MIND_K}): "
          f"{ms:.3f} ms a call ({dev_ms:.3f} ms device) [{card}]")
    print(f"    card vs CPU on the same interests: k-th score {kth:.6g} "
          f"equal; the {int(above.sum())} ids above it equal, scores "
          f"bitwise; {ties} of the top-{MIND_K} tie the k-th score "
          f"({same_ties} of them the same ids)")


# -- phase 23: LM training ---------------------------------------------------
# 23a: qwen3-1.7b FULL; the reference's train_4k cell (seq 4096, global
# batch 256) with the global batch cut to 8 for one card, 4 microbatches
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_TIMED = 4096, 8, 4, 3
TRAIN_LR = dict(base_lr=3e-4, warmup=2, total=100)
# one sequence's bfloat16 loss against the float32 loss of the same
# weights: bfloat16 rounds each activation at 2^-9, compounding over 28
# layers and a 153,600-way softmax to ~1e-3 of the loss; 1e-2 holds
# that and fails a wrong gradient path that has trained the weights
TRAIN_F32_RTOL = 1e-2
TRAIN_GRAD_COS = 0.99       # bfloat16 gradients vs float32, cosine
# 23c: card vs CPU in float32 at the smoke configs (the CPU tests'
# tolerances against the reference: float32 rounding in another order)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_W_RTOL = 1e-5, 1e-4, 1e-5
TRAIN_LOGITS_RTOL = 1e-4    # forward_train's logits vs prefill's (flash)
# 23d: examples/torch_train_lm.py's cpu preset
DEMO_STEPS, DEMO_BATCH, DEMO_SEQ, DEMO_EVERY = 300, 8, 128, 100


def _named(model, names):
    return [dict(model.named_parameters())[n] for n in names]


def _train_full(card: str, cfg, batch: int, micro: int, timed: int,
                label: str, n_flops: int, watch: tuple) -> dict:
    """``cfg`` at full width in bfloat16 (random weights, seed 0),
    `TrainStep(AdamW(cosine), microbatches=micro)` on `LMBatchPipeline`
    batches of TRAIN_SEQ tokens: one warm-up step, ``timed`` timed steps,
    then one step under the profiler.  Prints step wall, tokens/s, the
    peak memory, MFU (6 x ``n_flops`` parameters x tokens at 989
    TFLOP/s) and where the step's device time goes; fails if a loss is
    not finite, a ``watch``ed weight did not change, or a port kernel
    launched (training runs the reference's plain attention)."""
    import torch
    from repro_torch.data.pipeline import LMBatchPipeline
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    from repro_torch.train.trainer import TrainStep
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = T.init_params(0, cfg)

    def loss_fn(params, b):
        return T.train_step_loss(params, cfg, b["tokens"], b["labels"])
    step = TrainStep(loss_fn, AdamW(lr=cosine_schedule(**TRAIN_LR)),
                     microbatches=micro)
    state = step.init_state(model)
    pipe = LMBatchPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                           global_batch=batch, seed=23)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                zip(("tokens", "labels"), pipe.batch(s))}
               for s in range(timed + 2)]
    before = [w.detach().clone() for w in _named(model, watch)]
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {n_params / 1e9:.3f} B parameters ({cfg.n_params / 1e9:.3f} B "
          f"by the config's count), weights and AdamW state allocated in "
          f"{time.perf_counter() - t0:.1f} s")

    losses = []

    def one(b):
        nonlocal model, state
        model, state, loss = step(model, state, b)
        losses.append(loss)
    warm = _wall(lambda: one(batches[0]))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    walls = [_wall(lambda b=b: one(b)) for b in batches[1:timed + 1]]
    peak = torch.cuda.max_memory_allocated()
    counts = dict(_counts(), **_attention_counts())
    if any(counts.values()):
        raise AssertionError(f"{label}: training launched port kernels "
                             f"{counts}")
    wall = sorted(walls)[len(walls) // 2]
    tokens = batch * TRAIN_SEQ
    flops = 6 * n_flops * tokens
    print(f"  step wall {', '.join(f'{w:.3f}' for w in walls)} s (warm-up "
          f"{warm:.3f} s), median {wall:.3f} s: {tokens / wall:,.0f} "
          f"tokens/s, MFU {100 * flops / (wall * BF16_OPS_PER_S):.1f} % "
          f"(6 x {n_flops / 1e9:.3f} B x {tokens:,} tokens at 989 TFLOP/s); "
          f"peak memory {peak / 1e9:.2f} GB [{card}]")
    t1 = time.perf_counter()
    traced = phase_profile(card, wall, lambda: one(batches[timed + 1]),
                           f"phase {label}: device time by kernel, one "
                           f"training step ({batch} x {TRAIN_SEQ} tokens, "
                           f"{micro} microbatches)", trace_host=False)
    t1 = time.perf_counter() - t1
    busy = sum(ms for ms, _ in traced.values())
    gemm = sum(ms for k, (ms, _) in traced.items()
               if any(g in k for g in GEMM_KERNELS))
    soft = sum(ms for k, (ms, _) in traced.items() if "softmax" in k.lower())
    rows = batch // micro
    loss_ms = _lm_loss_ms(model, cfg, rows) * micro
    fwd, fwd_bwd = _attention_ms(model, cfg, rows, cfg.attn_chunk)
    attn_ms = (fwd + fwd_bwd) * cfg.n_layers * micro
    blk_fwd, blk_fwd_bwd = _attention_ms(model, cfg, rows, TRAIN_SEQ // 2)
    print(f"  shares of {busy:.1f} ms busy (profiled step, {t1:.1f} s with "
          f"the trace): products (cuBLAS) {100 * gemm / busy:.1f} %, softmax"
          f" kernels (forward, recompute, backward) {100 * soft / busy:.1f}"
          f" %; timed alone on the step's shapes: attention "
          f"{100 * attn_ms / busy:.1f} % ({attn_ms:.1f} ms: layer 0's "
          f"`attention_train` forward {fwd:.2f} + forward and backward "
          f"{fwd_bwd:.2f} ms, x {cfg.n_layers} layers x {micro}), LM head "
          f"and loss {100 * loss_ms / busy:.1f} % ({loss_ms:.1f} ms: "
          f"`chunked_lm_loss` forward + backward x {micro}) [{card}]")
    print(f"  the blockwise path at chunk {TRAIN_SEQ // 2} (the reference's "
          f"train_4k cell's attn_chunk), same layer: forward {blk_fwd:.2f}, "
          f"forward and backward {blk_fwd_bwd:.2f} ms (full softmax "
          f"{fwd:.2f}, {fwd_bwd:.2f}) [{card}]")
    vals = torch.stack(losses).float().cpu()
    if not bool(torch.isfinite(vals).all()):
        raise AssertionError(f"{label}: losses {vals.tolist()}")
    moved = [float((w.detach().float() - b.float()).abs().max())
             for w, b in zip(_named(model, watch), before)]
    if not all(m > 0 for m in moved):
        raise AssertionError(f"{label}: weights {watch} moved by {moved}")
    print(f"  losses {', '.join(f'{x:.4f}' for x in vals.tolist())}; "
          f"largest change of {', '.join(watch)}: "
          f"{', '.join(f'{m:.3g}' for m in moved)}")
    return {"model": model, "state": state, "batches": batches,
            "wall": wall, "peak": peak}


def _lm_loss_ms(model, cfg, rows: int) -> float:
    """Device ms of `chunked_lm_loss` forward + backward (head and
    hidden state) on one microbatch's random hidden state."""
    import torch
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn(rows, TRAIN_SEQ, cfg.d_model, device="cuda",
                    generator=gen).to(torch.bfloat16).requires_grad_(True)
    labels = torch.randint(0, cfg.vocab_size, (rows, TRAIN_SEQ),
                           device="cuda", generator=gen)
    head = T._head(model)

    def run():
        torch.autograd.grad(T.chunked_lm_loss(model, cfg, x, labels),
                            [x, head])
    return _device_ms(run, n=3, warm=1)


def _attention_ms(model, cfg, rows: int, chunk: int
                  ) -> tuple[float, float]:
    """Device ms of layer 0's `attention_train` (``chunk``) on one
    microbatch's shape: forward alone (the rematerialised recompute), and
    forward + backward (inputs and weights)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    attn = model.layers[0].attn
    gen = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randn(rows, TRAIN_SEQ, cfg.d_model, device="cuda",
                    generator=gen).to(torch.bfloat16).requires_grad_(True)
    dy = torch.randn_like(x)
    dims = T._dims(cfg)

    def fwd():
        with torch.no_grad():
            L.attention_train(attn, dims, x, chunk=chunk)

    def fwd_bwd():
        out = L.attention_train(attn, dims, x, chunk=chunk)
        torch.autograd.grad(out, [x, *attn.parameters()], dy)
    return _device_ms(fwd, n=3, warm=1), _device_ms(fwd_bwd, n=3, warm=1)


def _cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def _check_against_f32(card: str, cfg, model, tokens, labels) -> None:
    """23a's gate after the timed steps: one sequence's loss and the
    gradients of the embedding, layer 0's wq and the last layer's w_down,
    bfloat16 against a float32 copy of the same weights."""
    import torch
    from repro_torch.models import transformer as T
    names = ("embed", "layers.0.attn.wq.weight",
             f"layers.{cfg.n_layers - 1}.mlp.w_down.weight")
    loss16 = T.train_step_loss(model, cfg, tokens, labels)
    g16 = torch.autograd.grad(loss16, _named(model, names))
    m32 = T.Transformer(cfg, dtype=torch.float32)
    m32.load_state_dict(model.state_dict())
    for p in _named(m32, names):
        p.requires_grad_(True)
    loss32 = T.train_step_loss(m32, cfg, tokens, labels)
    g32 = torch.autograd.grad(loss32, _named(m32, names))
    loss16, loss32 = float(loss16.detach()), float(loss32.detach())
    err = abs(loss16 - loss32) / abs(loss32)
    cos = [_cos(a, b) for a, b in zip(g16, g32)]
    print(f"  one sequence: bfloat16 loss {loss16:.5f}, float32 "
          f"{loss32:.5f}, relative {err:.2e} (limit "
          f"{TRAIN_F32_RTOL:g}); gradient cosines {', '.join(names)}: "
          f"{', '.join(f'{c:.5f}' for c in cos)} (limit "
          f">= {TRAIN_GRAD_COS}) [{card}]")
    if not err <= TRAIN_F32_RTOL or not min(cos) >= TRAIN_GRAD_COS:
        raise AssertionError(f"23a: bfloat16 vs float32 loss {err}, "
                             f"gradient cosines {cos}")


def _aux_in_loss(card: str, cfg, model, b) -> None:
    """23b: the MoE aux loss enters the training loss with weight 0.01."""
    import torch
    from repro_torch.models import transformer as T
    with torch.no_grad():
        x, aux = T.forward_hidden(model, cfg, b["tokens"])
        ce = T.chunked_lm_loss(model, cfg, x, b["labels"])
        total = T.train_step_loss(model, cfg, b["tokens"], b["labels"])
    err = abs(float(total) - float(ce + 0.01 * aux))
    print(f"  aux loss {float(aux):.4f} (mean over {cfg.n_layers} layers), "
          f"cross-entropy {float(ce):.4f}, loss {float(total):.4f} = CE + "
          f"0.01 aux to {err:.1e} [{card}]")
    if not (math.isfinite(float(aux)) and float(aux) > 0 and err < 1e-3):
        raise AssertionError(f"23b: aux {float(aux)}, loss {float(total)} "
                             f"vs CE {float(ce)}")


def _smoke_pair(cfg):
    """The same float32 weights (seed 0) on the card and on the CPU."""
    from repro_torch.models import transformer as T
    cpu = T.init_params(0, cfg, device="cpu")
    card = T.Transformer(cfg)
    card.load_state_dict(cpu.state_dict())
    return card, cpu


def _grads(model, cfg, tokens, labels):
    import torch
    from repro_torch.models import transformer as T
    model.requires_grad_(True)
    loss = T.train_step_loss(model, cfg, tokens, labels)
    names, params = zip(*model.named_parameters())
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))


def _rel(x, y) -> float:
    x, y = x.detach().double().cpu(), y.detach().double().cpu()
    return float((x - y).norm() / y.norm().clamp_min(1e-300))


def phase_train_card_vs_cpu(card: str) -> None:
    """23c: at the smoke configs in float32, the card against the CPU:
    `train_step_loss` and its gradient, one `TrainStep` (AdamW, 2
    microbatches), and `forward_train`'s last logits against `prefill`'s
    (the flash kernel)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import granite_moe_3b_a800m, qwen3_1_7b
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    from repro_torch.train.trainer import TrainStep
    print("== phase 23c: training at the smoke configs in float32, card "
          "vs CPU")
    rng = np.random.default_rng(23)
    for base in (qwen3_1_7b.SMOKE, granite_moe_3b_a800m.SMOKE):
        for chunk in (0, 8):
            cfg = dataclasses.replace(base, attn_chunk=chunk)
            tokens = rng.integers(0, cfg.vocab_size, (4, 16))
            labels = np.roll(tokens, -1, axis=1)
            labels[:, -1] = -1
            t_cpu, l_cpu = torch.from_numpy(tokens), torch.from_numpy(labels)
            t_gpu, l_gpu = t_cpu.cuda(), l_cpu.cuda()
            gpu, cpu = _smoke_pair(cfg)
            lg, gg = _grads(gpu, cfg, t_gpu, l_gpu)
            lc, gc = _grads(cpu, cfg, t_cpu, l_cpu)
            loss_err = _rel(lg, lc)
            grad_err = max(_rel(gg[k], gc[k]) for k in gc)

            def loss_fn(p, b, cfg=cfg):
                return T.train_step_loss(p, cfg, b["tokens"], b["labels"])
            step = TrainStep(loss_fn, AdamW(lr=cosine_schedule(1e-2, 2, 10)),
                             microbatches=2)
            for model, t, lab in ((gpu, t_gpu, l_gpu), (cpu, t_cpu, l_cpu)):
                step(model, step.init_state(model),
                     {"tokens": t, "labels": lab})
            wg, wc = dict(gpu.named_parameters()), dict(cpu.named_parameters())
            # Adam's first step is g / (|g| + eps): where 0 < |g| is within
            # the gradients' tolerance of 0, their agreement does not fix
            # the step's sign, so those elements are left out (and counted)
            held = {k: (gc[k] == 0)
                    | (gc[k].abs() > TRAIN_GRAD_RTOL * gc[k].abs().max())
                    for k in gc}
            w_err = max(_rel(wg[k].cpu()[held[k]], wc[k][held[k]])
                        for k in wc)
            n_out = sum(int((~h).sum()) for h in held.values())
            n_all = sum(h.numel() for h in held.values())

            fa_ops.reset_counts()
            with torch.no_grad():
                train_logits, _ = T.forward_train(gpu, cfg, t_gpu)
                pre, _ = T.prefill(gpu, cfg, t_gpu, chunk=16)
            flash = fa_ops.launch_count()
            logit_err = _rel(train_logits[:, -1], pre[:, 0])
            print(f"  {cfg.name} attn_chunk {chunk}: loss {_rel(lg, lc):.1e} "
                  f"(limit {TRAIN_LOSS_RTOL:g}), gradients <= {grad_err:.1e} "
                  f"({TRAIN_GRAD_RTOL:g}), weights after a TrainStep <= "
                  f"{w_err:.1e} ({TRAIN_W_RTOL:g}; {n_out} of {n_all} "
                  f"elements with 0 < |g| <= {TRAIN_GRAD_RTOL:g} x their "
                  f"tensor's largest left out), forward_train vs prefill "
                  f"({flash} flash launches) "
                  f"{logit_err:.1e} ({TRAIN_LOGITS_RTOL:g}), relative L2 "
                  f"[{card}]")
            if not (loss_err <= TRAIN_LOSS_RTOL
                    and grad_err <= TRAIN_GRAD_RTOL
                    and w_err <= TRAIN_W_RTOL
                    and logit_err <= TRAIN_LOGITS_RTOL
                    and flash == cfg.n_layers):
                raise AssertionError(f"23c: {cfg.name} attn_chunk {chunk}")


def _load_example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_train_restart(card: str) -> None:
    """23d: examples/torch_train_lm.py's cpu preset (demo-12m) on the
    card: DEMO_STEPS steps, the loss below 0.75 x the first; checkpoints
    every DEMO_EVERY steps restored bit for bit into a fresh model and
    state, and one step from the restored state against one from
    memory."""
    import torch
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import LMBatchPipeline
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    from repro_torch.train.trainer import TrainStep
    cfg = _load_example("torch_train_lm").PRESETS["cpu"]
    print(f"== phase 23d: {cfg.name} ({cfg.n_params / 1e6:.1f} M "
          f"parameters, {cfg.dtype}), {DEMO_STEPS} steps at batch "
          f"{DEMO_BATCH} x {DEMO_SEQ}, checkpoints every {DEMO_EVERY}")
    pipe = LMBatchPipeline(vocab_size=cfg.vocab_size, seq_len=DEMO_SEQ,
                           global_batch=DEMO_BATCH, coherence=0.7)

    def loss_fn(params, b):
        return T.train_step_loss(params, cfg, b["tokens"], b["labels"])
    step = TrainStep(loss_fn, AdamW(
        lr=cosine_schedule(3e-3, warmup=20, total=DEMO_STEPS)))

    def batch(s):
        return {k: torch.from_numpy(v).cuda()
                for k, v in zip(("tokens", "labels"), pipe.batch(s))}
    model = T.init_params(0, cfg)
    state = step.init_state(model)
    losses = []
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, every=DEMO_EVERY, keep_last=2)
        t0 = time.perf_counter()
        for s in range(1, DEMO_STEPS + 1):
            model, state, loss = step(model, state, batch(s))
            losses.append(loss)
            mgr.maybe_save(s, {"params": model, "state": state})
        mgr.wait()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        first, last = float(losses[0]), float(losses[-1])
        fresh = T.init_params(1, cfg)
        fresh_state = step.init_state(fresh)
        at, out = mgr.restore_latest({"params": fresh, "state": fresh_state})
        saved = sorted(os.listdir(d))
    print(f"  {DEMO_STEPS} steps in {wall:.2f} s "
          f"({wall / DEMO_STEPS * 1e3:.1f} ms a step, checkpoints "
          f"included): loss {first:.4f} -> "
          f"{last:.4f} ({last / first:.3f} x; limit 0.75) [{card}]")
    if not last < 0.75 * first:
        raise AssertionError(f"23d: loss {first} -> {last}")
    fresh_state = out["state"]
    same = (at == DEMO_STEPS
            and all(torch.equal(a, b) for a, b in zip(
                model.state_dict().values(), fresh.state_dict().values()))
            and int(fresh_state["opt"].step) == int(state["opt"].step)
            and all(torch.equal(fresh_state["opt"].m[k], state["opt"].m[k])
                    and torch.equal(fresh_state["opt"].v[k],
                                    state["opt"].v[k])
                    for k in state["opt"].m))
    b = batch(DEMO_STEPS + 1)
    step(model, state, b)
    step(fresh, fresh_state, b)
    err = max(_rel(p, q) for p, q in zip(model.parameters(),
                                         fresh.parameters()))
    print(f"  kept {saved}; restored step {at}: weights and AdamW state "
          f"{'bitwise equal' if same else 'DIFFERENT'}; one step from the "
          f"restored state vs from memory: relative L2 <= {err:.1e} (limit "
          f"1e-6) [{card}]")
    if not same or not err <= 1e-6:
        raise AssertionError(f"23d: restore exact {same}, next step {err}")


def phase_training(card: str) -> None:
    """23: LM training on the card (23a-23d)."""
    import torch
    from repro_torch.configs import granite_moe_3b_a800m, qwen3_1_7b
    cfg = qwen3_1_7b.FULL
    print(f"== phase 23a: training {cfg.name} at full width and depth "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_padded}, untied head), {cfg.dtype}, random weights "
          f"(seed 0); seq {TRAIN_SEQ}, global batch {TRAIN_BATCH} (the "
          f"reference's train_4k has 256: CUT for one card), "
          f"{TRAIN_MICRO} microbatches, attn_chunk {cfg.attn_chunk}")
    t0 = time.perf_counter()
    run = _train_full(card, cfg, TRAIN_BATCH, TRAIN_MICRO, TRAIN_TIMED,
                      "23a", cfg.n_params,
                      ("embed", "layers.0.attn.wq.weight"))
    del run["state"]
    torch.cuda.empty_cache()
    b = run["batches"][0]
    t1 = time.perf_counter()
    _check_against_f32(card, cfg, run["model"], b["tokens"][:1],
                       b["labels"][:1])
    print(f"  (the float32 check: {time.perf_counter() - t1:.1f} s)")
    del run
    torch.cuda.empty_cache()
    print(f"  (phase 23a: {time.perf_counter() - t0:.1f} s)")

    cfg = granite_moe_3b_a800m.FULL
    moe = cfg.moe
    print(f"== phase 23b: training {cfg.name} at full width and depth "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{moe.n_experts} experts padded to {moe.n_experts_padded}, "
          f"top-{moe.top_k}), {cfg.dtype}, random weights (seed 0); seq "
          f"{TRAIN_SEQ}, batch 1, 2 steps; MFU over the "
          f"{cfg.n_active_params / 1e9:.3f} B active parameters")
    t0 = time.perf_counter()
    run = _train_full(card, cfg, 1, 1, 1, "23b", cfg.n_active_params,
                      ("layers.0.moe.w_gate", "layers.0.moe.router"))
    _aux_in_loss(card, cfg, run["model"], run["batches"][0])
    del run
    torch.cuda.empty_cache()
    print(f"  (phase 23b: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_train_card_vs_cpu(card)
    print(f"  (phase 23c: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_train_restart(card)
    print(f"  (phase 23d: {time.perf_counter() - t0:.1f} s)")


# -- phase 24: recommender training ------------------------------------------
# the reference's train_batch cell (`repro.launch.specs`): B = 65,536,
# AdamW(lr=1e-4), MIND with 1,024 shared negatives
REC_TRAIN_B, REC_TRAIN_MICRO, REC_TRAIN_TIMED = 65_536, 1, 3
REC_TRAIN_LR = 1e-4
REC_CHECK_B = 4096          # 24b: the plain path's float32 CIN at 1.3 GB a layer
# 24b: gradients through the Functions vs autograd of the plain path, of
# each tensor's largest entry: bfloat16 rounds each product and sum at
# 2^-9 (1e-2), float32 sums in another order (1e-4)
REC_GRAD_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-4}
# 24d / 25c: card vs CPU in float32 (the CPU tests' tolerances against
# the reference), with tests/test_torch_recsys_train.py's floor of 1e-6 of
# the model's largest gradient (MIND's last bias cancels to ~4e-5 of its
# terms)
REC_LOSS_RTOL, REC_GRAD_RTOL, REC_NOISE_FLOOR = 1e-5, 1e-4, 1e-6
# 24e: one repeated batch memorised; the teacher's labels are near coin
# flips, so 30 steps at 1e-3 move 256 samples' loss 0.94 x, 32 samples'
# 0.86 x (the CPU, float32)
REC_SMOKE_STEPS, REC_SMOKE_LR, REC_SMOKE_DROP = 30, 1e-3, 0.9
REC_SMOKE_B = 32


def _rec_batch(cfg, b: int, step: int, device="cuda") -> dict:
    """A `ctr_batch` (CTR) or `mind_batch` (MIND) train batch on
    ``device``: ids int32, masks bool, labels float32."""
    import numpy as np
    import torch
    from repro_torch.data import recsys_data
    if cfg.interaction == "multi-interest":
        hist, mask, target = recsys_data.mind_batch(cfg, b, step=step,
                                                    seed=24)
        out = {"hist": hist, "mask": mask, "target": target}
    else:
        ids, mask, labels = recsys_data.ctr_batch(cfg, b, step=step,
                                                  seed=24)
        out = {"ids": ids.astype(np.int32), "mask": mask, "labels": labels}
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _rec_init(cfg, seed: int, device="cuda") -> dict:
    from repro_torch.models import recsys as RS
    init = {"fm": RS.init_deepfm, "cin": RS.init_xdeepfm,
            "self-attn": RS.init_autoint,
            "multi-interest": RS.init_mind}[cfg.interaction]
    return init(seed, cfg, device=device)


def _rec_loss(cfg, impl: str = "auto"):
    from repro_torch.models import recsys as RS
    if cfg.interaction == "multi-interest":
        return RS.mind_train_loss(cfg)
    return RS.ctr_train_loss(cfg, impl=impl)


def _tree_map(fn, tree):
    """``fn`` over every tensor of a tree of dicts, lists and NamedTuples
    (a recommender's or DimeNet's parameters, a TrainStep state)."""
    import torch
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return tree


def _clone_tree(tree):
    return _tree_map(lambda t: t.detach().clone(), tree)


def _tree_equal(a, b) -> bool:
    """Every tensor of two trees equal, bit for bit."""
    import torch
    from repro_torch.train.optimizer import named_tensors
    na, nb = named_tensors(a), named_tensors(b)
    return na.keys() == nb.keys() and all(
        na[k].dtype == nb[k].dtype and torch.equal(na[k], nb[k])
        for k in na)


def _rec_train(card: str, cfg, label: str, timed: int) -> dict:
    """``cfg`` at full width (random weights, seed 0), `TrainStep(AdamW(
    REC_TRAIN_LR))` on REC_TRAIN_B-sample train batches: a warm-up step,
    then ``timed`` timed steps.  Prints step wall, samples/s, model FLOP/s
    (`repro_torch.launch.specs.recsys_model_flops`) and peak memory; fails if a loss is not
    finite or a plain version ran on the card."""
    import torch
    from repro_torch.launch.specs import recsys_model_flops
    from repro_torch.models import recsys as RS
    from repro_torch.train.optimizer import AdamW, named_tensors
    from repro_torch.train.trainer import TrainStep
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = _rec_init(cfg, 0)
    loss_fn = _rec_loss(cfg)
    step = TrainStep(loss_fn, AdamW(lr=REC_TRAIN_LR),
                     microbatches=REC_TRAIN_MICRO)
    state = step.init_state(params)
    batches = [_rec_batch(cfg, REC_TRAIN_B, s) for s in range(timed + 1)]
    if cfg.interaction == "multi-interest":
        gen = torch.Generator(device="cuda").manual_seed(24)
        for b in batches:
            b["negs"] = RS.mind_negatives(gen, cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in named_tensors(params).values())
    print(f"  {n_params / 1e6:.1f} M parameters in "
          f"{len(named_tensors(params))} tensors; weights, AdamW state "
          f"and {timed + 1} batches made in {time.perf_counter() - t0:.1f} s"
          f" (set-up); {REC_TRAIN_MICRO} microbatch(es) of "
          f"{REC_TRAIN_B // REC_TRAIN_MICRO} a step")
    losses = []

    def one(b):
        nonlocal params, state
        params, state, loss = step(params, state, b)
        losses.append(loss)
    warm = _wall(lambda: one(batches[0]))
    torch.cuda.reset_peak_memory_stats()
    _reset_recsys_counts()
    walls = [_wall(lambda b=b: one(b)) for b in batches[1:]]
    counts = _recsys_counts()
    peak = torch.cuda.max_memory_allocated()
    wall = sorted(walls)[len(walls) // 2]
    flops = recsys_model_flops(cfg, REC_TRAIN_B, True)
    vals = torch.stack(losses).float().cpu()
    print(f"  step wall {', '.join(f'{w * 1e3:.2f}' for w in walls)} ms "
          f"(warm-up {warm * 1e3:.1f} ms), median {wall * 1e3:.2f} ms: "
          f"{REC_TRAIN_B / wall:,.0f} samples/s, model FLOP/s "
          f"{flops / wall / 1e12:.2f} T ({flops:.3e} FLOP a step by "
          f"recsys_model_flops; {100 * flops / wall / BF16_OPS_PER_S:.2f} % "
          f"of 989 TFLOP/s); peak memory {peak / 1e9:.2f} GB; launches "
          f"{counts} in {timed} steps; losses "
          f"{', '.join(f'{x:.5f}' for x in vals.tolist())} [{card}]")
    if not bool(torch.isfinite(vals).all()) or counts["plain"]:
        raise AssertionError(f"{label}: losses {vals.tolist()}, launches "
                             f"{counts}")
    return {"params": params, "state": state, "step": step,
            "batches": batches, "wall": wall, "counts": counts,
            "one": one}


def _rec_grads(params, cfg, batch, impl: str):
    import torch
    from repro_torch.train.optimizer import named_tensors
    named = named_tensors(params)
    loss = _rec_loss(cfg, impl)(params, batch)
    return loss.detach(), dict(zip(named, torch.autograd.grad(
        loss, list(named.values()))))


def _grad_errs(got: dict, want: dict, floor_frac: float = 0.0) -> dict:
    """name -> max |got - want| / (the tensor's largest |want|, floored
    at ``floor_frac`` of the model's largest): held to a tolerance tol,
    that is an atol of tol x the tensor's largest or tol x floor_frac x
    the model's, the larger."""
    top = max(float(g.abs().max()) for g in want.values())
    return {k: float((got[k].double().cpu() - w.double().cpu()).abs().max())
            / max(float(w.abs().max()), floor_frac * top, 1e-300)
            for k, w in want.items()}


def _rec_breakdown(card: str, cfg, run: dict) -> None:
    """24a: where a step's device time goes.  A device-only trace of one
    step gives the busy time (the idle share against the median wall);
    the forward kernels, the plain backward of the bag and of each CIN
    layer and the dense AdamW update are timed alone on the step's
    shapes (a trace can drop a run's first kernels: the launch counters,
    not the trace, show the kernels ran)."""
    import torch
    from repro_torch.kernels.cin_fuse import kernel as cin_kernel
    from repro_torch.kernels.cin_fuse.autograd import cin_grads
    from repro_torch.kernels.embedding_bag import kernel as bag_kernel
    from repro_torch.kernels.embedding_bag.autograd import bag_table_grad
    from repro_torch.train.optimizer import named_tensors
    params, b = run["params"], run["batches"][1]
    traced = phase_profile(card, run["wall"], lambda: run["one"](b),
                           "phase 24a: device time by kernel, one xDeepFM "
                           f"training step (B = {REC_TRAIN_B})",
                           trace_host=False)
    busy = sum(ms for ms, _ in traced.values())
    gen = torch.Generator(device="cuda").manual_seed(241)
    table = params["embedding"]["table"]
    tables = (table, params["embedding"]["wide"])
    dt, rows = table.dtype, table.shape[0]
    bag_fwd = sum(_device_ms(lambda t=t: bag_kernel.embedding_bag_cuda(
        t.detach(), b["ids"], b["mask"]), n=3, warm=1) for t in tables)
    g10 = torch.randn((REC_TRAIN_B, cfg.n_sparse, cfg.embed_dim),
                      generator=gen, device="cuda").to(dt)
    bag_ms = sum(_device_ms(lambda g=g: bag_table_grad(
        g, b["ids"], b["mask"], rows), n=3, warm=1)
        for g in (g10, g10[..., :1].contiguous()))
    del g10
    m, d = cfg.n_sparse, cfg.embed_dim
    cin_fwd = cin_ms = 0.0
    for hk, o in zip((m,) + cfg.cin_layers[:-1], cfg.cin_layers):
        xk, x0, w = _cin_inputs(REC_TRAIN_B, hk, m, d, o, dt, gen)
        g = torch.randn((REC_TRAIN_B, o, d), generator=gen,
                        device="cuda").to(dt)
        cin_fwd += _device_ms(lambda: cin_kernel.cin_layer_cuda(xk, x0, w),
                              n=3, warm=1)
        cin_ms += _device_ms(lambda: cin_grads(g, xk, x0, w), n=3, warm=1)
        del xk, x0, w, g
    named = named_tensors(params)
    opt_params = _clone_tree(named)
    opt_state = _clone_tree(run["state"]["opt"])
    grads = {k: torch.zeros_like(p) for k, p in named.items()}
    opt = run["step"].optimizer
    adam_ms = _device_ms(lambda: opt.update(grads, opt_state, opt_params),
                         n=3, warm=1)
    n_tab = sum(t.numel() for t in tables)

    def share(ms):
        return f"{ms:.2f} ms ({100 * ms / busy:.1f} %)"
    print(f"  of {busy:.2f} ms busy, timed alone on the step's shapes "
          f"[{card}]: forward kernels, bag {share(bag_fwd)} and CIN "
          f"{share(cin_fwd)}; the plain bag backward (table and wide) "
          f"{share(bag_ms)}; the plain CIN backward (three layers) "
          f"{share(cin_ms)}; the dense AdamW over all {len(named)} tensors "
          f"({n_tab / 1e6:.1f} M of the "
          f"{sum(p.numel() for p in named.values()) / 1e6:.1f} M entries in "
          f"the tables) {share(adam_ms)}")
    del opt_params, opt_state, grads


def _rec_check_grads(card: str, cfg, params) -> None:
    """24b: on one REC_CHECK_B microbatch at full width, the gradient of
    every tensor through the Functions (the kernels' forward, the plain
    backward) against autograd of the plain path; in bfloat16 and on a
    float32 copy of the same weights."""
    import torch
    from repro_torch.train.optimizer import named_tensors
    b = _rec_batch(cfg, REC_CHECK_B, 99)
    for dtype in (torch.bfloat16, torch.float32):
        p = params if dtype == torch.bfloat16 else _as_dtype(params, dtype)
        if dtype == torch.float32:
            for t in named_tensors(p).values():
                t.requires_grad_(True)
        _reset_recsys_counts()
        lk, gk = _rec_grads(p, cfg, b, "auto")
        counts = _recsys_counts()
        lp, gp = _rec_grads(p, cfg, b, "torch")
        errs = _grad_errs(gk, gp)
        tol = REC_GRAD_TOL[str(dtype)]
        worst = max(errs, key=errs.get)
        loss_err = abs(float(lk) - float(lp)) / abs(float(lp))
        print(f"  24b {dtype}, B = {REC_CHECK_B}: gradients through the "
              f"Functions vs autograd of the plain path, of each tensor's "
              f"largest: <= {errs[worst]:.2e} ({worst}; limit {tol:g}); "
              f"table {errs['embedding/table']:.2e}, cin/0 "
              f"{errs['cin/0']:.2e}; loss {loss_err:.1e}; kernel launches "
              f"{counts} [{card}]")
        if not (errs[worst] <= tol and loss_err <= tol
                and counts["embedding_bag"] == 2
                and counts["cin_layer"] == len(cfg.cin_layers)
                and counts["plain"] == 0):
            raise AssertionError(f"24b {dtype}: gradient errors {errs}, "
                                 f"loss {loss_err}, launches {counts}")
        del gk, gp


def _as_dtype(params, dtype):
    """A copy of a model's parameter dict in ``dtype``."""
    return _tree_map(lambda t: t.detach().to(dtype).clone(), params)


def _repeats_bitwise(step, params, state, batch) -> bool:
    """One `TrainStep` from copies of (params, state), twice: weights,
    AdamW moments and loss equal bit for bit."""
    import torch
    from repro_torch.train.optimizer import named_tensors
    outs = []
    for _ in range(2):
        p, s = _clone_tree(params), _clone_tree(state)
        for t in named_tensors(p).values():
            t.requires_grad_(True)
        p, s, loss = step(p, s, batch)
        outs.append((p, s["opt"], loss))
    (p0, s0, l0), (p1, s1, l1) = outs
    return (_tree_equal(p0, p1) and _tree_equal(s0.m, s1.m)
            and _tree_equal(s0.v, s1.v) and torch.equal(l0, l1))


def _rec_repeat_and_serve(card: str, cfg, run: dict) -> None:
    """24b: the step repeated from a saved state gives the same bits;
    serve_p99's launches a call are phase 15's."""
    import torch
    from repro_torch.models import recsys as RS
    b = run["batches"][1]
    same = _repeats_bitwise(run["step"], run["params"], run["state"], b)
    ids, mask = b["ids"][:REC_P99], b["mask"][:REC_P99]
    _reset_recsys_counts()
    with torch.no_grad():
        RS.xdeepfm_logits(run["params"], cfg, ids, mask)
    served = _recsys_counts()
    expect = {"embedding_bag": 2, "cin_layer": len(cfg.cin_layers),
              "plain": 0}
    print(f"  24b: the step from a saved state twice: weights, AdamW "
          f"moments and loss {'bitwise equal' if same else 'DIFFERENT'}; a "
          f"serve_p99 call after training launches {served} (phase 15: "
          f"{expect}) [{card}]")
    if not same or served != expect:
        raise AssertionError(f"24b: repeat bitwise {same}, serve launches "
                             f"{served}")


def _rec_card_vs_cpu(card: str) -> None:
    """24d: the four recommenders at their SMOKE configs in float32, card
    against CPU on the same weights and batch: loss and every gradient
    (MIND with shared negatives and in-batch)."""
    from repro_torch.configs import autoint, deepfm, mind, xdeepfm
    from repro_torch.models import recsys as RS
    from repro_torch.train.optimizer import named_tensors
    for mod, negs in ((deepfm, False), (xdeepfm, False), (autoint, False),
                      (mind, False), (mind, True)):
        cfg = mod.SMOKE
        cpu = _rec_init(cfg, 7, device="cpu")
        gpu = _to_device(cpu, "cuda")
        for p in (cpu, gpu):
            for t in named_tensors(p).values():
                t.requires_grad_(True)
        bc = _rec_batch(cfg, 64, 5, device="cpu")
        if negs:
            bc["negs"] = RS.mind_negatives(5, cfg, 48, device="cpu")
        bg = {k: v.cuda() for k, v in bc.items()}
        lg, gg = _rec_grads(gpu, cfg, bg, "auto")
        lc, gc = _rec_grads(cpu, cfg, bc, "auto")
        loss_err = abs(float(lg) - float(lc)) / abs(float(lc))
        errs = _grad_errs(gg, gc, REC_NOISE_FLOOR / REC_GRAD_RTOL)
        worst = max(errs, key=errs.get)
        name = cfg.name + (" (shared negatives)" if negs else "")
        print(f"  24d {name}: loss {loss_err:.1e} (limit "
              f"{REC_LOSS_RTOL:g}), gradients <= {errs[worst]:.1e} ({worst};"
              f" limit {REC_GRAD_RTOL:g} of the tensor's largest, floor "
              f"{REC_NOISE_FLOOR:g} of the model's) [{card}]")
        if not (loss_err <= REC_LOSS_RTOL and errs[worst] <= REC_GRAD_RTOL):
            raise AssertionError(f"24d {name}: loss {loss_err}, {errs}")


def _to_device(tree, device):
    return _tree_map(lambda t: t.to(device), tree)


def _rec_learns(card: str) -> None:
    """24e: smoke xDeepFM on one repeated batch of REC_SMOKE_B samples,
    REC_SMOKE_STEPS steps of AdamW(REC_SMOKE_LR): the last loss below
    REC_SMOKE_DROP x the first."""
    from repro_torch.configs import xdeepfm
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import TrainStep
    cfg = xdeepfm.SMOKE
    params = _rec_init(cfg, 0)
    step = TrainStep(_rec_loss(cfg), AdamW(lr=REC_SMOKE_LR))
    state = step.init_state(params)
    b = _rec_batch(cfg, REC_SMOKE_B, 0)
    losses = []
    t0 = time.perf_counter()
    for _ in range(REC_SMOKE_STEPS):
        params, state, loss = step(params, state, b)
        losses.append(loss)
    first, last = float(losses[0]), float(losses[-1])
    print(f"  24e {cfg.name}: {REC_SMOKE_STEPS} steps on one batch of "
          f"{REC_SMOKE_B} "
          f"in {time.perf_counter() - t0:.2f} s: loss {first:.4f} -> "
          f"{last:.4f} ({last / first:.3f} x; limit {REC_SMOKE_DROP}) "
          f"[{card}]")
    if not last < REC_SMOKE_DROP * first:
        raise AssertionError(f"24e: loss {first} -> {last}")


def phase_rec_training(card: str) -> dict:
    """24: recommender training on the card (24a-24e); returns the bag's
    and the CIN's launches in 24a's timed steps."""
    import torch
    from repro_torch.configs import autoint, deepfm, mind, xdeepfm
    cfg = xdeepfm.FULL
    print(f"== phase 24a: training {cfg.name} at full width "
          f"({cfg.n_sparse} fields, CIN {cfg.cin_layers}, MLP {cfg.mlp}), "
          f"{cfg.dtype}, random weights (seed 0); the train_batch cell: "
          f"B = {REC_TRAIN_B}, AdamW(lr={REC_TRAIN_LR:g}), ctr_batch "
          f"batches")
    t0 = time.perf_counter()
    run = _rec_train(card, cfg, "24a", REC_TRAIN_TIMED)
    counts = run["counts"]
    if not (counts["embedding_bag"] > 0 and counts["cin_layer"] > 0):
        raise AssertionError(f"24a: launches {counts}")
    _rec_breakdown(card, cfg, run)
    print(f"  (phase 24a: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    print(f"== phase 24b: {cfg.name} gradients, determinism, serving")
    _rec_check_grads(card, cfg, run["params"])
    _rec_repeat_and_serve(card, cfg, run)
    del run
    torch.cuda.empty_cache()
    print(f"  (phase 24b: {time.perf_counter() - t0:.1f} s)")
    for mod, label in ((deepfm, "24c"), (autoint, "24c"), (mind, "24d")):
        c = mod.FULL
        t0 = time.perf_counter()
        print(f"== phase {label}: training {c.name} at full width, {c.dtype},"
              f" random weights (seed 0), B = {REC_TRAIN_B}"
              + (f", {1024} shared negatives uniform over "
                 f"{c.item_vocab:,} items" if mod is mind else ""))
        other = _rec_train(card, c, label, 1)
        del other
        torch.cuda.empty_cache()
        print(f"  (phase {label} {c.name}: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    _rec_card_vs_cpu(card)
    _rec_learns(card)
    print(f"  (phases 24d-24e checks: {time.perf_counter() - t0:.1f} s)")
    return counts


# -- phase 25: DimeNet -------------------------------------------------------
DN_MOLECULE = dict(n_molecules=128, n_atoms=30, n_bonds=64, d_feat=32)
DN_BASE = dict(n_nodes=232_965, avg_degree=64, d_feat=602)  # degree CUT
DN_SEEDS, DN_FANOUTS = 1024, (15, 10)
DN_REF_DEGREE = 492              # 114,615,892 edges / 232,965 nodes
# the sample (nodes, edges, triplets) from the same seeds at the reference's
# degree: `PYTHONPATH=src python tools/dimenet_sample_sizes.py 492`
DN_REF_SAMPLE = (118_041, 163_270, 101_848)
DN_TIMED = 3
DN_F32_RTOL = 1e-2               # bfloat16 loss vs a float32 copy
DN_FWD_RTOL, DN_GRAD_RTOL, DN_LOSS_RTOL = 1e-5, 1e-4, 1e-5


def _dn_dims(shape_name: str) -> dict:
    """A DimeNet cell's padded buffers (`specs.gnn_cell_dims`)."""
    from repro_torch.configs import dimenet
    from repro_torch.launch.specs import gnn_cell_dims
    return gnn_cell_dims(next(s for s in dimenet.SPEC.shapes
                              if s.name == shape_name))


def _pad_nodes(g, n: int):
    """``g`` with zero-feature nodes appended up to ``n``, in graph
    n_graphs - 1 (`build_graph_batch`'s fill)."""
    import dataclasses
    import torch
    extra = n - g.n_nodes
    return dataclasses.replace(
        g, node_feat=torch.cat([g.node_feat, g.node_feat.new_zeros(
            (extra, g.node_feat.shape[1]))]),
        node_graph=torch.cat([g.node_graph, g.node_graph.new_full(
            (extra,), g.n_graphs - 1)]))


def _dn_step(card: str, cfg, g, y, label: str, unit: str, n_units: int,
             timed: int = DN_TIMED) -> dict:
    """`TrainStep(AdamW(1e-4))` on DimeNet ``cfg`` (random weights, seed 0)
    over one graph batch: a forward, a warm-up step and ``timed`` timed
    steps; fails if a loss is not finite or a port kernel launched."""
    import torch
    from repro_torch.models import dimenet as DN
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import TrainStep
    torch.cuda.empty_cache()
    params = DN.init_params(0, cfg, g.node_feat.shape[1])
    with torch.no_grad():
        fwd_ms = _time_ms(lambda: DN.forward(params, cfg, g), n=3, warm=1)
    step = TrainStep(lambda p, b: DN.train_step_loss(p, cfg, g, b["y"]),
                     AdamW(lr=1e-4))
    state = step.init_state(params)
    losses = []

    def one():
        nonlocal params, state
        params, state, loss = step(params, state, {"y": y})
        losses.append(loss)
    warm = _wall(one)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    _reset_recsys_counts()
    walls = [_wall(one) for _ in range(timed)]
    peak = torch.cuda.max_memory_allocated()
    rec = _recsys_counts()
    counts = dict(_counts(), **_attention_counts())
    counts["plain"] += rec.pop("plain")
    counts.update(rec)
    wall = sorted(walls)[len(walls) // 2]
    vals = torch.stack(losses).float().cpu()
    print(f"  forward {fwd_ms:.2f} ms; step wall "
          f"{', '.join(f'{w * 1e3:.2f}' for w in walls)} ms (warm-up "
          f"{warm * 1e3:.1f} ms), median {wall * 1e3:.2f} ms = "
          f"{n_units / wall:,.0f} {unit}/s; peak memory {peak / 1e9:.2f} GB;"
          f" losses {', '.join(f'{x:.5f}' for x in vals.tolist())} [{card}]")
    if not bool(torch.isfinite(vals).all()) or any(counts.values()):
        raise AssertionError(f"{label}: losses {vals.tolist()}, port kernel "
                             f"launches {counts} (DimeNet has none)")
    return {"params": params, "state": state, "step": step, "wall": wall,
            "one": one}


def _dn_breakdown(card: str, cfg, g, run: dict) -> None:
    """25b: where a step's time goes: a device-only trace for the busy
    time (the idle share), and the three message-passing pieces of one
    block timed alone forward and backward on the step's shapes: the
    gathers (node -> edge twice, edge -> triplet), the bilinear product
    and the segment sums (triplet -> edge, edge -> node)."""
    import torch
    from repro_torch._segment import gather_rows, segment_sum
    from repro_torch.models import dimenet as DN
    traced = phase_profile(card, run["wall"], run["one"],
                           "phase 25b: device time by kernel, one DimeNet "
                           "training step (minibatch_lg)", trace_host=False)
    busy = sum(ms for ms, _ in traced.values())
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device="cuda").manual_seed(25)
    h, nb = cfg.d_hidden, cfg.n_bilinear
    n, e, t = g.n_nodes, g.n_edges, g.tri_kj.shape[0]

    def rnd(*shape):
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        return x.requires_grad_(True)
    kj = DN._kept(g.tri_kj, g.tri_mask, e)
    ji = DN._kept(g.tri_ji, g.tri_mask, e)
    src = DN._kept(g.edge_src, g.edge_mask, n)
    dst = DN._kept(g.edge_dst, g.edge_mask, n)
    hn, me, tr = rnd(n, h), rnd(e, h), rnd(t, h)
    sw, xk, bil = rnd(t, nb), rnd(t, h), rnd(h, nb, h)

    def fb(fn, *xs):
        out = fn()
        torch.autograd.grad(out, xs, torch.ones_like(out))
    node_gathers = 2 * _device_ms(lambda: fb(lambda: gather_rows(
        hn, g.edge_src, grad_ids=src), hn), n=3, warm=1)
    tri_gather = _device_ms(lambda: fb(lambda: gather_rows(
        me, g.tri_kj, grad_ids=kj), me), n=3, warm=1)
    bilinear = _device_ms(lambda: fb(lambda: DN._bilinear(sw, xk, bil),
                                     sw, xk, bil), n=3, warm=1)
    seg = (_device_ms(lambda: fb(lambda: segment_sum(tr, ji, e), tr), n=3,
                      warm=1)
           + _device_ms(lambda: fb(lambda: segment_sum(me, dst, n), me),
                        n=3, warm=1))
    nblk = cfg.n_blocks
    gather = node_gathers + nblk * tri_gather
    print(f"  timed alone, forward and backward, x {nblk} blocks (the "
          f"embedding block's two node gathers once) [{card}]: gathers "
          f"{gather:.2f} ms ({100 * gather / busy:.1f} % of "
          f"{busy:.2f} ms busy), the bilinear product {bilinear * nblk:.2f}"
          f" ms ({100 * bilinear * nblk / busy:.1f} %), the segment sums "
          f"{seg * nblk:.2f} ms ({100 * seg * nblk / busy:.1f} %)")


def _dn_smoke_card_vs_cpu(card: str) -> None:
    """25c: DimeNet SMOKE in float32, card against CPU on the same
    weights: forward on a molecule batch and a sampled subgraph, the
    loss and every gradient."""
    import numpy as np
    import torch
    from repro_torch.configs import dimenet
    from repro_torch.data import graph_sampler as GS
    from repro_torch.models import dimenet as DN
    from repro_torch.train.optimizer import named_tensors
    cfg = dimenet.SMOKE
    mol, y = GS.make_molecule_batch(8, 12, 24, 8, seed=3, device="cpu")
    base = GS.make_power_law_graph(2000, avg_degree=8, d_feat=8, seed=3)
    nodes, es, ed = GS.neighbor_sample(base, np.arange(32), (5, 4), seed=3)
    sub = GS.build_graph_batch(base, nodes, es, ed, pad_nodes=1024,
                               pad_edges=1024, pad_triplets=4096, seed=3,
                               device="cpu")
    cpu = DN.init_params(4, cfg, 8, device="cpu")
    gpu = _to_device(cpu, "cuda")
    for what, g, yy in (("molecule", mol, y),
                        ("sampled subgraph", sub, y[:1])):
        res = {}
        for dev, p in (("cuda", gpu), ("cpu", cpu)):
            gd, yd = g.to(dev), yy.to(dev)
            named = named_tensors(p)
            for t in named.values():
                t.requires_grad_(True)
            with torch.no_grad():
                out = DN.forward(p, cfg, gd)
            loss = DN.train_step_loss(p, cfg, gd, yd)
            grads = torch.autograd.grad(loss, list(named.values()))
            res[dev] = (out.cpu(), loss.detach().cpu(),
                        dict(zip(named, grads)))
        (og, lg, gg), (oc, lc, gc) = res["cuda"], res["cpu"]
        fwd = float((og - oc).abs().max() / oc.abs().max())
        loss_err = abs(float(lg) - float(lc)) / abs(float(lc))
        errs = _grad_errs(gg, gc)
        worst = max(errs, key=errs.get)
        print(f"  25c {cfg.name} {what}: forward {fwd:.1e} of its largest "
              f"(limit {DN_FWD_RTOL:g}), loss {loss_err:.1e} "
              f"({DN_LOSS_RTOL:g}), gradients <= {errs[worst]:.1e} "
              f"({worst}; {DN_GRAD_RTOL:g}) [{card}]")
        if not (fwd <= DN_FWD_RTOL and loss_err <= DN_LOSS_RTOL
                and errs[worst] <= DN_GRAD_RTOL):
            raise AssertionError(f"25c {what}: forward {fwd}, loss "
                                 f"{loss_err}, gradients {errs}")


def phase_dimenet(card: str) -> None:
    """25: DimeNet at FULL on molecule (25a) and minibatch_lg (25b), then
    its checks (25c)."""
    import numpy as np
    import torch
    from repro_torch.configs import dimenet
    from repro_torch.data import graph_sampler as GS
    from repro_torch.models import dimenet as DN
    cfg = dimenet.FULL
    t0 = time.perf_counter()
    mol, y = GS.make_molecule_batch(**DN_MOLECULE, pad_triplet_factor=4,
                                    seed=0)
    mol = _pad_nodes(mol, _dn_dims("molecule")["nodes"])
    print(f"== phase 25a: DimeNet FULL ({cfg.n_blocks} blocks, h "
          f"{cfg.d_hidden}, {cfg.n_bilinear} bilinear, "
          f"{cfg.n_spherical} x {cfg.n_radial} basis, {cfg.dtype}), random "
          f"weights (seed 0), molecule: {DN_MOLECULE['n_molecules']} "
          f"molecules x {DN_MOLECULE['n_atoms']} atoms, "
          f"{DN_MOLECULE['n_bonds']} bonds, buffers {mol.n_nodes} nodes, "
          f"{mol.n_edges} edges, {mol.tri_kj.shape[0]} triplets "
          f"({int(mol.tri_mask.sum())} real), d_feat "
          f"{DN_MOLECULE['d_feat']}; made in {time.perf_counter() - t0:.1f}"
          " s")
    mol_params = _dn_step(card, cfg, mol, y, "25a", "graphs",
                          DN_MOLECULE["n_molecules"])["params"]
    t0 = time.perf_counter()
    base = GS.make_power_law_graph(DN_BASE["n_nodes"], DN_BASE["avg_degree"],
                                   DN_BASE["d_feat"], seed=0)
    t_graph = time.perf_counter() - t0
    nodes, es, ed = GS.neighbor_sample(base, np.arange(DN_SEEDS),
                                       DN_FANOUTS, seed=0)
    lg = _dn_dims("minibatch_lg")
    buffers = dict(pad_nodes=lg["nodes"], pad_edges=lg["edges"],
                   pad_triplets=lg["triplets"])
    g = GS.build_graph_batch(base, nodes, es, ed, **buffers, seed=0)
    del base
    y_lg = torch.randn((1, cfg.d_out), generator=torch.Generator(
        device="cuda").manual_seed(25), device="cuda")
    n_tri = int(g.tri_mask.sum())
    print(f"== phase 25b: DimeNet FULL, minibatch_lg: base graph "
          f"{DN_BASE['n_nodes']:,} nodes at average degree "
          f"{DN_BASE['avg_degree']} (CUT from the reference's "
          f"{DN_REF_DEGREE}: generated in {t_graph:.1f} s), {DN_SEEDS} "
          f"seeds, fanouts {DN_FANOUTS}, d_feat {DN_BASE['d_feat']}; "
          f"sampled {len(nodes):,} nodes, {len(es):,} edges, {n_tri:,} "
          f"triplets (at degree {DN_REF_DEGREE} from the same seeds: "
          + ", ".join(f"{n:,}" for n in DN_REF_SAMPLE) + "; "
          + ", ".join(f"{100 * (a / b - 1):+.2f} %" for a, b in zip(
              (len(nodes), len(es), n_tri), DN_REF_SAMPLE))
          + f"; the cell's buffers {buffers['pad_nodes']:,}, "
          f"{buffers['pad_edges']:,}, {buffers['pad_triplets']:,}); "
          f"sampled and padded in {time.perf_counter() - t0:.1f} s "
          "(set-up)")
    run = _dn_step(card, cfg, g, y_lg, "25b", "seeds", DN_SEEDS)
    _dn_breakdown(card, cfg, g, run)
    print(f"  (phase 25a-25b: {time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    print("== phase 25c: DimeNet checks")
    same = _repeats_bitwise(run["step"], run["params"], run["state"],
                            {"y": y_lg})
    print(f"  25c minibatch_lg: the step from a saved state twice: weights,"
          f" AdamW moments and loss {'bitwise equal' if same else 'DIFFERENT'}"
          f" [{card}]")
    if not same:
        raise AssertionError("25c: a repeated DimeNet step differs")
    del run
    torch.cuda.empty_cache()
    with torch.no_grad():
        l16 = float(DN.train_step_loss(mol_params, cfg, mol, y))
        p32 = _as_dtype(mol_params, torch.float32)
        l32 = float(DN.train_step_loss(p32, cfg, mol, y))
    err = abs(l16 - l32) / abs(l32)
    print(f"  25c molecule: bfloat16 loss {l16:.6f}, float32 copy "
          f"{l32:.6f}, relative {err:.2e} (limit {DN_F32_RTOL:g}) [{card}]")
    if not err <= DN_F32_RTOL:
        raise AssertionError(f"25c: bfloat16 vs float32 loss {err}")
    del mol_params, p32
    _dn_smoke_card_vs_cpu(card)
    print(f"  (phase 25c: {time.perf_counter() - t0:.1f} s)")


# -- phase 26: the production dry run and the roofline -----------------------
# (a) one full-size cell of each family on both production meshes, and
# (d) two serving cells for the plans; (b) cells held against real steps
DRY_CELLS = (("qwen3-8b", "train_4k"), ("xdeepfm", "train_batch"),
             ("dimenet", "ogb_products"))
DRY_PLAN_CELLS = (("qwen3-8b", "decode_32k"), ("xdeepfm", "serve_p99"))
DRY_REAL = (("xdeepfm", "train_batch"), ("dimenet", "molecule"),
            ("qwen3-1.7b", "long_500k"))
DRY_RECORD_KEYS = ("flops_global", "bytes_global",
                   "collective_bytes_global", "compute_s", "memory_s",
                   "collective_s", "model_flops", "useful_flops_ratio")


def _dry_shape(arch: str, shape: str):
    from repro_torch.configs.registry import get_arch
    spec = get_arch(arch)
    return spec, next(s for s in spec.shapes if s.name == shape)


def _dry_check(rec: dict, build, mesh, what: str) -> None:
    """Every figure of a record finite; its per-device argument bytes
    those of its stand-ins' shard shapes (recomputed from each spec)."""
    from repro_torch.launch import sharding, specs
    vals = [rec[k] for k in DRY_RECORD_KEYS] + list(
        rec["memory_analysis"].values())
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"26 {what}: a figure is not finite: {rec}")
    args_b = sum(math.prod(sharding.shard_shape(t.shape, t.spec, mesh))
                 * t.element_size() for t in specs.stand_ins(build.args))
    if args_b != rec["memory_analysis"]["argument_bytes"]:
        raise AssertionError(f"26 {what}: argument bytes "
                             f"{rec['memory_analysis']['argument_bytes']} "
                             f"but the stand-ins' shards hold {args_b}")


def _dry_print(rec: dict) -> None:
    ma = rec["memory_analysis"]
    bound = max(rec["compute_s"], rec["memory_s"], rec["collective_s"])
    print(f"  {rec['arch']} x {rec['shape']} x {rec['mesh']} "
          f"({rec['n_chips']} chips): compute {rec['compute_s']:.4e} s, "
          f"memory {rec['memory_s']:.4e} s, collective "
          f"{rec['collective_s']:.4e} s, bound {rec['bound']} "
          f"({bound * 1e3:.3f} ms); per device: args "
          f"{ma['argument_bytes'] / 2**30:.3f} GiB, out "
          f"{ma['output_bytes'] / 2**30:.3f} GiB, temp "
          f"{ma['temp_bytes'] / 2**30:.3f} GiB, peak "
          f"{ma['peak_bytes'] / 2**30:.3f} GiB; FLOPs "
          f"{rec['flops_global']:.4e} (model/counted "
          f"{rec['useful_flops_ratio']:.3f}); counted "
          f"{rec['counted']}, estimated {rec['estimated']} (analytic, "
          "H100_SXM)")


def _dry_records(card: str) -> list:
    """26a: DRY_CELLS and DRY_PLAN_CELLS on both production meshes, each
    traced once on the host (meta stand-ins, fake CPU tensors)."""
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_production_mesh
    print("== phase 26a: the dry run on the production meshes, (16, 16) and"
          " (2, 16, 16) on meta devices (host only; figures analytic for "
          "H100_SXM)")
    records = []
    for arch, shape_name in DRY_CELLS + DRY_PLAN_CELLS:
        spec, shape = _dry_shape(arch, shape_name)
        t0 = time.perf_counter()
        trace = dryrun.cell_trace(arch, shape_name)
        for multi in (False, True):
            mesh = make_production_mesh(
                multi_pod=multi, devices=["meta"] * (512 if multi else 256))
            build = specs.build_cell(spec, shape, mesh, multi)
            rec = dryrun.run_cell(arch, shape_name, multi, verbose=False,
                                  trace=trace)
            _dry_check(rec, build, mesh, f"{arch} x {shape_name}")
            _dry_print(rec)
            records.append(rec)
        print(f"    (traced in {trace.seconds:.1f} s; both meshes "
              f"{time.perf_counter() - t0:.1f} s)")
    return records


def _dry_real_args(arch: str, spec, shape):
    """The real arguments of a (b) cell on the card, its step (the path
    the card runs, impl="auto") and a description."""
    import torch
    from repro_torch.models import dimenet as DN
    from repro_torch.models import recsys as RS
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import TrainStep
    cfg = spec.config
    if arch == "xdeepfm":
        params = RS.init_xdeepfm(0, cfg)
        batch = _rec_batch(cfg, shape["batch"], 0)
        step = TrainStep(RS.ctr_train_loss(cfg), AdamW(lr=1e-4))
        state = step.init_state(params)
        args = (params, state, batch)
        return args, lambda: step(*args), f"B = {shape['batch']:,}"
    if arch == "dimenet":
        from repro_torch.data import graph_sampler as GS
        dims = _dn_dims(shape.name)
        g, y = GS.make_molecule_batch(**DN_MOLECULE, pad_triplet_factor=4,
                                      seed=0)
        g = _pad_nodes(g, dims["nodes"])
        # the cell's features are in the model's dtype (the forward casts)
        g = dataclasses.replace(g, node_feat=g.node_feat.to(
            getattr(torch, cfg.dtype)))
        params = DN.init_params(0, cfg, dims["feat"])
        step = TrainStep(lambda p, b: DN.train_step_loss(p, cfg, b["graph"],
                                                         b["y"]),
                         AdamW(lr=1e-4))
        state = step.init_state(params)
        args = (params, state, {"graph": g, "y": y})
        return args, lambda: step(*args), (
            f"{g.n_nodes:,} nodes, {g.n_edges:,} edges, "
            f"{g.tri_kj.shape[0]:,} triplets")
    b, s = shape["global_batch"], shape["seq_len"]
    shape5 = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head)
    print(f"  {arch} x {shape.name}: the bf16 KV cache is "
          f"{cfg.n_layers} x {s:,} x {cfg.n_kv_heads} x {cfg.d_head} x 2 "
          f"(K, V) x 2 B = {2 * math.prod(shape5) * 2 / 1e9:.1f} GB and the "
          f"weights {cfg.n_params * 2 / 1e9:.1f} GB; allocating")
    model = T.init_params(0, cfg)
    cache = T.init_kv_cache(cfg, b, s)
    cache["len"] = s - 1
    tokens = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    args = (model, tokens, cache)
    return args, lambda: T.decode_step(model, cfg, tokens, cache), (
        f"cache len {s - 1:,}")


def _dry_count(run) -> tuple[float, float]:
    """(FlopCounterMode's count of one ``run()``, its peak allocation)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter = FlopCounterMode(display=False)
    with counter:
        run()
    torch.cuda.synchronize()
    return (float(counter.get_total_flops()),
            float(torch.cuda.max_memory_allocated()))


def _dry_real(card: str) -> None:
    """26b: each DRY_REAL cell's record on a (1, 1) mesh of cuda:0 against
    its real step on the card: argument bytes and counted FLOPs exactly
    (the kernels count by their custom operators' formulas on both
    sides); temporaries and time printed beside the record's."""
    import torch
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_mesh
    print("== phase 26b: stand-ins against real steps, (1, 1) mesh of "
          "cuda:0")
    mesh = make_mesh((1, 1), ("data", "model"), devices=["cuda:0"])
    for arch, shape_name in DRY_REAL:
        t0 = time.perf_counter()
        spec, shape = _dry_shape(arch, shape_name)
        rec = dryrun.run_cell(arch, shape_name, False, verbose=False,
                              mesh=mesh)
        ma = rec["memory_analysis"]
        torch.cuda.empty_cache()
        args, run, what = _dry_real_args(arch, spec, shape)
        real = float(sum(t.numel() * t.element_size()
                         for t in specs.stand_ins(args)))
        if real != ma["argument_bytes"]:
            raise AssertionError(
                f"26b {arch} x {shape_name} ({what}): arguments {real} B "
                f"on the card, {ma['argument_bytes']} by the dry run")
        flops, peak = _dry_count(run)
        ms = _time_ms(run, n=3, warm=1)
        del args, run
        torch.cuda.empty_cache()
        lower = max(rec["compute_s"], rec["memory_s"], rec["collective_s"])
        temp = peak - real
        print(f"  {arch} x {shape_name} ({what}): arguments {real:,.0f} B "
              f"on the card = {ma['argument_bytes']:,.0f} B by the dry run;"
              f" FLOPs {flops:.6e} counted on the card = "
              f"{rec['flops_global']:.6e} by the dry run; "
              f"max_memory_allocated less the arguments "
              f"{temp / 2**30:.3f} GiB against the dry run's temp "
              f"{ma['temp_bytes'] / 2**30:.3f} GiB (dry / card "
              f"{ma['temp_bytes'] / max(temp, 1):.3f}), peak "
              f"{ma['peak_bytes'] / 2**30:.3f} GiB; step {ms:.3f} ms (CUDA "
              f"events) against the record's step_time_lower_bound "
              f"{lower * 1e3:.3f} ms ({rec['bound']}-bound; card / record "
              f"{ms / 1e3 / lower:.2f}) [{card}]")
        if flops != rec["flops_global"]:
            raise AssertionError(f"26b {arch} x {shape_name}: FLOPs "
                                 f"{flops} on the card vs "
                                 f"{rec['flops_global']} by the dry run")
        print(f"    ({arch} x {shape_name}: "
              f"{time.perf_counter() - t0:.1f} s)")


def _dry_plans(card: str, records: list) -> None:
    """26c-26d: the kernels on H100_SXM's roofline, then the records'
    tables and serving plans."""
    import importlib.util
    from repro_torch.obs import profile as obs_profile
    from repro_torch.roofline import report
    print("== phase 26c: the port's kernels on H100_SXM's roofline "
          "(profile_kernels on the card)")
    kern = obs_profile.profile_kernels()
    table = report.kernel_roofline(kern)
    if report.kernel_roofline([r.to_json() for r in kern]) != table:
        raise AssertionError("26c: kernel_roofline differs after to_json()")
    print(table)
    print(f"  run_s: " + ", ".join(f"{r.name} {r.run_s * 1e3:.4f} ms"
                                   for r in kern)
          + f"; records and their to_json() render identically [{card}]")
    print("== phase 26d: tables and serving plans from the records")
    with tempfile.TemporaryDirectory() as d:
        for r in records:
            with open(os.path.join(
                    d, f"{r['arch']}__{r['shape']}__{r['mesh']}.json"),
                    "w") as f:
                json.dump(r, f)
        recs = report.load_records(d)
        if len(recs) != len(records):
            raise AssertionError(f"26d: {len(recs)} records read back of "
                                 f"{len(records)}")
        print(report.dryrun_summary(recs))
        print(report.roofline_table(recs))
        print(report.roofline_table(recs, mesh="multi"))
        spec = importlib.util.spec_from_file_location(
            "torch_plan_llm_serving",
            ROOT / "examples" / "torch_plan_llm_serving.py")
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        if example.main(["--dryrun-dir", d]) != 0:
            raise AssertionError("26d: the plan example failed")


def phase_dryrun(card: str) -> None:
    """26: the dry run (26a), its stand-ins against real steps (26b), the
    kernels on the roofline (26c), and the tables and plans (26d)."""
    t0 = time.perf_counter()
    records = _dry_records(card)
    print(f"  (phase 26a: {time.perf_counter() - t0:.1f} s)")
    t1 = time.perf_counter()
    _dry_real(card)
    print(f"  (phase 26b: {time.perf_counter() - t1:.1f} s)")
    t1 = time.perf_counter()
    _dry_plans(card, records)
    print(f"  (phase 26c-26d: {time.perf_counter() - t1:.1f} s)")


# -- phase 27: the port's static analysis and the card's sync audit ---------
AUDIT_CHUNKS = 2            # chunks a path is audited over (after a warm-up)
# the positive control: one DimeNet segment sum of minibatch_lg's triplets
# into its edges (the reference degree's sample, DN_REF_SAMPLE)
AUDIT_SEGMENT = (DN_REF_SAMPLE[2], DN_REF_SAMPLE[1], 128)   # (T, E, hidden)
SYNC_WARNING = "synchronizing CUDA operation"


class _SyncLog:
    """The card's own account of host syncs: under
    ``torch.cuda.set_sync_debug_mode("warn")`` every synchronizing CUDA
    call warns; each warning is kept with the Python stack it was raised
    from (its port frames, innermost first, as (repo path, line))."""

    def __init__(self):
        self.events: list[list[tuple[str, int]]] = []

    def __enter__(self):
        import traceback
        import warnings
        import torch
        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("always")
        port = str(ROOT / "src" / "repro_torch")

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING not in str(message):
                return
            self.events.append([
                (pathlib.Path(fr.filename).resolve().relative_to(ROOT)
                 .as_posix(), fr.lineno)
                for fr in reversed(traceback.extract_stack())
                if str(pathlib.Path(fr.filename).resolve()).startswith(port)])
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode("default")
        self._ctx.__exit__(*exc)
        return False


def _rule_sites() -> tuple[dict, list]:
    """RPT101's sites over the port, {(path, line): suppressed}, and the
    chunk loops of its hot path, [(path, first line, last line)]."""
    from repro_torch.staticcheck import cli, rules_hostsync
    sites = {(f.path, f.line): f.suppressed
             for f in cli.run(["src/repro_torch"], ROOT)
             if f.rule_id == "RPT101"}
    loops = [(info.mod.rel, loop.lineno, loop.end_lineno)
             for info, loop in rules_hostsync.hot_path().loops]
    return sites, loops


def _audit(log: _SyncLog, loops, sites, what: str, n_chunks: int) -> dict:
    """Split ``log``'s syncs into those inside a chunk loop (each at its
    innermost port frame) and the rest; fail on an in-loop sync the rule
    does not report, suppressed."""
    inside, outside = {}, {}
    for stack in log.events:
        in_loop = any(path == lp and lo <= line <= hi
                      for path, line in stack for lp, lo, hi in loops)
        site = stack[0] if stack else ("(no port frame)", 0)
        tally = inside if in_loop else outside
        tally[site] = tally.get(site, 0) + 1
    n_in, n_out = sum(inside.values()), sum(outside.values())

    def at(tally):
        return ", ".join(f"{p.rsplit('/', 1)[-1]}:{n} x{k}"
                         for (p, n), k in sorted(tally.items()))
    print(f"  {what}: {n_in} syncs in {n_chunks} chunks = "
          f"{n_in / n_chunks:g} a chunk" + (f" ({at(inside)})" if inside
                                            else "")
          + f"; {n_out} outside the loop, in set-up and epilogue"
          + (f" ({at(outside)})" if outside else ""))
    missed = [s for s in inside if not sites.get(s, False)]
    if missed:
        raise AssertionError(f"27b {what}: syncs inside the chunk loop at "
                             f"{missed}, which RPT101 does not report "
                             "suppressed with a reason")
    return {"in_loop": n_in, "per_chunk": n_in / n_chunks,
            "outside": n_out, "sites": sorted(inside)}


def phase_staticcheck(card: str) -> dict:
    """27: the port's checker on the card's host (27a), the host-sync rule
    held against the card's sync debug mode on four simulator paths and a
    segment sum (27b), the shape contract's probes on the card (27c)."""
    import collections
    import torch
    from repro_torch._segment import segment_sum
    from repro_torch.core import simulator
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.launch.elastic import AutoscalePolicy
    from repro_torch.obs import TelemetrySpec
    from repro_torch.staticcheck import cli, contract
    t27 = time.perf_counter()
    print("== phase 27a: python -m repro_torch.staticcheck src/repro_torch "
          "tests examples chip_smoke.py")
    findings = cli.run(list(cli.DEFAULT_TARGETS), ROOT)
    active = [f for f in findings if not f.suppressed]
    if active:
        raise AssertionError("27a: active findings:\n"
                             + "\n".join(f.render() for f in active))
    by_rule = collections.Counter(f.rule_id for f in findings)
    print(f"  0 active findings, {len(findings)} suppressed over "
          f"{len(cli.collect_files(list(cli.DEFAULT_TARGETS), ROOT))} "
          f"files; by rule {dict(sorted(by_rule.items()))}")
    for f in findings:
        print(f"    {f.path}:{f.line} {f.rule_id}")
    print(f"  (phase 27a: {time.perf_counter() - t27:.1f} s)")

    t0 = time.perf_counter()
    sites, loops = _rule_sites()
    print(f"== phase 27b: sync audit, {AUDIT_CHUNKS} chunks a path under "
          "torch.cuda.set_sync_debug_mode('warn'); chunk loops "
          + ", ".join(f"{p}:{lo}-{hi}" for p, lo, hi in loops))
    lam1, params = _table6_batch()
    lam17, params17 = _slab17(SIM16_LAM, SIM16_SPEEDS)
    profile, arrival, chunk17 = _profile17(lam17)
    pol = AutoscalePolicy(**SIM17_POLICY)
    fault17 = _fault17(profile)
    paths = {
        "r = 1 main path": lambda n: simulator.simulate_fork_join_batch(
            11, lam1, params, n * CHUNK, p=P, chunk_size=CHUNK),
        f"r = {R} JSQ, result cache":
            lambda n: simulator.simulate_fork_join_batch(
                11, R * lam1, params, n * CHUNK, p=P, chunk_size=CHUNK,
                cluster=ClusterSpec(r=R, routing="jsq",
                                    result_cache=RESULT_CACHE)),
        # (not through _sim17: its filter would hide the card's warnings)
        "17b autoscaled slab (JSQ)":
            lambda n: simulator.simulate_fork_join_batch(
                SIM17_SEED, arrival, params17, n * chunk17, p=P,
                chunk_size=CHUNK, cluster=ClusterSpec(
                    routing="jsq", result_cache=RESULT_CACHE,
                    autoscale=pol)),
        "17c faulted slab (JSQ), telemetry on":
            lambda n: simulator.simulate_fork_join_batch(
                SIM17_SEED, arrival, params17, n * chunk17, p=P,
                chunk_size=CHUNK, cluster=ClusterSpec(
                    r=R, routing="jsq", result_cache=RESULT_CACHE,
                    fault=fault17),
                telemetry=TelemetrySpec(n_bins=OBS_BINS)),
    }
    import warnings
    audit = {}
    for what, run in paths.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # chunk clamp
            run(1)                                         # warm-up
            torch.cuda.synchronize()
        with _SyncLog() as log:                # (the clamp's warning is
            run(AUDIT_CHUNKS)                  # dropped: not a sync)
        torch.cuda.synchronize()
        audit[what] = _audit(log, loops, sites, what, AUDIT_CHUNKS)
    # the audit's own check: a sync seeded into the loop (a draws callback
    # that reads a value back) is caught, at the loop's call of it
    def seeded_draws(c):
        base = simulator.chunk_random_draws(11, c, N_SCEN, CHUNK, P, params,
                                            "exponential", device="cuda")
        float(base[0][0, 0])                       # the seeded sync
        return base
    with _SyncLog() as log:
        simulator.simulate_fork_join_batch(
            11, lam1, params, AUDIT_CHUNKS * CHUNK, p=P, chunk_size=CHUNK,
            draws=seeded_draws)
    torch.cuda.synchronize()
    try:
        _audit(log, loops, sites, "seeded sync in draws()", AUDIT_CHUNKS)
    except AssertionError as exc:
        print(f"    caught, as it must be: {str(exc)[:120]}")
    else:
        raise AssertionError("27b: the audit missed a seeded in-loop sync")
    # the positive control: the segment sums' two deliberate reads
    t, e, h = AUDIT_SEGMENT
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    data = torch.randn((t, h), device="cuda", generator=gen)
    ids = torch.randint(0, e + 1, (t,), device="cuda", generator=gen)
    torch.cuda.synchronize()
    with _SyncLog() as log:
        out = segment_sum(data, ids, e)
    seen = {stack[0] for stack in log.events if stack}
    want = {s for s, sup in sites.items()
            if s[0] == "src/repro_torch/_segment.py" and sup}
    plain = torch.zeros((e + 1, h), device="cuda").index_add_(
        0, ids.long(), data)[:e]
    err = float((out - plain).abs().max())
    print(f"  control: segment_sum of ({t:,}, {h}) into {e:,} rows: the card "
          f"reports syncs at {sorted(seen)}; the rule reports "
          f"{sorted(want)}; against index_add_ max abs err {err:.3g}")
    if len(want) != 2 or not want <= seen or not seen <= set(sites):
        raise AssertionError(f"27b control: card {sorted(seen)}, rule "
                             f"{sorted(want)}")
    if not err <= 1e-3:
        raise AssertionError(f"27b control: segment_sum vs index_add_ {err}")
    print(f"  (phase 27b: {time.perf_counter() - t0:.1f} s) [{card}]")

    t0 = time.perf_counter()
    print("== phase 27c: the shape contract's probes on the card")
    modes: dict = {}
    live = contract.snapshot("cuda", modes=modes)
    committed = contract.load()["probes"]
    bad = contract.check(live=live)
    if bad:
        raise AssertionError("27c: the card's specs differ from the "
                             "contract:\n" + "\n".join(f.render()
                                                       for f in bad))
    print(f"  {len(live)} probes, {sum(map(len, live.values()))} leaves: "
          f"the card's specs equal the committed contract (the CPU's; "
          f"{sum(m == 'fake' for m in contract.load()['modes'].values())} "
          f"probe traced under FakeTensorMode there) "
          f"[{len(committed)} committed]")
    print(f"  (phase 27c: {time.perf_counter() - t0:.1f} s)")
    print(f"  phase 27: {time.perf_counter() - t27:.1f} s [{card}]")
    return audit

CLUSTER28_QUERIES = 40_000      # examples/simulate_cluster.py's defaults
CLUSTER28_LAM = 15.0
CLUSTER28_WIDE = 1024           # the p whose runs are held to the plain path
EQ7_MARGIN = 0.05               # the exponential mean inside Eq 7 +- 5 %
BOUNDS_RTOL = 1e-6              # card vs CPU bounds and frontiers
SIM28_RTOL = 1e-5               # kernel vs plain path, mean and p95
CROWD28_PLAIN_CHUNKS = 2        # 28b's kernel-vs-plain crowd chunks
SERVE28_SECONDS = 15.0          # examples/serve_search.py's default


def _cluster28(card: str, cluster_ex) -> None:
    """28a: examples/torch_simulate_cluster.py's table on the card."""
    import torch
    from repro_torch.core import capacity, queueing
    from repro_torch.kernels.maxplus_scan import kernel, ops
    ps, modes = cluster_ex.PS, cluster_ex.MODES
    n_chunks = -(-CLUSTER28_QUERIES // min(CHUNK, CLUSTER28_QUERIES))
    print(f"== phase 28a: examples/torch_simulate_cluster.py on the card: "
          f"p = {', '.join(map(str, ps))}, {CLUSTER28_QUERIES:,} queries, "
          f"lam {CLUSTER28_LAM:g}, modes {', '.join(modes)}")
    cluster_ex.rows([8], CLUSTER28_LAM, CHUNK, device="cuda")   # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    rows = cluster_ex.rows(ps, CLUSTER28_LAM, CLUSTER28_QUERIES,
                           device="cuda")
    wall = time.perf_counter() - t0
    counts = _counts()
    want = {"maxplus_scan": 2 * n_chunks * len(ps) * len(modes),
            "maxplus_segment_scan": 0, "jsq_route": 0, "fleet_scan": 0}
    if counts != want:
        raise AssertionError(f"28a: launches {counts}, expected {want}")
    print(f"  {'p':>5s} {'lower':>8s} {'upper':>8s} | {'exp':>8s} "
          f"{'cache':>8s} {'balanced':>9s} {'wall_s':>7s}")
    for row in rows:
        m = row["mean"]
        print(f"  {row['p']:5d} {row['lower']:8.3f} {row['upper']:8.3f} | "
              f"{m['exponential']:8.3f} {m['cache']:8.3f} "
              f"{m['balanced']:9.3f} {row['wall_s']:7.2f}")
    print(f"  launches {counts} ({n_chunks} chunks a run, 2 scans a "
          f"chunk); {wall:.2f} s for the table [{card}]")
    for row in rows:
        pr = dataclasses.replace(capacity.TABLE5_PARAMS, p=row["p"])
        lo, hi = (float(x) for x in queueing.response_time_bounds(
            CLUSTER28_LAM, pr, device="cpu"))
        err = max(abs(row["lower"] - lo) / lo, abs(row["upper"] - hi) / hi)
        if not err <= BOUNDS_RTOL:
            raise AssertionError(f"28a p = {row['p']}: Eq 7 card vs CPU "
                                 f"{err} > {BOUNDS_RTOL}")
        exp, bal = row["mean"]["exponential"], row["mean"]["balanced"]
        if not (1 - EQ7_MARGIN) * lo < exp < (1 + EQ7_MARGIN) * hi:
            raise AssertionError(f"28a p = {row['p']}: exponential mean "
                                 f"{exp} outside Eq 7 [{lo}, {hi}] +- "
                                 f"{EQ7_MARGIN:.0%}")
        if not bal <= exp:
            raise AssertionError(f"28a p = {row['p']}: balanced mean {bal} "
                                 f"above the exponential {exp}")
    print(f"  Eq 7 card vs CPU within {BOUNDS_RTOL:g}; the exponential "
          f"means inside Eq 7 +- {EQ7_MARGIN:.0%}; balanced <= exponential "
          "at every p")
    kern = next(r for r in rows if r["p"] == CLUSTER28_WIDE)
    t0 = time.perf_counter()
    plain, = cluster_ex.rows([CLUSTER28_WIDE], CLUSTER28_LAM,
                             CLUSTER28_QUERIES, device="cuda", impl="torch")
    plain_wall = time.perf_counter() - t0
    for mode in modes:
        err = max(abs(kern[k][mode] - plain[k][mode]) / abs(plain[k][mode])
                  for k in ("mean", "p95"))
        print(f"  p = {CLUSTER28_WIDE} {mode}: kernel vs plain path mean "
              f"{kern['mean'][mode] * 1e3:.4f} / "
              f"{plain['mean'][mode] * 1e3:.4f} ms, p95 "
              f"{kern['p95'][mode] * 1e3:.4f} / "
              f"{plain['p95'][mode] * 1e3:.4f} ms: max rel err {err:.2e} "
              f"(limit {SIM28_RTOL:g})")
        if not err <= SIM28_RTOL:
            raise AssertionError(f"28a p = {CLUSTER28_WIDE} {mode}: kernel "
                                 f"vs plain {err} > {SIM28_RTOL}")
    print(f"  (the plain path's three runs at p = {CLUSTER28_WIDE}: "
          f"{plain_wall:.2f} s; the kernel's {kern['wall_s']:.2f} s)")
    # the scan at the widest chunk's shape, reckoned as for phase 2
    shape = (CLUSTER28_WIDE, CHUNK)
    gen = torch.Generator(device="cuda").manual_seed(28)
    a, b, carry = _inputs(shape, torch.float32, gen)
    ka, _ = ops.maxplus_scan_seeded(a, b, carry, impl="cuda", with_b=False)
    pa, _ = ops.maxplus_scan_seeded(a, b, carry, impl="torch", with_b=False)
    err = _rel_err(ka, pa)
    if not err <= 1e-5:
        raise AssertionError(f"28a: the scan at {shape} vs plain {err}")
    ms = _device_ms(lambda: kernel.maxplus_scan_cuda(a, b, carry,
                                                     with_b=False))
    plain_ms = _device_ms(lambda: ops.maxplus_scan_seeded(
        a, b, carry, impl="torch", with_b=False))

    def yardstick():             # timed only; the port never calls it
        big_b = torch.cumsum(b, -1)
        return big_b + torch.cummax(a - big_b, -1).values
    library_ms = _device_ms(yardstick)
    moved = shape[0] * shape[1] * 3 * a.element_size()
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = shape[0] * shape[1] * 3 / FP32_OPS_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    print(f"  the scan at {shape} float32, out_a only, device time of one "
          f"chunk's launch: kernel {ms:.4f} ms, bound {bound:.4f} ms "
          f"({'bytes' if bytes_ms >= ops_ms else 'operations'}: "
          f"{moved / 1e6:.1f} MB at 3.35 TB/s), {100 * bound / ms:.1f} %; "
          f"plain {plain_ms:.4f} ms, cumsum + cummax {library_ms:.4f} ms; "
          f"vs plain max rel err {err:.2e} [{card}]")


def _replicated28(card: str, rep) -> None:
    """28b: examples/torch_replicated_sweep.py on the card."""
    import torch
    from repro_torch.core import capacity
    from repro_torch.core.cluster import ClusterSpec
    print("== phase 28b: examples/torch_replicated_sweep.py on the card: "
          f"three strategy grids, the JSQ plan at {rep.TARGET:g} qps, the "
          f"3x flash crowd at {rep.CROWD_QUERIES:,} queries, chunk "
          f"{rep.CROWD_CHUNK}")
    t0 = time.perf_counter()
    card_f, cpu_f = rep.frontiers("cuda"), rep.frontiers("cpu")
    for name, f in card_f.items():
        g = cpu_f[name]
        for field in ("feasible", "r", "cost"):
            if not torch.equal(getattr(f, field).cpu(), getattr(g, field)):
                raise AssertionError(f"28b {name}: {field} card "
                                     f"{getattr(f, field)} vs CPU "
                                     f"{getattr(g, field)}")
        fin = g.feasible
        err = (_rel_err(f.response.cpu()[fin], g.response[fin])
               if bool(fin.any()) else 0.0)
        if not err <= BOUNDS_RTOL:
            raise AssertionError(f"28b {name}: responses card vs CPU {err}")
        print(f"  {name}: feasible, r and cost equal to the CPU's, "
              f"responses max rel err {err:.2e}")
        for i in range(len(rep.LAM)):
            print("     ", f.describe(i))
    for lam, (costs, best) in zip(rep.LAM, rep.head_to_head(card_f)):
        print(f"  lam={lam:5.0f} qps: "
              + "  ".join(f"{n}: {c:7.1f}" for n, c in costs.items())
              + f"   -> {best}")
    print(f"  (frontiers, card and CPU: {time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    params, plan = rep.cross_check("cuda", n_queries=rep.PLAN_QUERIES)
    torch.cuda.synchronize()
    plan_wall = time.perf_counter() - t0
    cpu_plan = capacity.plan_capacity(
        capacity.scenario_params(memory=4, p=100, device="cpu"), rep.TARGET,
        rep.SLO, cluster=ClusterSpec(routing="jsq"))
    if (plan.n_replicas, plan.servers_per_replica) != (4, 100) or (
            (plan.n_replicas, plan.servers_per_replica)
            != (cpu_plan.n_replicas, cpu_plan.servers_per_replica)):
        raise AssertionError(f"28b: the card plans {plan.n_replicas} x "
                             f"{plan.servers_per_replica}, the CPU "
                             f"{cpu_plan.n_replicas} x "
                             f"{cpu_plan.servers_per_replica}")
    err = abs(plan.response_upper_ms - cpu_plan.response_upper_ms) / \
        cpu_plan.response_upper_ms
    if not err <= BOUNDS_RTOL:
        raise AssertionError(f"28b: Eq 7 upper card vs CPU {err}")
    print(f"  plan: {plan.n_replicas} x {plan.servers_per_replica} (CPU "
          f"{cpu_plan.n_replicas} x {cpu_plan.servers_per_replica}), util "
          f"{plan.utilization:.4f}, Eq 7 upper {plan.response_upper_ms:.1f}"
          f" ms (card vs CPU {err:.1e}); simulated under JSQ at "
          f"{rep.TARGET:g} qps ({rep.PLAN_QUERIES:,} queries): mean "
          f"{plan.response_simulated_ms:.1f} ms, p95 "
          f"{plan.response_simulated_p95_ms:.1f} ms; {plan_wall:.2f} s "
          f"[{card}]")
    r_peak = 3 * plan.n_replicas
    n_chunks = -(-rep.CROWD_QUERIES // rep.CROWD_CHUNK)
    p95 = {}
    for r in (plan.n_replicas, r_peak):
        rep.crowd_run(params, r, "cuda", n_queries=rep.CROWD_CHUNK)  # warm
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res = rep.crowd_run(params, r, "cuda", n_queries=rep.CROWD_QUERIES)
        p95[r] = float(res.quantile(0.95))
        wall = time.perf_counter() - t0
        counts = _counts()
        # the broker's and the servers' segmented scans, one route a chunk
        want = {"maxplus_scan": 0, "maxplus_segment_scan": 2 * n_chunks,
                "jsq_route": n_chunks, "fleet_scan": 0}
        if counts != want:
            raise AssertionError(f"28b r = {r}: launches {counts}, expected "
                                 f"{want}")
        tag = "planned" if r == plan.n_replicas else "peak-provisioned"
        print(f"  crowd r = {r} ({tag}): mean "
              f"{float(res.mean_response) * 1e3:.1f} ms, p95 "
              f"{p95[r] * 1e3:.1f} ms ("
              f"{'meets' if p95[r] <= rep.SLO else 'MISSES'} the SLO); "
              f"{wall:.2f} s = {rep.CROWD_QUERIES / wall:.4g} queries/s; "
              f"launches {counts} [{card}]")
    if not p95[r_peak] < p95[plan.n_replicas]:
        raise AssertionError(f"28b: the peak-provisioned p95 {p95[r_peak]} "
                             f"is not below the planned {p95[plan.n_replicas]}")
    n = CROWD28_PLAIN_CHUNKS * rep.CROWD_CHUNK
    kern = rep.crowd_run(params, r_peak, "cuda", n_queries=n)
    t0 = time.perf_counter()
    plain = rep.crowd_run(params, r_peak, "cuda", n_queries=n, impl="torch")
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    if not torch.equal(kern.count, plain.count):
        raise AssertionError("28b: kernel vs plain path counts differ")
    err = _rel_err(kern.mean_response, plain.mean_response)
    print(f"  r = {r_peak}: kernel path vs plain path over the crowd's first "
          f"{CROWD28_PLAIN_CHUNKS} chunks: counts equal, means max rel err "
          f"{err:.2e} (limit 1e-5; plain path {plain_wall:.2f} s)")
    if not err <= 1e-5:
        raise AssertionError(f"28b r = {r_peak}: kernel vs plain {err}")


def _serve28(card: str, serve) -> None:
    """28c: examples/torch_serve_search.py's open loop on the card."""
    import numpy as np
    import torch
    from repro_torch.engine import cache as cache_lib
    from repro_torch.engine import server
    from repro_torch.workloadgen import loadgen, querygen
    print(f"== phase 28c: examples/torch_serve_search.py on the card: "
          f"{SERVE28_SECONDS:g} s open loop at {serve.LOAD:g} x capacity, "
          f"batch {serve.BATCH}, 20 ms window, {serve.CACHE_ENTRIES}-entry "
          "result cache")
    t0 = time.perf_counter()
    srv, uni = serve.build_engine("cuda")
    cpu_srv = server.IndexServer(srv.index, k_local=srv.k_local,
                                 device="cpu")
    _, qterms = querygen.sample_query_stream(uni, 4096, seed=7)
    qt = qterms[:serve.BATCH]
    _same_topk(srv.process(qt), cpu_srv.process(qt),
               "28c one batch, card vs CPU engine")
    s_query = serve.measure_s_query(srv, uni)
    rate = serve.LOAD / s_query
    lo, hi, hedge = serve.model_figures(s_query, rate, "cuda")
    print(f"  measured S_query {s_query * 1e3:.4f} ms, capacity "
          f"{1 / s_query:.0f} qps, offering {rate:.0f} qps; model "
          f"{lo * 1e3:.3f} <= R <= {hi * 1e3:.3f} ms; hedged-duplicate "
          f"threshold {hedge * 1e3:.3f} ms; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    arrivals = loadgen.poisson_arrivals(rate, SERVE28_SECONDS, seed=3)
    qids, qterms = querygen.sample_query_stream(uni, len(arrivals), seed=9)
    t0 = time.perf_counter()
    run = serve.serve_open_loop(
        srv.process, arrivals, qids, qterms, batch=serve.BATCH,
        window_s=0.020,
        cache=cache_lib.ResultCache(capacity_entries=serve.CACHE_ENTRIES))
    wall = time.perf_counter() - t0
    if run.served != len(arrivals):
        raise AssertionError(f"28c: served {run.served} of "
                             f"{len(arrivals)} arrivals")
    if not (run.latencies >= 0).all():
        raise AssertionError("28c: a negative latency (a request admitted "
                             "before it arrived)")
    lat = run.latencies
    first, last = run.drift()
    print(f"  served {run.served} of {len(arrivals)} in {wall:.2f} s "
          f"({run.served / wall:.0f} qps), result-cache hit "
          f"{run.cache_hits / run.served:.3f}; latency mean "
          f"{lat.mean() * 1e3:.2f} ms p50 {np.quantile(lat, .5) * 1e3:.2f} "
          f"p95 {np.quantile(lat, .95) * 1e3:.2f} p99 "
          f"{np.quantile(lat, .99) * 1e3:.2f} ms against the model's "
          f"[{lo * 1e3:.3f}, {hi * 1e3:.3f}] ms + the 20 ms window "
          f"[{card}]")
    print(f"  {run.behind} of {run.batches} batches started behind "
          f"schedule; mean latency first second {first * 1e3:.2f} ms, last "
          f"second {last * 1e3:.2f} ms (no gate on latencies)")
    torch.cuda.synchronize()


def phase_examples(card: str) -> None:
    """28: the three late examples' bodies on the card: the fork-join
    table to p = 1024 (28a), replicate vs upgrade vs cache with its JSQ
    plan and the flash crowd (28b), the live serving loop (28c)."""
    t28 = time.perf_counter()
    for label, name, sub in (
            ("28a", "torch_simulate_cluster", _cluster28),
            ("28b", "torch_replicated_sweep", _replicated28),
            ("28c", "torch_serve_search", _serve28)):
        t0 = time.perf_counter()
        sub(card, _load_example(name))
        print(f"  (phase {label}: {time.perf_counter() - t0:.1f} s)")
    print(f"  phase 28: {time.perf_counter() - t28:.1f} s [{card}]")


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
    # full float32 where float32 is asked for: no TF32 in products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    sample = phase_sample_kernel(card)
    launches, wall = phase_replicated(card)
    segment["launches"] = launches["random"]["maxplus_segment_scan"]
    jsq["launches"] = launches["jsq"]["jsq_route"]
    from repro_torch.core.cluster import ClusterSpec
    traced = phase_profile(
        card, wall, lambda: simulator.simulate_fork_join_batch(
            11, R * lam, params, N_CHUNKS * CHUNK, p=P,
            cluster=ClusterSpec(r=R, routing="random",
                                result_cache=RESULT_CACHE)),
        f"phase 6b: device time by kernel, replicated path (random, r = {R},"
        " result cache)")
    _kernel_share(traced, "maxplus_segment_scan_kernel", "segmented scan")
    mem7 = phase_memory_law(card)
    flash = phase_flash_kernel(card)
    decode = phase_decode_kernel(card)
    lm = phase_lm_server(card)
    flash["launches"] = lm["counts"]["flash_attention"]
    decode["launches"] = lm["counts"]["decode_attention"]
    phase_lm_profile(card, lm)
    phase_lm_correctness(card, lm)
    phase_planner(card, lm)
    del lm
    torch.cuda.empty_cache()
    from repro_torch.configs import xdeepfm
    from repro_torch.models import recsys as RS
    cfg = xdeepfm.FULL
    params = RS.init_xdeepfm(0, cfg)
    batches = _ctr_batches(cfg)
    bag = phase_bag_kernel(card, params["embedding"]["table"],
                           params["embedding"]["wide"], batches)
    cin = phase_cin_kernel(card, cfg)
    ctr = phase_ctr_serving(card, cfg, params, batches)
    bag["launches"] = ctr["counts"]["embedding_bag"]
    cin["launches"] = ctr["counts"]["cin_layer"]
    for b, wall in ((REC_P99, ctr["walls"][0]), (REC_BULK, ctr["walls"][-1])):
        ids, mask = next(x for x in batches if x[0].shape[0] == b)
        traced = phase_profile(
            card, wall, lambda: RS.xdeepfm_logits(params, cfg, ids, mask),
            f"phase 15b: device time by kernel, {cfg.name} logits at B = {b}")
        for kernel, what in (("embedding_bag_kernel", "embedding bag"),
                             ("cin_", "CIN")):
            _kernel_share(traced, kernel, what)
    del params, batches
    torch.cuda.empty_cache()
    phase_whatif(card)
    sample["launches"] = phase_sim_sweep(card)["jsq"]["sampled"][
        "service_sample"]
    phase_plans(card)
    phase_imbalance(card)
    t17 = time.perf_counter()
    fleet = _walled(phase_fleet_kernel, card)
    _walled(phase_masked_jsq, card)
    elastic = _walled(phase_elastic_fleet, card)
    fleet["launches"] = elastic["jsq"]["counts"]["fleet_scan"]
    _walled(phase_faulted_fleet, card)
    _walled(phase_plans17, card)
    _walled(phase_plans_wide, card)
    print(f"== phase 17: {time.perf_counter() - t17:.1f} s [{card}]")
    t18 = time.perf_counter()
    phase_observability(card, mem7)
    print(f"== phase 18: {time.perf_counter() - t18:.1f} s [{card}]")
    t19 = time.perf_counter()
    eng = phase_engine(card)
    print(f"  (phase 19a: {time.perf_counter() - t19:.1f} s)")
    t0 = time.perf_counter()
    phase_engine_calibration(card, eng)
    print(f"  (phase 19b: {time.perf_counter() - t0:.1f} s)")
    part, qterms = eng["part"], eng["qterms"]     # phase 20c's engine
    del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trace = phase_table5_roundtrip(card)
    print(f"  (phase 19c: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_scan_tangent(card, trace)
    print(f"  (phase 19d: {time.perf_counter() - t0:.1f} s)")
    print(f"== phase 19: {time.perf_counter() - t19:.1f} s [{card}]")
    del trace
    torch.cuda.empty_cache()
    t20 = time.perf_counter()
    phase_sharding(card, part, qterms)
    print(f"== phase 20: {time.perf_counter() - t20:.1f} s [{card}]")
    del part, qterms
    torch.cuda.empty_cache()
    t21 = time.perf_counter()
    phase_moe_serving(card)
    print(f"== phase 21: {time.perf_counter() - t21:.1f} s [{card}]")
    t22 = time.perf_counter()
    phase_mind(card)
    print(f"== phase 22: {time.perf_counter() - t22:.1f} s [{card}]")
    torch.cuda.empty_cache()
    t23 = time.perf_counter()
    phase_training(card)
    print(f"== phase 23: {time.perf_counter() - t23:.1f} s [{card}]")
    t24 = time.perf_counter()
    trained = phase_rec_training(card)
    bag["launches"] += trained["embedding_bag"]
    cin["launches"] += trained["cin_layer"]
    print(f"== phase 24: {time.perf_counter() - t24:.1f} s [{card}]")
    torch.cuda.empty_cache()
    t25 = time.perf_counter()
    phase_dimenet(card)
    print(f"== phase 25: {time.perf_counter() - t25:.1f} s [{card}]")
    torch.cuda.empty_cache()
    t26 = time.perf_counter()
    phase_dryrun(card)
    print(f"== phase 26: {time.perf_counter() - t26:.1f} s [{card}]")
    t27 = time.perf_counter()
    phase_staticcheck(card)
    print(f"== phase 27: {time.perf_counter() - t27:.1f} s [{card}]")
    t28 = time.perf_counter()
    phase_examples(card)
    print(f"== phase 28: {time.perf_counter() - t28:.1f} s [{card}]")
    print(json.dumps({"kernels": [scan, segment, jsq, flash, decode, bag,
                                  cin, fleet, sample]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
