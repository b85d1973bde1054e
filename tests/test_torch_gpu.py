"""Card-only tests of the port: the CUDA kernels and the engine on them.

Every test here carries the ``gpu`` marker and skips, with a reason,
where no CUDA device is present; whether one is present is decided inside
the ``cuda`` fixture, never at import.  This file imports torch and
repro_torch only (the card's machine has no JAX), so on the card run:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import qwen3_8b
from repro_torch.core import capacity, simulator, sweep
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.faults import FaultSpec
from repro_torch.configs import xdeepfm
from repro_torch.data.recsys_data import ctr_batch
from repro_torch.launch.elastic import AutoscalePolicy, autoscale_init
from repro_torch.kernels import hopper
from repro_torch.kernels.cin_fuse import kernel as cin_kernel
from repro_torch.kernels.cin_fuse import ops as cin_ops
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.embedding_bag import kernel as bag_kernel
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag import ref as bag_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fleet_scan import ops as fleet_ops
from repro_torch.kernels.jsq_route import ops as jsq_ops
from repro_torch.kernels.maxplus_scan import kernel, ops
from repro_torch.kernels.service_sample import kernel as sample_kernel
from repro_torch.kernels.service_sample import ops as sample_ops
from repro_torch.models import recsys as RS
from repro_torch.models import transformer as T
from repro_torch.serving.engine import LMServer

import torch_philox_model as philox_model

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_gpu.py`")
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    arr = torch.empty(shape, dtype=dtype, device=device).exponential_(
        generator=g).cumsum(-1)
    svc = torch.empty(shape, dtype=dtype, device=device).exponential_(
        generator=g)
    carry = torch.rand(shape[:-1], dtype=dtype, device=device,
                       generator=g) * 50.0
    return arr + svc, svc, carry


def _assert_rel(x, y, rtol):
    err = ((x - y).abs() / y.abs().clamp_min(1e-30)).max().item()
    assert err <= rtol, err


@pytest.mark.parametrize("shape", [(1, 1), (3, 1000), (37, 1025),
                                   (2, 3, 4097), (64, 4096), (5, 1023)])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("with_b", [True, False])
def test_kernel_matches_plain_scan(cuda, shape, dtype, rtol, seeded,
                                   with_b):
    """Both outputs within rtol of the plain scan; out_a alone (the
    simulator's call) bitwise the two-output kernel's out_a."""
    a, b, carry = _inputs(shape, dtype, cuda)
    if seeded:
        args = (a, b, carry, carry * 0.1)
        ka, kb = ops.maxplus_scan_seeded(*args, impl="cuda")
        oa, ob = ops.maxplus_scan_seeded(*args, impl="cuda", with_b=with_b)
        pa, pb = ops.maxplus_scan_seeded(*args, impl="torch")
    else:
        ka, kb = ops.maxplus_scan(a, b, impl="cuda")
        oa, ob = ops.maxplus_scan(a, b, impl="cuda", with_b=with_b)
        pa, pb = ops.maxplus_scan(a, b, impl="torch")
    torch.cuda.synchronize()
    _assert_rel(ka, pa, rtol)
    _assert_rel(kb, pb, rtol)
    assert torch.equal(oa, ka)
    assert (ob is None) if not with_b else torch.equal(ob, kb)


def test_auto_launches_the_kernel_once_per_call(cuda):
    a, b, _ = _inputs((4, 333), torch.float32, cuda)
    before = ops.launch_count()
    ops.maxplus_scan(a, b)
    ops.maxplus_scan(a[:, :0], b[:, :0])      # empty: nothing to launch
    assert ops.launch_count() == before + 1


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    a, b, carry = _inputs((4, 64), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.maxplus_scan_cuda(a.t().contiguous().t(), b)
    with pytest.raises(TypeError):
        kernel.maxplus_scan_cuda(a.half(), b.half())
    with pytest.raises(ValueError, match="one shape"):
        kernel.maxplus_scan_cuda(a, b[:, :10].contiguous())
    with pytest.raises(ValueError, match="carry_a"):
        kernel.maxplus_scan_cuda(a, b, carry[:2].contiguous())


@pytest.mark.parametrize("mode", ["exponential", "balanced", "cache"])
def test_engine_on_the_card_goes_through_the_kernel(cuda, mode):
    params = dataclasses.replace(capacity.TABLE5_PARAMS, p=16)
    n, chunk = 20_000, 4096
    ops.reset_launch_count()
    res = simulator.simulate_fork_join(7, 25.0, n, params, mode=mode,
                                       chunk_size=chunk)
    assert ops.launch_count() == 2 * -(-n // chunk)
    plain = simulator.simulate_fork_join(7, 25.0, n, params, mode=mode,
                                         chunk_size=chunk, impl="torch")
    _assert_rel(res.mean_response, plain.mean_response, 1e-4)
    _assert_rel(res.std_response, plain.std_response, 1e-4)


def test_card_equals_cpu_on_injected_draws(cuda):
    """Same float64 draws through the kernel on the card and through the
    plain scan on the CPU: association-order noise only."""
    g = torch.Generator().manual_seed(3)
    n, chunk, p = 9000, 2048, 8
    per_chunk = [(torch.empty(2, chunk, dtype=torch.float64).exponential_(
                      generator=g).numpy(),
                  torch.empty(2, chunk, dtype=torch.float64).exponential_(
                      generator=g).numpy(),
                  (torch.empty(2, p, chunk, dtype=torch.float64)
                   .exponential_(generator=g) * 0.03).numpy())
                 for _ in range(-(-n // chunk))]
    params = {"p": [p, p], "s_broker": [5e-4, 6e-4], "s_hit": [9e-3, 9e-3],
              "s_miss": [1e-2, 1e-2], "s_disk": [2.8e-2, 2.0e-2],
              "hit": [0.17, 0.3]}
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = simulator.simulate_fork_join_batch(
            0, torch.tensor([20.0, 24.0]),
            interop.server_params_from_numpy(params, device=dev,
                                             dtype=torch.float64),
            n, p=p, chunk_size=chunk, device=dev, dtype=torch.float64,
            draws=interop.draws_from_numpy(per_chunk, device=dev,
                                           dtype=torch.float64))
    for f in ("sum_response", "sumsq_response", "sum_broker",
              "sum_cluster", "sum_server"):
        _assert_rel(getattr(out["cuda"], f).cpu(), getattr(out["cpu"], f),
                    1e-10)
    # the histogram scale goes through float32 transcendental functions,
    # whose last ulp may differ between the card and the CPU
    _assert_rel(out["cuda"].hist_log_lo.cpu(), out["cpu"].hist_log_lo, 1e-6)
    moved = (out["cuda"].hist.cpu() - out["cpu"].hist).abs().sum() / 2
    assert moved <= 1e-3 * out["cpu"].hist.sum()


def _flags(shape, device, p_flag=0.05, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    f = torch.rand(shape, device=device, generator=g) < p_flag
    f[..., 0] = True
    return f


@pytest.mark.parametrize("shape,fshape", [
    ((1, 1), (1, 1)), ((3, 1000), (3, 1000)), ((37, 1025), (37, 1025)),
    ((2, 3, 4097), (2, 1, 4097)), ((64, 100, 512), (64, 1, 512)),
    ((5, 1023), (1023,))])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_segment_kernel_matches_plain_scan(cuda, shape, fshape, dtype, rtol):
    a, b, _ = _inputs(shape, dtype, cuda)
    f = _flags(fshape, cuda)
    before = ops.segment_launch_count()
    ka, kb = ops.maxplus_segment_scan(a, b, f, impl="cuda")
    pa, pb = ops.maxplus_segment_scan(a, b, f, impl="torch")
    torch.cuda.synchronize()
    assert ops.segment_launch_count() == before + 1
    _assert_rel(ka, pa, rtol)
    _assert_rel(kb, pb, rtol)


def _segment_flags(kind, shape, device, seed):
    if kind == "all":
        return torch.ones(shape, dtype=torch.bool, device=device)
    if kind == "none":
        return torch.zeros(shape, dtype=torch.bool, device=device)
    return _flags(shape, device, p_flag=0.05, seed=seed)


# lengths off the 128-element tile and off the 4-element vector (37, 777,
# 1000), a row shorter than a vector (1); per_flag 1 reads a flag row per
# row, p = 5 shares one between the 5 server rows of a scenario
@pytest.mark.parametrize("length", [1, 37, 777, 1000, 4096])
@pytest.mark.parametrize("kind", ["random", "all", "none"])
@pytest.mark.parametrize("per_flag", [1, 5])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_segment_kernel_out_a_only_lengths_and_flags(cuda, length, kind,
                                                     per_flag, dtype, rtol):
    shape = (3, 5, length)
    a, b, _ = _inputs(shape, dtype, cuda, seed=length)
    f = _segment_flags(kind, (3, 5 // per_flag, length), cuda, length)
    before = ops.segment_launch_count()
    ka, kb = ops.maxplus_segment_scan(a, b, f, impl="cuda")
    oa, none = ops.maxplus_segment_scan(a, b, f, impl="cuda", with_b=False)
    pa, pb = ops.maxplus_segment_scan(a, b, f, impl="torch")
    torch.cuda.synchronize()
    assert ops.segment_launch_count() == before + 2   # one a call
    assert none is None
    assert torch.equal(oa, ka)                        # bitwise
    _assert_rel(ka, pa, rtol)
    _assert_rel(kb, pb, rtol)


# a row start off 16 bytes (storage offset 1 element: every row takes the
# scalar path) and on 16 bytes (offset 4 floats / 2 doubles: the vector
# path) give the same bits as a fresh tensor
@pytest.mark.parametrize("offset", [1, 4])
@pytest.mark.parametrize("length", [1000, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_kernel_reads_rows_off_alignment(cuda, offset, length,
                                                 dtype):
    rows = 7
    a, b, _ = _inputs((rows, length), dtype, cuda, seed=offset)
    f = _flags((rows, length), cuda, seed=offset).to(torch.uint8)
    off = offset if dtype == torch.float32 else max(offset // 2, 1)

    def shifted(x):
        store = torch.empty(x.numel() + off, dtype=x.dtype, device=cuda)
        view = store[off:].view(x.shape)
        view.copy_(x)
        return view

    sa, sb = shifted(a), shifted(b)
    sf = torch.empty(f.numel() + 1, dtype=torch.uint8, device=cuda)[1:]
    sf = sf.view(f.shape)
    sf.copy_(f)
    assert sa.is_contiguous() and (sa.data_ptr() % 16 == 0) == (
        off * a.element_size() % 16 == 0)
    ka, kb = kernel.maxplus_segment_scan_cuda(a, b, f)
    va, vb = kernel.maxplus_segment_scan_cuda(sa, sb, sf)
    wa, _ = kernel.maxplus_segment_scan_cuda(sa, sb, sf, with_b=False)
    torch.cuda.synchronize()
    assert torch.equal(va, ka) and torch.equal(vb, kb)
    assert torch.equal(wa, ka)


# p off a multiple of 32 at r = 16 and 13 in registers (16, 40; 13, 70
# in float32); past the register budget, the shared-memory variant, whose
# server loops diverge before its warp max (16, 200; 13, 70 in float64)
@pytest.mark.parametrize("r,p,n", [(4, 100, 300), (3, 5, 1000), (1, 7, 33),
                                   (16, 40, 65), (16, 200, 70),
                                   (13, 70, 129)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_jsq_kernel_matches_plain_loop(cuda, r, p, n, dtype):
    g = torch.Generator(device=cuda).manual_seed(r * 1000 + p)
    s = 6
    w = torch.rand((s, r, p), dtype=dtype, device=cuda, generator=g)
    w[0] = 0.0                                 # idle: ties everywhere
    gaps = torch.empty((s, n), dtype=dtype, device=cuda).exponential_(
        generator=g) * 0.3 / r
    svc = torch.empty((s, p, n), dtype=dtype, device=cuda).exponential_(
        generator=g)
    live = (torch.rand((s, n), device=cuda, generator=g) > 0.2).to(dtype)
    before = jsq_ops.launch_count()
    kc, kw = jsq_ops.jsq_route(w, gaps, svc, live, impl="cuda")
    pc, pw = jsq_ops.jsq_route(w, gaps, svc, live, impl="torch")
    torch.cuda.synchronize()
    assert jsq_ops.launch_count() == before + 1
    assert torch.equal(kc, pc)
    assert torch.equal(kw, pw)


@pytest.mark.parametrize("routing", ["random", "jsq"])
def test_replicated_engine_goes_through_both_kernels(cuda, routing):
    params = dataclasses.replace(capacity.TABLE5_PARAMS, p=16)
    n, chunk, r = 12_000, 4096, 3
    cluster = ClusterSpec(r=r, routing=routing, result_cache=(0.2, 2e-3))
    ops.reset_launch_count()
    ops.reset_segment_launch_count()
    jsq_ops.reset_launch_count()
    res = simulator.simulate_fork_join(7, 3 * 25.0, n, params, tap_size=64,
                                       cluster=cluster, chunk_size=chunk)
    n_chunks = -(-n // chunk)
    assert ops.launch_count() == 0
    assert ops.segment_launch_count() == 3 * n_chunks
    assert jsq_ops.launch_count() == (n_chunks if routing == "jsq" else 0)
    plain = simulator.simulate_fork_join(7, 3 * 25.0, n, params,
                                         tap_size=64, cluster=cluster,
                                         chunk_size=chunk, impl="torch")
    _assert_rel(res.mean_response, plain.mean_response, 1e-4)
    masked = simulator.simulate_fork_join(
        7, 3 * 25.0, n, params, tap_size=64, chunk_size=chunk,
        cluster=dataclasses.replace(cluster, replica_impl="masked"))
    _assert_rel(res.mean_response, masked.mean_response, 1e-4)
    assert int(torch.isfinite(res.tap_response).sum()) == 64


@pytest.mark.parametrize("routing", ["random", "jsq"])
def test_simulated_sweep_on_the_card_matches_plain_path(cuda, routing):
    """A small simulated sweep (2 p x 2 r dispatches, the result cache)
    on the card through the kernels against impl="torch" on the same
    draws; each dispatch launches its scans (and JSQ its router)."""
    grid = sweep.SweepGrid.build(
        lam=[20.0, 40.0], p=[8.0, 16.0], cpu=[1.0, 2.0], hit=[0.17],
        base=capacity.TABLE5_PARAMS, broker_from_p=False, r=[1.0, 3.0],
        result_cache=(0.2, 2e-3), device=cuda)
    n, chunk = 8192, 2048
    kw = dict(n_queries=n, chunk_size=chunk,
              cluster=ClusterSpec(routing=routing))
    ops.reset_launch_count()
    ops.reset_segment_launch_count()
    jsq_ops.reset_launch_count()
    kern = sweep.sweep_simulated(grid, 3, **kw)
    n_chunks = n // chunk
    # per p: the r = 1 dispatch scans cache, broker and servers (3 plain
    # scans a chunk), the r = 3 one the same levels segmented
    assert ops.launch_count() == 2 * 3 * n_chunks
    assert ops.segment_launch_count() == 2 * 3 * n_chunks
    assert jsq_ops.launch_count() == (2 * n_chunks if routing == "jsq"
                                      else 0)
    plain = sweep.sweep_simulated(grid, 3, impl="torch", **kw)
    assert kern.mean.shape == grid.shape
    _assert_rel(kern.mean, plain.mean, 1e-4)
    _assert_rel(kern.quantile(0.95), plain.quantile(0.95), 1e-2)


# ------------------------------------------------------------ the fleet
_FLEET_FAULT = FaultSpec(outages=((0, 2.0, 5.0), (3, 1.0, 9.0)),
                         mtbf_seconds=3.0, mttr_seconds=0.5)
_FLEET_POLICY = AutoscalePolicy(min_r=1, max_r=4, target_utilization=0.6,
                                decision_interval_seconds=0.4,
                                stabilization_intervals=2,
                                queue_trigger_seconds=0.5)


def _fleet_inputs(s, n, r, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    gaps = torch.empty((s, n), dtype=dtype, device=device).exponential_(
        generator=g) * 0.02
    # ~2.5 r server-seconds a second against 4.8 a replica at the
    # target: the policy scales to ~r / 2
    dem = torch.empty((s, n), dtype=dtype, device=device).exponential_(
        generator=g) * 0.05 * r
    u = torch.rand((s, n, r), dtype=dtype, device=device, generator=g)
    upf = torch.rand((s, n), dtype=dtype, device=device, generator=g)
    return gaps, dem, u, upf


def _tile_windows(t_arr, n):
    """32 outage windows (replica w of window w, reduced mod r), each from
    scenario 0's arrival at a tile boundary (start inclusive) to one up
    to a tile later (end exclusive), with the MTBF/MTTR chain."""
    t0 = t_arr[0].double().cpu()
    out = []
    for w in range(32):
        i = min(32 * (w % 5), n - 1)
        j = min(i + 32 * (w % 2) + w, n - 1)
        start, end = float(t0[i]), float(t0[j])
        out.append((w, start, end if end > start else start + 0.05))
    return dataclasses.replace(_FLEET_FAULT, outages=tuple(out))


def _fleet_kwargs(what, s, n, r, dtype, device, seed):
    """gaps and the fleet scan's keywords for one case (see below)."""
    gaps, dem, u, upf = _fleet_inputs(s, n, r, dtype, device, seed=seed)
    t_arr = torch.cumsum(gaps, -1) + 0.5
    interval = {"every": 1e-30, "never": 1e9}.get(what, 0.4)
    pol = None if what == "fault" else dataclasses.replace(
        _FLEET_POLICY, max_r=max(r, 1), min_r=1,
        decision_interval_seconds=interval)
    fault = {"fault": _FLEET_FAULT, "both": _FLEET_FAULT,
             "every": _FLEET_FAULT, "never": _FLEET_FAULT,
             "windows": _tile_windows(t_arr, n)}.get(what)
    kw = dict(t_arr=t_arr, u=u, demand=dem, n_valid=n - 5, fault=fault,
              policy=pol, p=8, r=r,
              up_frac=upf if what == "upf" else None,
              up_state=torch.ones((s, r), dtype=torch.int32, device=device),
              as_state=None if pol is None else autoscale_init(
                  pol, s, dtype, device=device))
    return gaps, kw


def _fleet_equal(k, pl, kw):
    """The kernel's result equals the plain loop's: masks, counts and
    integer carries exactly, float carries to 1e-6."""
    k_up, k_n, k_st, k_as = k
    p_up, p_n, p_st, p_as = pl
    if kw["fault"] is not None:
        assert torch.equal(k_up, p_up) and torch.equal(k_st, p_st)
    if kw["policy"] is not None:
        assert torch.equal(k_n, p_n)
        for kt, pt in zip(k_as, p_as):
            if kt.dtype == torch.int32:
                assert torch.equal(kt, pt)
            else:
                _assert_rel(kt, pt, 1e-6)


# r = 1, 4 and 16 (the lanes a warp carries) and 3, 8; n on and off a
# tile of 32 queries, under one (20), a whole number of tiles (128), and
# n_valid (n - 5) inside the last tile; the ways the engine calls it:
# faults alone, the policy alone, both (the controller reading the mask's
# count), the policy with an explicit up fraction (autoscale_scan's); and
# both with a decision on every step, on none, and under 32 windows whose
# edges lie on tile boundaries
@pytest.mark.parametrize("r,n", [(1, 33), (4, 300), (16, 257), (3, 20),
                                 (8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("what", ["fault", "policy", "both", "upf", "every",
                                  "never", "windows"])
def test_fleet_kernel_matches_plain_loop(cuda, r, n, dtype, what):
    s = 6
    gaps, kw = _fleet_kwargs(what, s, n, r, dtype, cuda, seed=r + n)
    before = fleet_ops.launch_count()
    k = fleet_ops.fleet_scan(gaps, impl="cuda", **kw)
    pl = fleet_ops.fleet_scan(gaps, impl="torch", **kw)
    torch.cuda.synchronize()
    assert fleet_ops.launch_count() == before + 1
    _fleet_equal(k, pl, kw)
    p_up, p_n = pl[0], pl[1]
    if kw["fault"] is not None:             # (32 windows may down all)
        assert bool((~p_up).any()) and (what == "windows" or p_up.any())
    if what == "never":
        assert bool((p_n == kw["as_state"][0][:, None]).all())
    elif kw["policy"] is not None and n > 32:   # (20 queries: ~0.4 s)
        assert r == 1 or int(p_n.min()) < int(p_n.max())


@pytest.mark.parametrize("r", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("what", ["both", "upf"])
def test_fleet_kernel_chunks_chain_like_one_call(cuda, r, dtype, what):
    """Two calls, the second from the first's carries (split inside a
    tile), equal one call over the whole stream, and the plain loop."""
    s, n, cut = 6, 300, 150
    gaps, kw = _fleet_kwargs(what, s, n, r, dtype, cuda, seed=r)
    whole = fleet_ops.fleet_scan(gaps, impl="cuda", **kw)
    _fleet_equal(whole, fleet_ops.fleet_scan(gaps, impl="torch", **kw), kw)
    first = fleet_ops.fleet_scan(
        gaps[:, :cut], impl="cuda",
        **{**kw, "t_arr": kw["t_arr"][:, :cut], "u": kw["u"][:, :cut],
           "demand": kw["demand"][:, :cut], "n_valid": cut,
           "up_frac": None if kw["up_frac"] is None
           else kw["up_frac"][:, :cut]})
    second = fleet_ops.fleet_scan(
        gaps[:, cut:], impl="cuda",
        **{**kw, "t_arr": kw["t_arr"][:, cut:], "u": kw["u"][:, cut:],
           "demand": kw["demand"][:, cut:], "n_valid": n - 5 - cut,
           "up_frac": None if kw["up_frac"] is None
           else kw["up_frac"][:, cut:],
           "up_state": first[2], "as_state": first[3]})
    torch.cuda.synchronize()
    if kw["fault"] is not None:
        assert torch.equal(torch.cat([first[0], second[0]], 1), whole[0])
        assert torch.equal(second[2], whole[2])
    assert torch.equal(torch.cat([first[1], second[1]], 1), whole[1])
    for a, b in zip(second[3], whole[3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("r,p,n", [(4, 100, 300), (3, 5, 1000), (1, 7, 33),
                                   (16, 40, 65), (16, 200, 70),
                                   (13, 70, 129)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("masks", ["n_act", "up", "both"])
def test_masked_jsq_kernel_matches_plain_loop(cuda, r, p, n, dtype, masks):
    g = torch.Generator(device=cuda).manual_seed(r * 1000 + p + 7)
    s = 6
    w = torch.rand((s, r, p), dtype=dtype, device=cuda, generator=g)
    gaps = torch.empty((s, n), dtype=dtype, device=cuda).exponential_(
        generator=g) * 0.3 / r
    svc = torch.empty((s, p, n), dtype=dtype, device=cuda).exponential_(
        generator=g)
    live = (torch.rand((s, n), device=cuda, generator=g) > 0.2).to(dtype)
    n_act = up = None
    if masks in ("n_act", "both"):
        n_act = torch.randint(1, r + 1, (s, n), generator=g, device=cuda,
                              dtype=torch.int32)
    if masks in ("up", "both"):
        up = torch.rand((s, n, r), device=cuda, generator=g) < 0.7
        up[1, : n // 3] = False                # no replica up: unavailable
    before = jsq_ops.launch_count()
    k = jsq_ops.jsq_route(w, gaps, svc, live, n_act=n_act, up=up,
                          impl="cuda")
    pl = jsq_ops.jsq_route(w, gaps, svc, live, n_act=n_act, up=up,
                           impl="torch")
    torch.cuda.synchronize()
    assert jsq_ops.launch_count() == before + 1
    assert len(k) == len(pl) == (4 if up is not None else 2)
    for kt, pt in zip(k, pl):
        assert torch.equal(kt, pt)
    if up is not None and r > 1:
        assert bool(pl[2].any()) and bool(pl[3].any())


# past 16 replicas: the wide instances (r = 17, 32, 64, 256 at p = 100;
# 256 x 100 in float64 fills most of a block's shared memory)
@pytest.mark.parametrize("r,n", [(17, 300), (32, 257), (64, 129),
                                 (256, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("masks", [None, "n_act", "up", "both"])
def test_wide_jsq_kernel_matches_plain_loop(cuda, r, n, dtype, masks):
    g = torch.Generator(device=cuda).manual_seed(r * 31 + n)
    s, p = 4, 100
    w = torch.rand((s, r, p), dtype=dtype, device=cuda, generator=g)
    w[0] = 0.0                                 # idle: ties everywhere
    w[1, ::3] = 0.0                            # some replicas idle
    gaps = torch.empty((s, n), dtype=dtype, device=cuda).exponential_(
        generator=g) * 0.05 / r
    svc = torch.empty((s, p, n), dtype=dtype, device=cuda).exponential_(
        generator=g)
    live = (torch.rand((s, n), device=cuda, generator=g) > 0.2).to(dtype)
    n_act = up = None
    if masks in ("n_act", "both"):
        n_act = torch.randint(1, r + 1, (s, n), generator=g, device=cuda,
                              dtype=torch.int32)
    if masks in ("up", "both"):
        up = torch.rand((s, n, r), device=cuda, generator=g) < 0.7
        up[1, : n // 3] = False                # no replica up: unavailable
    before = jsq_ops.launch_count()
    k = jsq_ops.jsq_route(w, gaps, svc, live, n_act=n_act, up=up,
                          impl="cuda")
    pl = jsq_ops.jsq_route(w, gaps, svc, live, n_act=n_act, up=up,
                           impl="torch")
    torch.cuda.synchronize()
    assert jsq_ops.launch_count() == before + 1
    for kt, pt in zip(k, pl):
        assert torch.equal(kt, pt)
    assert int(pl[0].max()) >= 16             # past the narrow range
    if up is not None:
        assert bool(pl[2].any()) and bool(pl[3].any())


def _many_windows(t_arr, n, count):
    """``count`` outage windows (replica 5 w + 1, reduced mod r), each
    from scenario 0's arrival at a tile boundary to one up to a tile
    later."""
    t0 = t_arr[0].double().cpu()
    out = []
    for w in range(count):
        i = min(32 * (w % 7), n - 1)
        j = min(i + 32 * (w % 2) + w % 29, n - 1)
        start, end = float(t0[i]), float(t0[j])
        out.append((5 * w + 1, start, end if end > start else start + 0.05))
    return dataclasses.replace(_FLEET_FAULT, outages=tuple(out))


# r = 17, 32, 64, 256 (one to eight groups of 32), and r = 4 with 64
# windows (the wide instance for its windows alone); the ways the engine
# calls it, and 64 windows at every r
@pytest.mark.parametrize("r,n", [(17, 300), (32, 257), (64, 129),
                                 (256, 70), (4, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("what", ["fault", "policy", "both", "upf",
                                  "windows"])
def test_wide_fleet_kernel_matches_plain_loop(cuda, r, n, dtype, what):
    s = 6
    gaps, kw = _fleet_kwargs("both" if what == "windows" else what, s, n,
                             r, dtype, cuda, seed=r + n)
    if what == "windows" or r == 4:
        kw["fault"] = _many_windows(kw["t_arr"], n, 64)
    before = fleet_ops.launch_count()
    k = fleet_ops.fleet_scan(gaps, impl="cuda", **kw)
    pl = fleet_ops.fleet_scan(gaps, impl="torch", **kw)
    torch.cuda.synchronize()
    assert fleet_ops.launch_count() == before + 1
    _fleet_equal(k, pl, kw)
    if kw["fault"] is not None:
        assert bool((~pl[0]).any()) and bool(pl[0].any())


@pytest.mark.parametrize("routing", ["random", "jsq"])
def test_plan_capacity_past_16_replicas(cuda, routing):
    """plan_capacity(survive_faults=1, simulate=True) at 500 qps on Table
    5's hardware needs 19 + 1 replicas: the faulted cross-check runs the
    fleet scan (and, under JSQ, the router) at r >= 20 on the card."""
    from repro_torch.kernels.fleet_scan import kernel as fleet_kernel
    fleet_ops.reset_launch_count()
    jsq_ops.reset_launch_count()
    plan = capacity.plan_capacity(
        capacity.TABLE5_PARAMS, 500.0, 0.9, simulate=True,
        survive_faults=1, cluster=ClusterSpec(routing=routing),
        n_queries=20_000)
    assert plan.n_replicas > fleet_kernel.NARROW_REPLICAS
    assert plan.response_faulted_p95_ms is not None
    assert np.isfinite(plan.response_faulted_p95_ms)
    assert fleet_ops.launch_count() > 0
    assert (jsq_ops.launch_count() > 0) == (routing == "jsq")


@pytest.mark.parametrize("routing,r", [("round_robin", 1), ("jsq", 3),
                                       ("random", 3)])
def test_telemetry_on_the_card_matches_the_cpu(cuda, routing, r):
    """A telemetry run on the card against the same run on the CPU, on
    the same draws in float64 (the result cache and all fault channels
    at r > 1): counts and routing exact, float sums to 1e-12 of the bin
    plus the largest bin; the base statistics unchanged by telemetry."""
    from repro_torch.obs import TelemetrySpec
    params = dataclasses.replace(capacity.TABLE5_PARAMS, p=16)
    n_scen, chunk, n_chunks, f64 = 3, 1024, 4, torch.float64
    fault = (FaultSpec(outages=((0, 5.0, 40.0),), mtbf_seconds=20.0,
                       mttr_seconds=4.0, broker_timeout_seconds=0.5,
                       quorum_k=15) if r > 1 else None)
    cl = ClusterSpec(r=r, routing=routing, result_cache=(0.2, 2e-3),
                     fault=fault)
    vp = simulator._vec_params(params, cuda, f64)
    hit = torch.full((n_scen,), 0.2, dtype=f64, device=cuda)
    per_chunk = []
    for c in range(n_chunks):
        base = simulator.chunk_random_draws(7, c, n_scen, chunk, 16, vp,
                                            "exponential", device=cuda,
                                            dtype=f64)
        side = simulator.chunk_side_draws(
            7, c, n_scen, chunk, cache_hit=hit, device=cuda, dtype=f64,
            route_r=r if routing == "random" else None,
            fault_r=r if fault is not None else None)
        per_chunk.append((*base, side))
    on_cpu = [tuple(t.cpu() for t in d[:3])
              + ({k: v.cpu() for k, v in d[3].items()},) for d in per_chunk]
    lam = torch.tensor([20.0, 40.0, 60.0], dtype=f64) * r
    spec = TelemetrySpec(n_bins=8)
    kw = dict(p=16, chunk_size=chunk, cluster=cl, dtype=f64)
    card = simulator.simulate_fork_join_batch(
        7, lam.to(cuda), params, n_chunks * chunk, telemetry=spec,
        draws=lambda c: per_chunk[c], device=cuda, **kw)
    plain = simulator.simulate_fork_join_batch(
        7, lam.to(cuda), params, n_chunks * chunk,
        draws=lambda c: per_chunk[c], device=cuda, **kw)
    host = simulator.simulate_fork_join_batch(
        7, lam, params, n_chunks * chunk, telemetry=spec,
        draws=lambda c: on_cpu[c], device="cpu", **kw)
    torch.cuda.synchronize()
    for f in ("count", "sum_response", "hist"):
        assert torch.equal(getattr(card, f), getattr(plain, f))
    for f in dataclasses.fields(card.timeline):
        a, b = getattr(card.timeline, f.name), getattr(host.timeline, f.name)
        assert (a is None) == (b is None), f.name
        if a is None:
            continue
        a = a.cpu()
        if f.name in ("count", "replica_count", "up_sum", "spill_sum"):
            assert torch.equal(a, b), f.name
        else:
            floor = 1e-12 * float(b.abs().max())
            assert bool(((a - b).abs() <= 1e-12 * b.abs() + floor).all()), \
                f.name
    assert float(card.timeline.count.sum()) == n_scen * n_chunks * chunk


@pytest.mark.parametrize("routing", ["round_robin", "random", "jsq"])
def test_elastic_faulted_engine_goes_through_the_fleet_scan(cuda, routing):
    """An autoscaled, faulted run on the card: one fleet scan a chunk,
    the segmented scans (and JSQ) as before, and the plain path's
    statistics on the same draws."""
    params = dataclasses.replace(capacity.TABLE5_PARAMS, p=16)
    n, chunk = 8192, 2048
    fault = FaultSpec(outages=((0, 5.0, 40.0),), mtbf_seconds=20.0,
                      mttr_seconds=4.0, broker_timeout_seconds=0.5,
                      quorum_k=15, hedge_after_seconds=0.4)
    pol = AutoscalePolicy(min_r=1, max_r=4, decision_interval_seconds=2.0)
    cluster = ClusterSpec(routing=routing, result_cache=(0.2, 2e-3),
                          autoscale=pol, fault=fault)
    ops.reset_launch_count()
    ops.reset_segment_launch_count()
    jsq_ops.reset_launch_count()
    fleet_ops.reset_launch_count()
    res = simulator.simulate_fork_join(7, 60.0, n, params, cluster=cluster,
                                       chunk_size=chunk)
    n_chunks = n // chunk
    assert fleet_ops.launch_count() == n_chunks
    assert ops.launch_count() == 0
    assert ops.segment_launch_count() == 3 * n_chunks
    assert jsq_ops.launch_count() == (n_chunks if routing == "jsq" else 0)
    plain = simulator.simulate_fork_join(7, 60.0, n, params,
                                         cluster=cluster, chunk_size=chunk,
                                         impl="torch")
    for name in ("mean_response", "mean_active_replicas", "spill_fraction",
                 "availability", "degraded_fraction"):
        _assert_rel(getattr(res, name), getattr(plain, name), 1e-4)
    assert 1.0 <= float(res.mean_active_replicas) <= 4.0


# ------------------------------------------------------- service sampling

def _sampling_params(n_scen, device, seed=3):
    """(S,) float32 fields of the cache mixture, each scenario its own."""
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return (lo + (hi - lo) * torch.rand(n_scen, generator=g,
                                            dtype=torch.float64)).to(device)
    return simulator._vec_params(dataclasses.replace(
        capacity.TABLE5_PARAMS, s_hit=u(1e-3, 9e-3), s_miss=u(5e-3, 2e-2),
        s_disk=u(1e-3, 3e-2), hit=u(0.05, 0.95)), device, torch.float32)


@pytest.mark.parametrize("mode", ["cache", "exponential"])
@pytest.mark.parametrize("shape", [
    (256, 100, 4096),       # the benchmark's chunk
    (5, 37, 6007),          # numel above 4T and no multiple of it
    (2, 3, 50),             # a grid below the card's full one
    (1, 100, 4096),         # one scenario
    (128, 1024, 4096),      # 2^29: the largest draw torch makes at once
    (129, 1024, 4096),      # past it: two pieces, at their own offsets
    (257, 1024, 4096),      # four pieces, the split taken twice
])
def test_service_sampler_kernel_is_the_plain_draws(cuda, mode, shape):
    """The kernel's services equal the plain draws' bit for bit (torch's
    own generators, the broadcast products, the mixture), in one launch a
    piece of torch's draw (one up to 2^29 elements)."""
    n_scen, p, n = shape
    params = _sampling_params(n_scen, cuda)
    seed = simulator._mix(2026, n_scen, p, n)
    props = torch.cuda.get_device_properties(cuda)
    pieces = len(sample_kernel.draw_launches(
        n_scen * p * n, props.multi_processor_count,
        props.max_threads_per_multi_processor))
    assert (pieces == 1) == (n_scen * p * n <= 2 ** 29)
    before, plain = sample_ops.launch_count(), sample_ops.plain_count()
    got = simulator.sample_service_times_batch(seed, n_scen, n, p, params,
                                               mode, device=cuda,
                                               impl="cuda")
    assert sample_ops.launch_count() == before + pieces
    assert sample_ops.plain_count() == plain
    want = simulator.sample_service_times_batch(seed, n_scen, n, p, params,
                                                mode, device=cuda,
                                                impl="torch")
    assert sample_ops.launch_count() == before + pieces
    assert sample_ops.plain_count() == plain + 1
    assert got.shape == want.shape == shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("numel", [300, 1_111_295])
def test_philox_layout_model_is_torch_on_the_card(cuda, numel):
    """The numpy model of torch's CUDA draws (Philox4x32-10 in torch's
    grid-stride layout) gives ``torch.rand`` bit for bit and
    ``exponential_`` within ``__logf``'s error (absolute 2^-21.41 on
    [0.5, 2], 3 ulp elsewhere): a torch whose layout moved fails here by
    name."""
    props = torch.cuda.get_device_properties(cuda)
    grid = sample_kernel.grid_size(numel, props.multi_processor_count,
                                   props.max_threads_per_multi_processor)
    seed = simulator._mix(31, numel)
    u = simulator._unit_uniform(seed, (numel,), cuda, torch.float32)
    assert np.array_equal(u.cpu().numpy(),
                          philox_model.torch_rand(seed, numel, grid))
    e = simulator._unit_exponential(seed, (numel,), cuda, torch.float32)
    np.testing.assert_allclose(
        e.cpu().numpy(), philox_model.torch_exponential(seed, numel, grid),
        rtol=2.0 ** -20, atol=2.0 ** -21)


@pytest.mark.parametrize("numel", [2 ** 29 + 2 ** 22, 2 ** 30 + 2 ** 22 + 9])
def test_philox_split_layout_model_is_torch_on_the_card(cuda, numel):
    """Past 2^29 elements torch draws in pieces (`kernel.draw_launches`):
    the model gives ``torch.rand`` bit for bit at each piece's first and
    last 2,000 elements and at 20,000 elements drawn at random."""
    props = torch.cuda.get_device_properties(cuda)
    launches = sample_kernel.draw_launches(
        numel, props.multi_processor_count,
        props.max_threads_per_multi_processor)
    assert len(launches) > 1
    edges = [np.arange(a, a + 2000) for a, n, _, _ in launches] + [
        np.arange(a + n - 2000, a + n) for a, n, _, _ in launches]
    rng = np.random.default_rng(numel)
    index = np.concatenate(edges + [rng.integers(0, numel, 20_000)])
    seed = simulator._mix(37, numel)
    u = simulator._unit_uniform(seed, (numel,), cuda, torch.float32)
    got = u[torch.as_tensor(index, device=cuda)].cpu().numpy()
    assert np.array_equal(got, philox_model.torch_rand_at(seed, index,
                                                          launches))


def test_engine_services_from_the_kernel_are_the_plain_draws(cuda):
    """A cache-mode dispatch on the card: the sampler launches once a
    chunk, and every field equals the same dispatch fed the plain draws.
    The engine's ``impl="torch"`` samples with the plain draws, and
    ``impl="cuda"`` in float64 too, without an error."""
    n_scen, p, chunk, n_chunks = 6, 16, 1024, 4
    params = dataclasses.replace(_sampling_params(n_scen, cuda),
                                 s_broker=torch.full((n_scen,), 2e-4,
                                                     device=cuda))
    vp = simulator._vec_params(params, cuda, torch.float32)
    lam = torch.linspace(5.0, 15.0, n_scen, device=cuda)
    kw = dict(p=p, mode="cache", chunk_size=chunk, device=cuda)
    before = sample_ops.launch_count()
    card = simulator.simulate_fork_join_batch(11, lam, params,
                                              n_chunks * chunk, **kw)
    assert sample_ops.launch_count() == before + n_chunks
    plain = simulator.simulate_fork_join_batch(
        11, lam, params, n_chunks * chunk,
        draws=lambda c: simulator.chunk_random_draws(
            11, c, n_scen, chunk, p, vp, "cache", device=cuda,
            impl="torch"), **kw)
    assert sample_ops.launch_count() == before + n_chunks
    for impl, dtype in (("torch", torch.float32), ("cuda", torch.float64)):
        plain_calls = sample_ops.plain_count()
        simulator.simulate_fork_join_batch(11, lam, params, n_chunks * chunk,
                                           impl=impl, dtype=dtype, **kw)
        assert sample_ops.launch_count() == before + n_chunks, impl
        assert sample_ops.plain_count() == plain_calls + n_chunks, impl
    for f in dataclasses.fields(card):
        a, b = getattr(card, f.name), getattr(plain, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


# ------------------------------------------------------------ attention
# The largest relative L2 error of one output row (one query and head)
# against the plain version's float32 output on the same values, as
# chip_smoke.py holds the kernels: bfloat16 rounds at 2^-8 (1e-2 holds the
# output's and the probabilities' rounding, and fails a dropped split or
# K tile); float32's 1e-4 fails anything rounded to bfloat16 on the way.
ATTN_ROW_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _attn_close(out, expect, dtype):
    err = ((out.float() - expect).norm(dim=-1)
           / expect.norm(dim=-1)).max().item()
    assert err <= ATTN_ROW_RTOL[dtype], err


def _f32(*xs):
    return (x.float() for x in xs)


def _randn(shape, dtype, device, gen):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


# S not a multiple of the tiles (1000, 1025, 77, 8), G in 1, 2, 3, 4, 6,
# 8, 12, 20, 64 (3, 6, 12, 20 leave rows of a 64-row tile idle; 64 is one
# position a tile), Sq != Sk both ways, causal and not, every D of
# HEAD_DIMS (8 a zero-filled 16-wide band)
@pytest.mark.parametrize("d", fa_kernel.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kv,causal", [
    (1, 1000, 1000, 8, 2, True), (2, 77, 77, 4, 2, True),
    (1, 256, 256, 32, 8, True), (2, 8, 8, 8, 1, True),
    (1, 40, 100, 8, 8, False), (1, 1025, 1025, 16, 2, True),
    (1, 100, 40, 8, 4, True), (2, 300, 300, 12, 4, True),
    (1, 333, 333, 12, 2, True), (1, 200, 200, 24, 2, True),
    (1, 50, 90, 12, 1, False), (1, 90, 90, 40, 2, True),
    (1, 130, 130, 64, 1, True)])
def test_flash_kernel_matches_plain_version(cuda, d, dtype, b, sq, sk, h,
                                            kv, causal):
    g = torch.Generator(device=cuda).manual_seed(d + sq)
    q = _randn((b, sq, h, d), dtype, cuda, g)
    k = _randn((b, sk, kv, d), dtype, cuda, g)
    v = _randn((b, sk, kv, d), dtype, cuda, g)
    before = fa_ops.launch_count()
    out = fa_ops.flash_attention(q, k, v, causal=causal, impl="cuda")
    expect = fa_ops.flash_attention(*_f32(q, k, v), causal=causal,
                                    impl="torch")
    torch.cuda.synchronize()
    assert fa_ops.launch_count() == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    _attn_close(out, expect, dtype)


@pytest.mark.parametrize("d", fa_kernel.HEAD_DIMS)
def test_flash_kernel_reads_strided_views(cuda, d):
    """q, k, v as views of one fused projection, as a model may hold them."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = _randn((2, 300, 6, d), torch.bfloat16, cuda, g)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:5], qkv[:, :, 5:6]
    out = fa_ops.flash_attention(q, k, v, impl="cuda")
    expect = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), impl="cuda")
    assert torch.equal(out, expect)


# G in 1, 2, 3, 4, 6, 8, 12, 16; D = 8 through a zero-filled band (bf16)
@pytest.mark.parametrize("d", [8, 16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,length", [
    (8, 4096, 32, 8, 2100), (2, 1024, 8, 2, 0), (2, 512, 16, 8, 511),
    (1, 3000, 4, 4, 2999), (3, 100, 8, 1, 57), (2, 700, 12, 4, 333),
    (1, 300, 12, 2, 299), (2, 1000, 24, 2, 999), (1, 40, 16, 1, 5)])
def test_decode_kernel_matches_plain_version(cuda, d, dtype, b, s, h, kv,
                                             length):
    g = torch.Generator(device=cuda).manual_seed(d + s + length)
    q = _randn((b, 1, h, d), dtype, cuda, g)
    k = _randn((b, s, kv, d), dtype, cuda, g)
    v = _randn((b, s, kv, d), dtype, cuda, g)
    before = dec_ops.launch_count()
    out = dec_ops.decode_attention(q, k, v, length, impl="cuda")
    expect = dec_ops.decode_attention(*_f32(q, k, v), length, impl="torch")
    torch.cuda.synchronize()
    assert dec_ops.launch_count() == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    _attn_close(out, expect, dtype)


def test_decode_kernel_on_two_streams_at_once(cuda):
    """Calls in flight on two streams take their own merge tickets: each
    gives what it gives alone (several splits a row, so rows merge)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    args = [(_randn((8, 1, 32, 128), torch.bfloat16, cuda, g),
             _randn((8, 4096, 8, 128), torch.bfloat16, cuda, g),
             _randn((8, 4096, 8, 128), torch.bfloat16, cuda, g))
            for _ in range(2)]
    alone = [dec_ops.decode_attention(*a, 4000, impl="cuda") for a in args]
    streams = [torch.cuda.Stream(cuda) for _ in args]
    torch.cuda.synchronize()
    outs = []
    for _ in range(20):
        for stream, a in zip(streams, args):
            with torch.cuda.stream(stream):
                outs.append(dec_ops.decode_attention(*a, 4000, impl="cuda"))
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        assert torch.equal(out, alone[i % 2])


def test_decode_kernel_never_reads_past_length(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = _randn((2, 1, 8, 128), torch.bfloat16, cuda, g)
    cache = _randn((3, 2, 600, 2, 128), torch.bfloat16, cuda, g)
    k, v = cache[1], cache[2]             # one layer of an (L, ...) cache
    clean = dec_ops.decode_attention(q, k, v, 400, impl="cuda")
    k[:, 401:] = float("nan")
    v[:, 401:] = float("nan")
    assert torch.equal(dec_ops.decode_attention(q, k, v, 400, impl="cuda"),
                       clean)


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 6, 48), device=cuda)
    k = torch.zeros((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="D in"):
        fa_ops.flash_attention(q, k, k, impl="cuda")
    q = torch.zeros((1, 1, 17, 64), device=cuda)
    k = torch.zeros((1, 8, 1, 64), device=cuda)
    with pytest.raises(ValueError, match="H / KV in"):
        dec_ops.decode_attention(q, k, k, 3, impl="cuda")
    q = torch.zeros((1, 1, 6, 48), device=cuda)
    k = torch.zeros((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="D in"):
        dec_ops.decode_attention(q, k, k, 3, impl="cuda")
    q = torch.zeros((1, 1, 6, 64), device=cuda)   # G = 3 is taken
    k = torch.zeros((1, 8, 2, 64), device=cuda)
    assert dec_ops.decode_attention(q, k, k, 3, impl="cuda").shape == q.shape
    k = torch.zeros((1, 8, 3, 64), device=cuda)
    with pytest.raises(ValueError, match="length"):
        dec_ops.decode_attention(q[:, :, :3], k, k, 8, impl="cuda")
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.half(), k.half(), k.half(), impl="cuda")


def test_lm_server_on_the_card_goes_through_both_kernels(cuda):
    """A SMOKE-size server on the card: every prefill launches the flash
    kernel once a layer, every decode step the decode kernel once a
    layer, and nothing takes the plain versions.  Its logits agree with
    the same weights on the CPU."""
    cfg = qwen3_8b.SMOKE
    model = T.init_params(3, cfg, device=cuda)
    srv = LMServer(cfg, model, slots=2, max_seq=64, device=cuda)
    rng = np.random.default_rng(0)
    fa_ops.reset_counts()
    dec_ops.reset_counts()
    admits = steps = 0
    queue = [(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
             for i, (n, m) in enumerate([(8, 5), (16, 3), (24, 4)])]
    while queue or any(s.remaining > 0 for s in srv.slots):
        while queue and srv.admit(*queue[0]):
            queue.pop(0)
            admits += 1
        steps += srv.step() > 0
    assert admits == 3 and steps > 0
    assert fa_ops.launch_count() == cfg.n_layers * admits
    assert dec_ops.launch_count() == cfg.n_layers * steps
    assert fa_ops.plain_count() == dec_ops.plain_count() == 0
    assert sorted(len(c["tokens"]) for c in srv.completed) == [
        8 + 1 + 5, 16 + 1 + 3, 24 + 1 + 4]

    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 24)),
                             device=cuda)
    on_card, _ = T.prefill(model, cfg, tokens, chunk=8)
    on_cpu, _ = T.prefill(model.cpu(), cfg, tokens.cpu(), chunk=8)
    # float32 on both sides: rounding only (normwise, logits cross zero)
    assert float((on_card.cpu() - on_cpu).norm() / on_cpu.norm()) <= 1e-5


# ------------------------------------------------------------ CTR kernels
def _rows_close(out, expect, rtol, row_dims=1, scale=None):
    """Worst row's relative L2 against the plain float32 output (the last
    ``row_dims`` axes a row, as chip_smoke.py phases 13-14), or against
    ``scale``'s row where given; rows that should be zeros must be exactly
    zero."""
    diff = (out.float() - expect).flatten(expect.ndim - row_dims)
    ref = (expect if scale is None else scale).flatten(expect.ndim - row_dims)
    num, den = diff.norm(dim=-1), ref.norm(dim=-1)
    zero = den == 0
    assert not bool((num[zero] > 0).any())
    err = float((num[~zero] / den[~zero]).max())
    assert err <= rtol, err


@pytest.mark.parametrize("d", [1, 10, 16])
@pytest.mark.parametrize("dtype,rtol", [(torch.bfloat16, 1e-2),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_bag_kernel_matches_plain_version(cuda, d, dtype, rtol, prefix,
                                          id_dtype):
    g = torch.Generator(device=cuda).manual_seed(d)
    table = (0.01 * torch.randn((1 << 20, d), generator=g, device=cuda)
             ).to(dtype)
    ids = torch.randint(0, 1 << 20, (333, 39, 4), generator=g, device=cuda,
                        dtype=id_dtype)
    if prefix:
        counts = torch.randint(0, 5, (333, 39, 1), generator=g, device=cuda)
        mask = torch.arange(4, device=cuda) < counts
    else:
        mask = torch.rand((333, 39, 4), generator=g, device=cuda) < 0.5
    mask[0, 0] = False                       # an empty bag: zeros
    out = bag_ops.embedding_bag(table, ids, mask, impl="cuda")
    assert out.shape == (333, 39, d) and out.dtype == dtype
    # bfloat16: one rounding of the float32 sum, relative to the result.
    # float32: the kernel and the plain version sum a bag in other orders,
    # and a bag that cancels (D = 1: one value) magnifies that relative to
    # the result, so the rounding is held relative to the mean of |rows|
    scale = (None if dtype == torch.bfloat16 else
             bag_ref.embedding_bag_masked(table.float().abs(), ids, mask))
    _rows_close(out, bag_ref.embedding_bag_masked(table.float(), ids, mask),
                rtol, scale=scale)


def test_bag_kernel_never_reads_masked_rows_or_ids(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    table = torch.randn((1000, 10), generator=g, device=cuda).bfloat16()
    ids, mask, _ = ctr_batch(xdeepfm.SMOKE, 64, seed=2)
    ids = torch.as_tensor(ids, device=cuda)
    mask = torch.as_tensor(mask, device=cuda)
    mask[:, :, 3] = False
    clean = bag_ops.embedding_bag(table, ids, mask, impl="cuda")
    poisoned = table.clone()
    poisoned[ids[:, :, 3]] = float("nan")     # rows only masked entries use
    live = ids[mask]
    poisoned[live] = table[live]
    far = torch.where(mask, ids, 10 ** 12)    # past the table's end
    out = bag_ops.embedding_bag(poisoned, far, mask, impl="cuda")
    assert torch.equal(out, clean)


# bag sizes M = 4 (the vector path) and 1, 3, 9 (entries 4 at a time,
# scalar loads); widths whose rows take 2-, 4-, 8- and 16-byte units
@pytest.mark.parametrize("m", [1, 3, 4, 9])
@pytest.mark.parametrize("d", [1, 8, 10, 16, 128])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype,rtol", [(torch.bfloat16, 1e-2),
                                        (torch.float32, 1e-5)])
def test_bag_kernel_bag_sizes_widths_and_edges(cuda, m, d, id_dtype, dtype,
                                               rtol):
    g = torch.Generator(device=cuda).manual_seed(m * 1000 + d)
    rows = 5000
    table = (0.01 * torch.randn((rows, d), generator=g, device=cuda)
             ).to(dtype)
    ids = torch.randint(0, rows, (97, 7, m), generator=g, device=cuda,
                        dtype=id_dtype)
    mask = torch.rand((97, 7, m), generator=g, device=cuda) < 0.6
    mask[0, 0] = False                        # an empty bag: zeros
    ids = torch.where(mask, ids, rows + 12_345)   # masked: never used
    mask[1, 2, m - 1] = True                  # a valid id past the end:
    ids[1, 2, m - 1] = rows                   # its bag is NaN
    before = bag_ops.launch_count()
    out = bag_ops.embedding_bag(table, ids, mask, impl="cuda")
    torch.cuda.synchronize()
    assert bag_ops.launch_count() == before + 1
    assert out.shape == (97, 7, d) and out.dtype == dtype
    assert bool(torch.isnan(out[1, 2]).all())
    keep = torch.ones((97, 7), dtype=torch.bool, device=cuda)
    keep[1, 2] = False
    safe = ids.clone()
    safe[1, 2, m - 1] = 0                     # the plain version indexes
    expect = bag_ref.embedding_bag_masked(table.float(), safe, mask)
    scale = (None if dtype == torch.bfloat16 else
             bag_ref.embedding_bag_masked(table.float().abs(), safe,
                                          mask)[keep])
    _rows_close(out[keep], expect[keep], rtol, scale=scale)


# rows wider than a block's 256 lanes take several runs of lanes (a 2-D
# grid): bf16 D = 4104 (513 units of 16 bytes), float32 D = 2050 (1025 of
# 8 bytes)
@pytest.mark.parametrize("d,dtype,rtol", [(4104, torch.bfloat16, 1e-2),
                                          (2050, torch.float32, 1e-5)])
def test_bag_kernel_takes_rows_wider_than_a_block(cuda, d, dtype, rtol):
    g = torch.Generator(device=cuda).manual_seed(d)
    table = (0.01 * torch.randn((300, d), generator=g, device=cuda)
             ).to(dtype)
    ids = torch.randint(0, 300, (5, 3, 4), generator=g, device=cuda)
    mask = torch.rand((5, 3, 4), generator=g, device=cuda) < 0.6
    out = bag_ops.embedding_bag(table, ids, mask, impl="cuda")
    expect = bag_ref.embedding_bag_masked(table.float(), ids, mask)
    scale = (None if dtype == torch.bfloat16 else
             bag_ref.embedding_bag_masked(table.float().abs(), ids, mask))
    _rows_close(out, expect, rtol, scale=scale)


# a table, ids and mask off their alignment take narrower loads (2-byte
# units, scalar ids and mask) and give the same bits: the sum's order does
# not depend on the load width
@pytest.mark.parametrize("d", [1, 10, 16])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_bag_kernel_reads_views_off_alignment(cuda, d, id_dtype):
    g = torch.Generator(device=cuda).manual_seed(d)
    table = (0.01 * torch.randn((3000, d), generator=g, device=cuda)
             ).bfloat16()
    ids = torch.randint(0, 3000, (200, 39, 4), generator=g, device=cuda,
                        dtype=id_dtype)
    mask = torch.rand((200, 39, 4), generator=g, device=cuda) < 0.7

    def shifted(x):
        store = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        view = store[1:].view(x.shape)
        view.copy_(x)
        return view

    st, si, sm = shifted(table), shifted(ids), shifted(mask)
    assert bag_kernel.bag_plan(st, si, sm) == bag_kernel.BagPlan(2, False)
    assert bag_kernel.bag_plan(table, ids, mask).vec4
    out = bag_ops.embedding_bag(table, ids, mask, impl="cuda")
    moved = bag_ops.embedding_bag(st, si, sm, impl="cuda")
    assert torch.equal(out, moved)


# B = 3 and 512 split K over h (float32 partials, then a fixed-order sum),
# 1000 and 4096 do not; O = 13: W's rows are not on 16 bytes (the wrapper
# pads a copy for TMA)
@pytest.mark.parametrize("b", [512, 1000, 3, 4096])
@pytest.mark.parametrize("hk,o", [(39, 200), (200, 200), (12, 16), (12, 13)])
@pytest.mark.parametrize("dtype,rtol", [(torch.bfloat16, 1e-2),
                                        (torch.float32, 1e-4)])
def test_cin_kernel_matches_plain_version(cuda, b, hk, o, dtype, rtol):
    g = torch.Generator(device=cuda).manual_seed(b + hk)
    xk = torch.randn((b, hk, 10), generator=g, device=cuda).to(dtype)
    x0 = torch.randn((b, 39, 10), generator=g, device=cuda).to(dtype)
    w = (torch.randn((hk * 39, o), generator=g, device=cuda)
         * (hk * 39) ** -0.5).to(dtype)
    expect = cin_ops.cin_layer(xk.float(), x0.float(), w.float(),
                               impl="torch")
    out = cin_ops.cin_layer(xk, x0, w, impl="cuda")
    if dtype == torch.bfloat16:
        splits = cin_kernel.cin_plan(
            b, hk, 39, 10, o, n_sm=torch.cuda.get_device_properties(
                cuda).multi_processor_count).splits
        assert (splits > 1) == (b in (3, 512))
    assert out.shape == (b, o, 10) and out.dtype == dtype
    _rows_close(out, expect, rtol, row_dims=2)


@pytest.mark.parametrize("n", hopper.TILE_N)
@pytest.mark.parametrize("k", hopper.TILE_K)
@pytest.mark.parametrize("b_mn_major", [False, True])
@pytest.mark.parametrize("a_in_regs", [False, True])
def test_hopper_tile_matches_matmul(cuda, n, k, b_mn_major, a_in_regs):
    """hopper.cuh alone: one 64 x N x K bf16 tile through the TMA load,
    the K-major or MN-major B descriptor and wgmma (A from shared memory
    or from registers) against a float32 matmul of the same bf16 values:
    float32 sums of at most 128 exact products, so ~1e-6."""
    g = torch.Generator(device=cuda).manual_seed(n + k)
    a = torch.randn((64, k), generator=g, device=cuda).bfloat16()
    b = torch.randn((k, n) if b_mn_major else (n, k), generator=g,
                    device=cuda).bfloat16()
    c = hopper.tile_product(a, b, b_mn_major=b_mn_major, a_in_regs=a_in_regs)
    expect = a.float() @ (b.float() if b_mn_major else b.float().t())
    assert float((c - expect).abs().max() / expect.abs().max()) <= 1e-5


def test_ctr_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    table = torch.zeros((10, 4), device=cuda)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    mask = torch.ones((2, 3), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        bag_ops.embedding_bag(table.half(), ids, mask, impl="cuda")
    with pytest.raises(TypeError):
        bag_ops.embedding_bag(table, ids.float(), mask, impl="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        bag_ops.embedding_bag(table[:, ::2], ids, mask, impl="cuda")
    xk = torch.zeros((2, 3, 4), device=cuda)
    with pytest.raises(ValueError, match="agree"):
        cin_ops.cin_layer(xk, xk, torch.zeros((8, 5), device=cuda),
                          impl="cuda")
    with pytest.raises(TypeError):
        cin_ops.cin_layer(xk, xk.bfloat16(), torch.zeros((9, 5), device=cuda),
                          impl="cuda")
    x0 = torch.zeros((2, 65, 4), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="fields"):
        cin_ops.cin_layer(xk.bfloat16(), x0,
                          torch.zeros((195, 5), dtype=torch.bfloat16,
                                      device=cuda), impl="cuda")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


@pytest.mark.parametrize("arch", ["deepfm", "xdeepfm", "autoint"])
def test_ctr_logits_on_the_card_go_through_the_kernels(cuda, arch):
    """SMOKE models on the card: two bag launches a logits call, one CIN
    launch a layer, no plain call; the logits agree with the same weights
    on the CPU (float32: rounding only)."""
    from repro_torch.configs import registry
    cfg = registry.get_arch(arch).smoke_config
    params = getattr(RS, f"init_{arch}")(4, cfg, device=cuda)
    logits = getattr(RS, f"{arch}_logits")
    ids, mask, _ = ctr_batch(cfg, 100, seed=4)
    ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
    bag_ops.reset_counts()
    cin_ops.reset_counts()
    on_card = logits(params, cfg, ids.to(cuda), mask.to(cuda))
    assert bag_ops.launch_count() == 2
    assert cin_ops.launch_count() == len(cfg.cin_layers)
    assert bag_ops.plain_count() == cin_ops.plain_count() == 0
    on_cpu = logits(_to_cpu(params), cfg, ids, mask)
    assert float((on_card.cpu() - on_cpu).norm() / on_cpu.norm()) <= 1e-4


# -- the calibration loop: the engine's scorer, the scan's tangent, the fit --

def _engine_world():
    from repro_torch.engine import corpus as corpus_lib
    from repro_torch.engine import index as index_lib
    from repro_torch.workloadgen import querygen
    corp = corpus_lib.generate_corpus(corpus_lib.CorpusConfig(
        n_docs=3000, vocab_size=2000, mean_doc_len=40, seed=0))
    uni = querygen.build_universe(querygen.WorkloadConfig(
        "t", n_unique_queries=500, vocab_size=2000, seed=0))
    _, qterms = querygen.sample_query_stream(uni, 128)
    qterms = qterms.copy()
    qterms[3] = -1                                # an empty query
    return corp, index_lib.build_index(corp), qterms


def test_engine_scorer_card_matches_cpu(cuda):
    """The scorer on the card: ids equal the CPU's (-inf padding and its
    tie order included), scores within 1e-6, the same bits from run to
    run (one term a scatter: no colliding float atomics)."""
    from repro_torch.engine import broker, server
    _, idx, qterms = _engine_world()
    srv = server.IndexServer(idx, k_local=10, device=cuda)
    s, d = srv.process(qterms)
    cs, cd = server.IndexServer(idx, k_local=10, device="cpu").process(
        qterms)
    assert torch.equal(d.cpu(), cd)
    assert torch.equal(torch.isneginf(s.cpu()), torch.isneginf(cs))
    fin = torch.isfinite(cs)
    torch.testing.assert_close(s.cpu()[fin], cs[fin], rtol=1e-6, atol=0)
    s2, d2 = srv.process(qterms)
    assert torch.equal(s, s2) and torch.equal(d, d2)
    ms, md = broker.merge_topk(torch.stack([s, s.flip(0)]),
                               torch.stack([d, d.flip(0)]), k=10)
    cms, cmd = broker.merge_topk(torch.stack([cs, cs.flip(0)]),
                                 torch.stack([cd, cd.flip(0)]), k=10)
    assert torch.equal(md.cpu(), cmd)


def test_measure_engine_trace_on_card(cuda):
    """The instrumented engine on the card: the cache split equals the
    CPU run's, the replay runs the scan kernel, responses are finite."""
    from repro_torch.calibrate import measure_engine_trace
    from repro_torch.engine import partition, server
    corp, _, qterms = _engine_world()
    parts = partition.partition_documents(corp, 2)
    arrivals = np.sort(np.random.default_rng(0).uniform(0, 5.0, 128))
    traces = []
    for dev in (cuda, "cpu"):
        shards = [server.IndexServer(ix, k_local=5, device=dev)
                  for ix in parts.shards]
        ops.reset_launch_count()
        traces.append(measure_engine_trace(shards, qterms, arrivals,
                                           cache_bytes=50_000, batch=32))
        if dev is cuda:
            assert ops.launch_count() == 2
    card, cpu = traces
    assert torch.equal(card.server_hit.cpu(), cpu.server_hit)
    assert torch.equal(card.server_disk.cpu(), cpu.server_disk)
    assert bool(torch.isfinite(card.response).all())
    assert bool((card.response > 0).all())


def _near_tie_taint(a, b, out, ulps=16):
    """Elements of busy periods holding a near-tie (an arrival within
    ``ulps`` of its server going idle): there the kernel's and the plain
    scan's rounding may take opposite sides of the max."""
    from repro_torch.kernels.maxplus_scan.ref import _shift_right
    c = _shift_right(out, 1, -math.inf) + b
    tol = ulps * torch.finfo(a.dtype).eps * a.abs()
    seg = torch.cumsum((a - c > tol).to(torch.int64), dim=-1)
    near = ((a - c).abs() <= tol).to(torch.int64)
    tainted = torch.zeros(a.shape[0], a.shape[1] + 1, dtype=torch.int64,
                          device=a.device).scatter_add_(1, seg, near) > 0
    return torch.gather(tainted, 1, seg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scan_jvp_kernel_matches_plain(cuda, dtype):
    """torch.func.jvp through fcfs_completion_times launches the kernel
    and gives the plain scan's tangent: everywhere in float64 (1e-12),
    and in float32 (1e-5) outside busy periods with a near-tie."""
    from repro_torch.core.simulator import fcfs_completion_times
    g = torch.Generator(device=cuda).manual_seed(0)
    arr = torch.empty((8, 6000), dtype=dtype, device=cuda).exponential_(
        generator=g).mul_(0.05).cumsum(-1)
    svc = torch.empty_like(arr).exponential_(generator=g).mul_(0.04)
    one = torch.ones((), dtype=dtype, device=cuda)

    def jvp(impl):
        return torch.func.jvp(
            lambda s: fcfs_completion_times(arr, svc * s, impl=impl),
            (one,), (one,))
    ops.reset_launch_count()
    ko, kt = jvp("auto")
    assert ops.launch_count() == 1
    po, pt = jvp("torch")
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(ko, po, rtol=rtol, atol=0)
    keep = (torch.ones_like(pt, dtype=torch.bool) if dtype == torch.float64
            else ~_near_tie_taint(arr + svc, svc, po))
    assert float(keep.float().mean()) > 0.5
    torch.testing.assert_close(kt[keep], pt[keep], rtol=rtol, atol=0)


def test_calibrate_maxplus_card_matches_cpu(cuda):
    """A short calibrate(residual="maxplus") on the card (the scan and its
    tangent on the kernel) against the CPU on the same float64 traces."""
    from repro_torch.calibrate import calibrate, simulate_trace
    true = dataclasses.replace(capacity.TABLE5_PARAMS, p=4)
    traces = [simulate_trace(i, lam, 4_000, true, device="cpu",
                             dtype=torch.float64)
              for i, lam in enumerate((10.0, 20.0))]
    ops.reset_launch_count()
    card = calibrate([tr.map(lambda x: x.to(cuda)) for tr in traces],
                     n_windows=6, residual="maxplus", n_iters=3)
    assert ops.launch_count() > 0
    cpu = calibrate(traces, n_windows=6, residual="maxplus", n_iters=3)
    for name in ("s_scale", "alpha"):
        torch.testing.assert_close(getattr(card, name).cpu(),
                                   getattr(cpu, name), rtol=1e-8, atol=0)


# -------------------------------------------------- training through kernels

@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-5)])
def test_bag_function_backward_matches_plain_autograd(cuda, dtype, tol):
    """The bag's Function (kernel forward, plain backward) against
    autograd of the plain version on the card: the table gradient, of
    its largest entry; one launch, no plain call; the same bits twice."""
    g = torch.Generator(device=cuda).manual_seed(31)
    table = (0.01 * torch.randn((5000, 10), generator=g, device=cuda)
             ).to(dtype).requires_grad_(True)
    ids = torch.randint(0, 5000, (256, 39, 4), generator=g, device=cuda)
    ids[:, :3] = torch.randint(0, 3, (256, 3, 4), generator=g, device=cuda)
    mask = torch.rand((256, 39, 4), generator=g, device=cuda) < 0.7
    dy = torch.randn((256, 39, 10), generator=g, device=cuda).to(dtype)
    bag_ops.reset_counts()
    grads = [torch.autograd.grad(bag_ops.embedding_bag(table, ids, mask),
                                 table, dy)[0] for _ in range(2)]
    assert bag_ops.launch_count() == 2 and bag_ops.plain_count() == 0
    assert torch.equal(grads[0], grads[1])
    (plain,) = torch.autograd.grad(
        bag_ops.embedding_bag(table, ids, mask, impl="torch"), table, dy)
    err = float((grads[0].float() - plain.float()).abs().max()
                / plain.float().abs().max())
    assert err <= tol, err


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
def test_cin_function_backward_matches_plain_autograd(cuda, dtype, tol):
    """The CIN's Function (kernel forward, plain backward) against
    autograd of the plain version: dxk, dx0 and dw, each of its largest
    entry; one launch a call, no plain call; the same bits twice."""
    g = torch.Generator(device=cuda).manual_seed(32)
    xk = torch.randn((512, 200, 10), generator=g, device=cuda).to(dtype)
    x0 = torch.randn((512, 39, 10), generator=g, device=cuda).to(dtype)
    w = (torch.randn((200 * 39, 200), generator=g, device=cuda)
         * 7800 ** -0.5).to(dtype)
    for t in (xk, x0, w):
        t.requires_grad_(True)
    dy = torch.randn((512, 200, 10), generator=g, device=cuda).to(dtype)
    cin_ops.reset_counts()
    runs = [torch.autograd.grad(cin_ops.cin_layer(xk, x0, w), (xk, x0, w),
                                dy) for _ in range(2)]
    assert cin_ops.launch_count() == 2 and cin_ops.plain_count() == 0
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    plain = torch.autograd.grad(cin_ops.cin_layer(xk, x0, w, impl="torch"),
                                (xk, x0, w), dy)
    for got, want in zip(runs[0], plain):
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        assert err <= tol, err


def test_segment_sum_card_repeats_and_matches_cpu(cuda):
    """`_segment.segment_sum` on the card: the same bits run to run, and
    the CPU's sums to float32 rounding, over runs of 1 to 100,000 ids."""
    from repro_torch._segment import segment_sum
    g = torch.Generator().manual_seed(33)
    ids = torch.cat([torch.zeros(100_000, dtype=torch.long),
                     torch.randint(0, 5000, (50_000,), generator=g)])
    ids = ids[torch.randperm(ids.numel(), generator=g)]
    data = torch.randn((ids.numel(), 16), generator=g)
    card = [segment_sum(data.to(cuda), ids.to(cuda), 5000) for _ in range(2)]
    assert torch.equal(card[0], card[1])
    torch.testing.assert_close(card[0].cpu(), segment_sum(data, ids, 5000),
                               rtol=1e-5, atol=1e-4)
