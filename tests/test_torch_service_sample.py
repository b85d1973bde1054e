"""The service sampler's layout and dispatch, on the CPU.

The CUDA kernel (`repro_torch.kernels.service_sample`) makes the
simulator's cache-mode and exponential-mode services in one pass, from
the very Philox4x32-10 words torch's CUDA generators turn into
``torch.rand`` / ``exponential_``, so its output equals the plain draws
bit for bit.  What decides that is torch's layout of a draw: a numpy
model of it (`torch_philox_model`) is held here to Random123's
known-answer vectors and, element by element, to torch's grid-stride loop
(ATen/native/cuda/DistributionTemplates.h) transcribed as it is.  The
launch plan (`kernel.grid_size`, and `kernel.draw_launches` for a draw
torch splits into pieces) and the rules by which the wrapper takes the
kernel or the plain draws are pure Python and are checked here too.
The kernel itself, and the model against torch, are held on the card
(tests/test_torch_gpu.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_philox_model as model
from repro_torch.core import capacity, simulator
from repro_torch.core.queueing import service_time_server
from repro_torch.kernels.service_sample import kernel, ops


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_model_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    got = model.philox4x32_10([np.array([c]) for c in ctr], key)
    assert [int(w[0]) for w in got] == list(want)


@pytest.mark.parametrize("numel,grid", [(1, 1), (700, 3), (2048, 2),
                                        (3001, 2), (9000, 1)])
def test_layout_model_is_torchs_grid_stride_loop(numel, grid):
    """Each element's (thread, call, word) from the model equals what
    torch's loop gives it: thread idx walks linear_index from idx by
    4T up to numel rounded up to 4T, draws one ``curand_uniform4`` a
    step, and stores word ii at linear_index + T ii if that is below
    numel."""
    span = model.THREADS * grid
    rounded = ((numel - 1) // (span * 4) + 1) * span * 4
    want = {}
    for idx in range(span):
        for call, linear in enumerate(range(idx, rounded, span * 4)):
            for ii in range(4):
                li = linear + span * ii
                if li < numel:
                    assert li not in want
                    want[li] = (idx, call, ii)
    t, k, ii = model.place(numel, grid)
    assert sorted(want) == list(range(numel))
    assert [want[e] for e in range(numel)] == list(zip(t.tolist(),
                                                       k.tolist(),
                                                       ii.tolist()))


def test_uniform_bounds_of_the_model():
    """curand's uniform is in (0, 1]: the top word rounds to 1, which
    ``torch.rand`` reverses to 0 and ``exponential_`` sends to eps / 2;
    the bottom word is 2^-33."""
    w = np.array([0, 1, 0xFFFFFF7F, 0xFFFFFF80, 0xFFFFFFFF],
                 dtype=np.uint32)
    u = model.uniform(w)
    assert u.dtype == np.float32
    assert u[0] == np.float32(2.0 ** -33)
    assert u[-1] == np.float32(1.0)
    assert np.all(u > 0) and np.all(u <= 1)
    assert u[2] < u[3] == np.float32(1.0)


@pytest.mark.parametrize("seed", [0, 7, simulator._mix(2026, 1),
                                  (1 << 64) - 1])
def test_model_draws_are_in_range(seed):
    """The model's ``torch.rand`` lies in [0, 1), its exponentials are
    positive with mean near 1 (a 100,000-draw sample: 5 sigma is 0.016),
    and the seed's two halves both matter."""
    numel, grid = 100_000, 16
    u = model.torch_rand(seed, numel, grid)
    e = model.torch_exponential(seed, numel, grid)
    assert u.dtype == e.dtype == np.float32
    assert 0.0 <= u.min() and u.max() < 1.0
    assert e.min() > 0.0 and abs(float(e.mean()) - 1.0) < 0.016
    flipped = seed ^ (1 << 63) ^ 1
    assert not np.array_equal(model.words(seed, 64, grid),
                              model.words(flipped, 64, grid))


@pytest.mark.parametrize("numel,sm,threads,want", [
    (256 * 100 * 4096, 132, 2048, 1056),   # the benchmark's chunk, H100
    (300, 132, 2048, 2),
    (256, 132, 2048, 1),
    (257, 132, 2048, 2),
    (1056 * 256, 132, 2048, 1056),
    (1056 * 256 + 1, 132, 2048, 1056),
    (10 ** 6, 4, 1536, 24),
])
def test_grid_is_torchs(numel, sm, threads, want):
    """``calc_execution_policy``: ceil(numel / 256) blocks, at most the
    SMs times the 256-thread blocks an SM holds."""
    assert kernel.grid_size(numel, sm, threads) == want


def _torch_launches(numel, sm, threads, limit):
    """``distribution_nullary_kernel``'s launches, transcribed as torch
    writes them: reserve the draw's offset (``philox_cuda_state``, rounded
    up to 4), and past ``limit`` elements walk ``SplitUntil32Bit``'s stack
    (``split`` keeps the first floor(n / 2) elements in the copy it
    pushes) and recurse into each piece it yields."""
    offset = 0
    out = []

    def nullary(start, n):
        nonlocal offset
        grid = min(sm * (threads // 256), (n + 255) // 256)
        inc = ((n - 1) // (256 * grid * 4) + 1) * 4
        here = offset
        offset += (inc + 3) // 4 * 4
        if n <= limit:
            out.append((start, n, grid, here // 4))
            return
        vec = [[start, n]]

        def settle():
            while vec and vec[-1][1] > limit:
                it = vec[-1]
                copy = it[1] // 2
                first = [it[0], copy]
                it[0], it[1] = it[0] + copy, it[1] - copy
                vec.append(first)
        settle()
        while vec:
            nullary(*vec[-1])
            vec.pop()
            settle()

    nullary(0, numel)
    return out


@pytest.mark.parametrize("numel,limit", [
    (1000, 1000), (1001, 1000), (4000, 1000), (4001, 1000), (2999, 1000),
    (10 ** 5 + 7, 1000), (256 * 100 * 4096, 2 ** 29),
    (2 ** 30 + 2 ** 22, 2 ** 29), (3 * 2 ** 29 + 5, 2 ** 29),
])
def test_draw_launches_are_torchs_split(numel, limit):
    """`kernel.draw_launches` gives torch's pieces, grids and Philox
    counter bases, and the pieces tile the draw in order."""
    for sm, threads in ((132, 2048), (2, 512)):
        got = kernel.draw_launches(numel, sm, threads, split=limit)
        assert got == _torch_launches(numel, sm, threads, limit)
        assert [g[0] for g in got] == [0] + list(
            np.cumsum([g[1] for g in got])[:-1])
        assert sum(g[1] for g in got) == numel
        assert all(g[1] <= limit for g in got)
        assert (len(got) == 1) == (numel <= limit)


def test_words_at_counts_on_from_each_pieces_counter_base():
    """A piece's k-th call is the Philox block at counter (base + k) in
    the low 64 bits (carrying into the second word) and the thread in the
    third; one launch from base 0 is `words`."""
    seed, grid = simulator._mix(3, 4), 2
    span = model.THREADS * grid
    assert np.array_equal(model.words_at(seed, np.arange(900),
                                         [(0, 900, grid, 0)]),
                          model.words(seed, 900, grid))
    base = (1 << 32) - 1
    launches = [(0, 10, 1, 0), (10, 3 * 4 * span, grid, base)]
    index = np.array([10 + 4 * span + 5, 10 + 8 * span + 3 * span + 1])
    got = model.words_at(seed, index, launches)
    key = (seed & 0xFFFFFFFF, seed >> 32)
    for e, w, (lo, hi) in zip(index, got, ((0, 1), (1, 1))):
        local = int(e) - 10
        k, rem = divmod(local, 4 * span)
        ii, t = divmod(rem, span)
        block = model.philox4x32_10(
            [np.array([x]) for x in (lo, hi, t, 0)], key)
        assert k + base == lo + (hi << 32)
        assert int(block[ii][0]) == int(w)


@pytest.mark.parametrize("device,dtype,mode,per_scenario,takes", [
    ("cuda", torch.float32, "cache", 100 * 4096, True),
    ("cuda", torch.float32, "exponential", 1, True),
    ("cuda", torch.float32, "cache", 2 ** 31, True),
    ("cuda", torch.float32, "cache", 2 ** 31 + 1, False),
    ("cuda", torch.float32, "balanced", 4096, False),
    ("cuda", torch.float64, "cache", 4096, False),
    ("cuda", torch.bfloat16, "exponential", 4096, False),
    ("cpu", torch.float32, "cache", 4096, False),
])
def test_which_draws_the_kernel_takes(device, dtype, mode, per_scenario,
                                      takes):
    """The kernel takes float32 cache / exponential draws on a CUDA
    device, of any size (torch's pieces past 2^29 elements included), up
    to 2^31 elements a scenario; everything else goes to the plain draws
    under "auto" and raises under "cuda"."""
    why = kernel.unsupported(torch.device(device), dtype, mode,
                             per_scenario)
    assert (why is None) == takes, why


def _params(n_scen, dtype=torch.float32):
    g = torch.Generator().manual_seed(5)
    return simulator._vec_params(dataclasses.replace(
        capacity.TABLE5_PARAMS,
        s_hit=1e-3 + 8e-3 * torch.rand(n_scen, generator=g,
                                       dtype=torch.float64),
        hit=0.1 + 0.8 * torch.rand(n_scen, generator=g,
                                   dtype=torch.float64)),
        torch.device("cpu"), dtype)


@pytest.mark.parametrize("mode", ["cache", "exponential", "balanced"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_takes_the_plain_draws_of_the_rng_plan(mode, dtype):
    """On the CPU "auto" and "torch" both give the plain draws, with no
    launch, from the plan `portbench/reference/rng_plan.py` rebuilds:
    stream word 0 for "exponential" / "balanced", words 1-4 (hit
    uniform, hit, miss, disk exponentials) for "cache"."""
    n_scen, p, n, seed = 3, 5, 64, 12345
    vp = _params(n_scen, dtype)
    before, plain = ops.launch_count(), ops.plain_count()
    got = {impl: simulator.sample_service_times_batch(
        seed, n_scen, n, p, vp, mode, device="cpu", dtype=dtype, impl=impl)
        for impl in ("auto", "torch")}
    assert ops.launch_count() == before
    assert ops.plain_count() == plain + 2
    assert torch.equal(got["auto"], got["torch"])
    shape = (n_scen, p, n)

    def draw(fn, i, sh=shape):
        return fn(simulator._mix(seed, i), sh, torch.device("cpu"), dtype)

    def col(x):
        return x[:, None, None]
    if mode == "cache":
        want = torch.where(
            draw(simulator._unit_uniform, 1) < col(vp.hit),
            draw(simulator._unit_exponential, 2) * col(vp.s_hit),
            draw(simulator._unit_exponential, 3) * col(vp.s_miss)
            + draw(simulator._unit_exponential, 4) * col(vp.s_disk))
    else:
        mean = col(service_time_server(vp).to(dtype))
        one = draw(simulator._unit_exponential, 0,
                   shape if mode == "exponential" else (n_scen, 1, n))
        want = (one * mean).expand(shape)
    assert got["auto"].dtype == dtype
    assert torch.equal(got["auto"], want)


def test_cuda_impl_refuses_what_the_kernel_does_not_take():
    """``impl="cuda"`` on the CPU raises rather than falling back, and an
    unknown impl or mode is refused."""
    vp = _params(2)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        simulator.sample_service_times_batch(1, 2, 8, 3, vp, "cache",
                                             device="cpu", impl="cuda")
    with pytest.raises(ValueError, match="unknown service sampler impl"):
        simulator.sample_service_times_batch(1, 2, 8, 3, vp, "cache",
                                             device="cpu", impl="triton")
    with pytest.raises(ValueError, match="unknown service mode"):
        simulator.sample_service_times_batch(1, 2, 8, 3, vp, "pareto",
                                             device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        kernel.service_sample_cuda((1, 2, 3, 4), (2, 3, 8),
                                   (vp.hit, vp.s_hit, vp.s_miss, vp.s_disk),
                                   "cache")


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_simulator_impl_reaches_the_sampler(monkeypatch, impl):
    """``simulate_fork_join_batch(impl="torch")`` samples with the plain
    draws too, and "auto" leaves the sampler its "auto"; one sampler call
    a chunk.  (Under "cuda" the sampler gets "auto" as well, so that a
    float64 draw is no error: tests/test_torch_gpu.py.)"""
    seen = []
    real = ops.service_times

    def spy(*args, impl):
        seen.append(impl)
        return real(*args, impl="torch")
    monkeypatch.setattr(ops, "service_times", spy)
    simulator.simulate_fork_join_batch(
        4, torch.tensor([5.0, 9.0]), _params(2), 3 * 64, p=3, mode="cache",
        impl=impl, chunk_size=64, device="cpu")
    assert seen == [impl] * 3
