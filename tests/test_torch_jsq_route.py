"""The JSQ router's algorithm and launch plan, on the CPU.

The CUDA kernel (`repro_torch.kernels.jsq_route`) carries one maximum per
replica instead of reducing the whole (r, p) tracker every step: rounding
is monotone, so max_j max(fl(w_kj - g), 0) = max(fl(M_k - g), 0) bit for
bit.  Here that recurrence runs in plain torch and is held equal, with
``torch.equal``, to the plain loop (`ref.jsq_route_ref`) and to the
reference's `lax.scan` (`repro.core.simulator._jsq_route`).  The launch
plan (`kernel.jsq_plan`) is pure Python: its coverage of the servers, its
choice of registers or shared memory, and that it takes every shape the
kernel took before, are checked here.  The kernel itself is held against
the plain loop on the card (tests/test_torch_gpu.py, chip_smoke.py phase
5b).

The masked router (the autoscaler's active counts and the fault
injector's up mask) is held likewise: the plain loop against the
reference's `_jsq_route` with ``n_act`` and ``up`` in float64 (choices,
spill and unavail exact), and the kernel's masked choice (drained maxima
set to +inf outside the mask, the argmin over the active replicas kept
for ``spill``) against the plain loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simulator as jsim
from repro_torch.kernels.hopper import SMEM_LIMIT
from repro_torch.kernels.jsq_route import kernel as t_kernel
from repro_torch.kernels.jsq_route import ref as t_ref

DTYPES = {"float32": (torch.float32, np.float32),
          "float64": (torch.float64, np.float64)}


def _carried_max_route(w, gaps, services, live):
    """The kernel's recurrence: drain the carried maxima, argmin over
    them, deposit into the chosen replica (a product, then a sum), and
    take one max, the chosen replica's new M."""
    rows = torch.arange(w.shape[0])
    m = w.amax(dim=-1)
    choices = []
    for i in range(gaps.shape[1]):
        gap = gaps[:, i, None]
        w = torch.clamp_min(w - gap[..., None], 0.0)
        d = torch.clamp_min(m - gap, 0.0)
        best = torch.argmin(d, dim=-1)
        w[rows, best] = w[rows, best] + live[:, i, None] * services[:, :, i]
        m = d.clone()
        m[rows, best] = w[rows, best].amax(dim=-1)
        choices.append(best)
    return torch.stack(choices, dim=-1), w


def _inputs(s, r, p, n, dtype, seed):
    rng = np.random.default_rng(seed)
    w = rng.exponential(size=(s, r, p)) * 0.5
    w[0] = 0.0                                    # idle: ties everywhere
    w[1, :, :] = w[1, :1, :]                      # equal replicas: ties
    gaps = rng.exponential(size=(s, n)) * 0.3 / r
    svc = rng.exponential(size=(s, p, n))
    live = (rng.random((s, n)) > 0.25).astype(np.float64)   # cache hits
    return [a.astype(DTYPES[dtype][1]) for a in (w, gaps, svc, live)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("s,r,p,n", [(4, 4, 100, 300), (3, 3, 5, 400),
                                     (2, 16, 7, 120), (3, 1, 9, 50)])
def test_carried_maximum_equals_plain_loop_bit_for_bit(dtype, s, r, p, n):
    arrays = _inputs(s, r, p, n, dtype, seed=r * 100 + p)
    w, gaps, svc, live = (torch.from_numpy(a) for a in arrays)
    kc, kw = _carried_max_route(w.clone(), gaps, svc, live)
    pc, pw = t_ref.jsq_route_ref(w.clone(), gaps, svc, live)
    assert torch.equal(kc, pc)
    assert torch.equal(kw, pw)
    assert r == 1 or bool((kc > 0).any())       # the choices do vary


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_carried_maximum_equals_reference_scan(x64, dtype):
    arrays = _inputs(3, 4, 6, 200, dtype, seed=9)
    w, gaps, svc, live = (torch.from_numpy(a) for a in arrays)
    kc, kw = _carried_max_route(w.clone(), gaps, svc, live)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    rc, rw = jsim._jsq_route(*(jnp.asarray(a) for a in arrays), 4, jdt)
    rc, rw = np.asarray(rc), np.asarray(rw)
    assert rw.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(kc.numpy(), rc)
    np.testing.assert_array_equal(kw.numpy(), rw)


# ------------------------------------------------------------ launch plan

# every KC bucket, PER from 1 to 16, p on and off a multiple of 32, both
# sides of the register budget
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("r,p", [
    (4, 100), (3, 5), (16, 40), (1, 7), (16, 200), (2, 1000), (1, 1),
    (2, 32), (2, 33), (4, 64), (4, 65), (8, 96), (8, 129), (13, 70),
    (16, 64), (16, 65), (5, 512), (1, 513)])
def test_plan_holds_every_server_once(itemsize, r, p):
    plan = t_kernel.jsq_plan(r, p, itemsize)
    assert plan.kc >= r and plan.kc in t_kernel.KC_BUCKETS
    held = [j for lane in range(32) for j in plan.servers(lane, p)]
    assert sorted(held) == list(range(p))
    assert plan.smem_bytes <= SMEM_LIMIT
    words = plan.kc * plan.per * itemsize // 4
    if plan.registers:
        assert plan.per in t_kernel.PER_BUCKETS
        assert words <= t_kernel.REG_BUDGET
        assert plan.smem_bytes == (2 * (p + 2) * (plan.tile + 1) * itemsize
                                   + 4 * plan.tile)
    else:
        # only a tracker past the budget leaves registers
        per = next((b for b in t_kernel.PER_BUCKETS if 32 * b >= p), None)
        assert per is None or plan.kc * per * itemsize // 4 \
            > t_kernel.REG_BUDGET
        assert plan.per == -(-p // 32)


def test_plan_at_the_replicated_path():
    """(r = 4, p = 100): registers, 4 servers a lane, 32-query tiles, in
    float32 and float64."""
    for itemsize in (4, 8):
        plan = t_kernel.jsq_plan(4, 100, itemsize)
        assert (plan.registers, plan.kc, plan.per, plan.tile) \
            == (True, 4, 4, 32)
        assert plan.smem_bytes == 2 * 102 * 33 * itemsize + 4 * 32
    # past the register budget: the shared-memory variant
    assert not t_kernel.jsq_plan(16, 200, 4).registers
    assert not t_kernel.jsq_plan(8, 200, 8).registers


def test_plan_takes_every_shape_the_previous_kernel_took():
    """The previous kernel took r <= 16 and any p whose tracker and two
    32-query tiles, (r p + 2 p 33) elements, fit a block's shared
    memory; the plan refuses none of them."""
    for itemsize in (4, 8):
        for r in range(1, 17):
            p_max = SMEM_LIMIT // itemsize // (r + 66)
            for p in (1, 2, 3, p_max - 1, p_max):
                assert t_kernel.jsq_plan(r, p, itemsize).smem_bytes \
                    <= SMEM_LIMIT
    with pytest.raises(ValueError, match="replicas"):
        t_kernel.jsq_plan(257, 10, 4)


# ------------------------------------------------------------ masks

def _masks(s, r, n, seed):
    rng = np.random.default_rng(seed)
    n_act = rng.integers(1, r + 1, size=(s, n)).astype(np.int32)
    up = rng.random((s, n, r)) < 0.65
    up[0, : n // 4] = False                     # nothing up: unavailable
    return n_act, up


def _carried_max_route_masked(w, gaps, services, live, n_act, up):
    """The masked kernel's recurrence: the drained maxima of inactive and
    down replicas are +inf in the argmin; the argmin over the active
    replicas alone is the fault-free choice (``spill``, ``unavail``)."""
    rows = torch.arange(w.shape[0])
    replicas = torch.arange(w.shape[1])
    m = w.amax(dim=-1)
    out = [], [], []
    for i in range(gaps.shape[1]):
        gap = gaps[:, i, None]
        w = torch.clamp_min(w - gap[..., None], 0.0)
        d = torch.clamp_min(m - gap, 0.0)
        active = replicas < n_act[:, i, None]
        ok = active & up[:, i]
        raw = torch.argmin(torch.where(active, d, torch.inf), dim=-1)
        any_up = ok.any(dim=-1)
        best = torch.where(any_up,
                           torch.argmin(torch.where(ok, d, torch.inf), -1),
                           raw)
        w[rows, best] = w[rows, best] + live[:, i, None] * services[:, :, i]
        m = d.clone()
        m[rows, best] = w[rows, best].amax(dim=-1)
        for acc, v in zip(out, (best, any_up & ~up[rows, i, raw], ~any_up)):
            acc.append(v)
    return tuple(torch.stack(v, dim=-1) for v in out) + (w,)


@pytest.mark.parametrize("masks", ["n_act", "up", "both"])
@pytest.mark.parametrize("with_hits", [False, True])
def test_masked_plain_loop_matches_reference(x64, masks, with_hits):
    rng = np.random.default_rng(3)
    s, r, p, n = 3, 4, 5, 300
    w = rng.exponential(size=(s, r, p)) * 0.5
    w[0] = 0.0
    gaps = rng.exponential(size=(s, n)) * 0.3 / r
    svc = rng.exponential(size=(s, p, n))
    live = ((rng.random((s, n)) > 0.3) if with_hits
            else np.ones((s, n))).astype(np.float64)
    n_act, up = _masks(s, r, n, seed=4)
    n_act = n_act if masks in ("n_act", "both") else None
    up = up if masks in ("up", "both") else None
    ref = jsim._jsq_route(
        jnp.asarray(w), jnp.asarray(gaps), jnp.asarray(svc),
        jnp.asarray(live), r, jnp.float64,
        n_act=None if n_act is None else jnp.asarray(n_act),
        up=None if up is None else jnp.asarray(up))
    port = t_ref.jsq_route_ref(
        torch.from_numpy(w), torch.from_numpy(gaps), torch.from_numpy(svc),
        torch.from_numpy(live),
        n_act=None if n_act is None else torch.from_numpy(n_act),
        up=None if up is None else torch.from_numpy(up))
    assert len(port) == len(ref) == (4 if up is not None else 2)
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(port[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-12)
    if up is not None:
        np.testing.assert_array_equal(port[2].numpy(), np.asarray(ref[2]))
        np.testing.assert_array_equal(port[3].numpy(), np.asarray(ref[3]))
        assert port[2].any() and port[3].any()
    if n_act is not None:
        # no query lands on a replica past its active count unless none
        # of the active ones was up
        landed = port[0].numpy() < n_act
        assert landed.all() if up is None else landed[~port[3].numpy()].all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("s,r,p,n", [(4, 4, 100, 300), (3, 3, 5, 400),
                                     (2, 16, 7, 120), (3, 1, 9, 50)])
def test_masked_carried_maximum_equals_plain_loop(dtype, s, r, p, n):
    arrays = _inputs(s, r, p, n, dtype, seed=r * 10 + p)
    w, gaps, svc, live = (torch.from_numpy(a) for a in arrays)
    n_act, up = (torch.from_numpy(a) for a in _masks(s, r, n, seed=r))
    kc, ks, ku, kw = _carried_max_route_masked(w.clone(), gaps, svc, live,
                                               n_act, up)
    pc, pw, ps, pu = t_ref.jsq_route_ref(w.clone(), gaps, svc, live,
                                         n_act=n_act, up=up)
    for a, b in ((kc, pc), (ks, ps), (ku, pu), (kw, pw)):
        assert torch.equal(a, b)


def test_masked_plan_stages_the_masks():
    """The masked instances stage an active count and a word of up bits a
    query with each tile: 16 bytes a query more shared memory, and the
    plan's last word tells the entry point."""
    for itemsize in (4, 8):
        for r, p in ((4, 100), (16, 200), (3, 5)):
            plain = t_kernel.jsq_plan(r, p, itemsize)
            masked = t_kernel.jsq_plan(r, p, itemsize, True)
            assert masked.masked and not plain.masked
            assert (masked.registers, masked.kc, masked.per) == (
                plain.registers, plain.kc, plain.per)
            tile = masked.tile
            staged = 2 * (p + 2) * (tile + 1) * itemsize
            expect = (staged + 4 * tile if masked.registers
                      else r * p * itemsize + staged) + 16 * tile
            assert masked.smem_bytes == expect <= SMEM_LIMIT
            assert list(masked.args) == [int(not masked.registers),
                                         masked.kc, masked.per, tile,
                                         expect, 1]
            assert list(plain.args)[5] == 0


# ------------------------------------------------------------ past 16

def _wide_route(w, gaps, services, live, n_act=None, up=None):
    """The wide kernel's recurrence (r > 16): the tracker clamped at 0 as
    it lands, the carried maxima drained, only the replicas whose maximum
    was > 0 before the step drained (an idle replica's servers are all
    0), the masked argmin over the drained maxima, the deposit into the
    chosen replica and its new maximum."""
    rows = torch.arange(w.shape[0])
    r = w.shape[1]
    k = torch.arange(r)
    w = torch.clamp_min(w, 0.0)
    m = w.amax(dim=-1)
    choices, spills, unavails = [], [], []
    for i in range(gaps.shape[1]):
        gap = gaps[:, i, None]
        busy = m > 0
        w = torch.where(busy[..., None],
                        torch.clamp_min(w - gap[..., None], 0.0), w)
        d = torch.clamp_min(m - gap, 0.0)
        act = (k < (r if n_act is None else n_act[:, i, None]))
        da = torch.where(act, d, torch.inf)
        best = raw = torch.argmin(da, dim=-1)
        if up is not None:
            ok = act & up[:, i]
            any_up = ok.any(dim=-1)
            best = torch.where(any_up, torch.argmin(
                torch.where(ok, d, torch.inf), dim=-1), raw)
            spills.append(any_up & ~up[rows, i, raw])
            unavails.append(~any_up)
        w[rows, best] = w[rows, best] + live[:, i, None] * services[:, :, i]
        m = d.clone()
        m[rows, best] = w[rows, best].amax(dim=-1)
        choices.append(best)
    out = (torch.stack(choices, dim=-1), w)
    if up is None:
        return out
    return out + (torch.stack(spills, dim=-1), torch.stack(unavails, dim=-1))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("r", [17, 32, 40])
@pytest.mark.parametrize("masks", [None, "both"])
def test_wide_recurrence_equals_plain_loop(dtype, r, masks):
    """Skipping idle replicas and carrying the maxima changes no bit: the
    choices, flags and tracker equal the plain loop's."""
    s, p, n = 3, 9, 160
    arrays = _inputs(s, r, p, n, dtype, seed=r)
    arrays[0][2, ::2] = 0.0                       # idle replicas at start
    w, gaps, svc, live = (torch.from_numpy(a) for a in arrays)
    n_act = up = None
    if masks:
        n_act, up = (torch.from_numpy(a) for a in _masks(s, r, n, seed=r))
    k = _wide_route(w.clone(), gaps, svc, live, n_act=n_act, up=up)
    pl = t_ref.jsq_route_ref(w.clone(), gaps, svc, live, n_act=n_act, up=up)
    assert len(k) == len(pl)
    for a, b in zip(k, pl):
        assert torch.equal(a, b)
    assert bool((pl[0] >= 16).any())             # past the narrow range


@pytest.mark.parametrize("r", [17, 32])
def test_plain_loop_past_16_matches_reference(x64, r):
    """The plain loop against the reference's `_jsq_route` in float64 at
    r = 17 and 32, unmasked and under both masks: choices and flags
    exact, the tracker to 1e-12."""
    rng = np.random.default_rng(r)
    s, p, n = 2, 5, 200
    w = rng.exponential(size=(s, r, p)) * 0.5
    gaps = rng.exponential(size=(s, n)) * 0.3 / r
    svc = rng.exponential(size=(s, p, n))
    live = (rng.random((s, n)) > 0.3).astype(np.float64)
    n_act, up = _masks(s, r, n, seed=r + 1)
    for masked in (False, True):
        kw_j = dict(n_act=jnp.asarray(n_act), up=jnp.asarray(up)) \
            if masked else {}
        kw_t = dict(n_act=torch.from_numpy(n_act),
                    up=torch.from_numpy(up)) if masked else {}
        ref = jsim._jsq_route(jnp.asarray(w), jnp.asarray(gaps),
                              jnp.asarray(svc), jnp.asarray(live), r,
                              jnp.float64, **kw_j)
        port = t_ref.jsq_route_ref(torch.from_numpy(w),
                                   torch.from_numpy(gaps),
                                   torch.from_numpy(svc),
                                   torch.from_numpy(live), **kw_t)
        np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(port[1].numpy(), np.asarray(ref[1]),
                                   rtol=1e-12)
        if masked:
            np.testing.assert_array_equal(port[2].numpy(),
                                          np.asarray(ref[2]))
            np.testing.assert_array_equal(port[3].numpy(),
                                          np.asarray(ref[3]))
        assert int(port[0].max()) >= 16


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_wide_plan_past_16_replicas(itemsize, masked):
    """r = 17..256 at p = 100 take the wide instance: the tracker and two
    staged tiles (and, masked, an active count and ceil(r / 32) up words
    a query) in shared memory, variant 2 to the entry point; r = 256,
    p = 100 fits in float64 too.  Past 256 replicas, or a tracker past a
    block's shared memory, is refused with the bytes named."""
    for r in (17, 31, 32, 33, 64, 65, 128, 200, 256):
        plan = t_kernel.jsq_plan(r, 100, itemsize, masked)
        words = -(-r // 32)
        assert plan.wide and not plan.registers and plan.masked == masked
        assert (plan.kc, plan.words, plan.per) == (32 * words, words, 4)
        held = [j for lane in range(32) for j in plan.servers(lane, 100)]
        assert sorted(held) == list(range(100))
        expect = ((r * 100 + 2 * 102 * (plan.tile + 1)) * itemsize
                  + 8 * (1 + words) * plan.tile * masked)
        assert plan.smem_bytes == expect <= SMEM_LIMIT
        wider = [t for t in t_kernel.TILES if t > plan.tile]
        if wider:                       # the widest tile that fits
            t = min(wider)
            assert ((r * 100 + 2 * 102 * (t + 1)) * itemsize
                    + 8 * (1 + words) * t * masked) > SMEM_LIMIT
        assert list(plan.args) == [2, 32 * words, 4, plan.tile, expect,
                                   int(masked)]
    # r <= 16 keeps its narrow plan
    assert not t_kernel.jsq_plan(16, 100, itemsize, masked).wide
    with pytest.raises(ValueError, match="replicas"):
        t_kernel.jsq_plan(257, 100, itemsize, masked)
    with pytest.raises(ValueError, match=r"\d+ B of shared memory"):
        t_kernel.jsq_plan(256, 300, itemsize, masked)


@pytest.mark.parametrize("r", [17, 32, 33, 256])
def test_up_words_pack_32_replicas_a_word(r):
    """The wide instance's up mask: word q, bit b is replica 32 q + b;
    without a mask every bit is set."""
    rng = np.random.default_rng(r)
    up = torch.from_numpy(rng.random((2, 5, r)) < 0.5)
    words = t_kernel.up_words(up, 2, 5, -(-r // 32), "cpu")
    assert words.shape == (2, 5, -(-r // 32)) and words.dtype == torch.int32
    bits = (words[..., :, None] >> torch.arange(32, dtype=torch.int32)) & 1
    assert torch.equal(bits.reshape(2, 5, -1)[..., :r].bool(), up)
    assert bool((bits.reshape(2, 5, -1)[..., r:] == 0).all())
    full = t_kernel.up_words(None, 2, 5, 3, "cpu")
    assert bool((full == -1).all()) and full.shape == (2, 5, 3)
