"""The port's flash attention held against `repro.kernels.flash_attention`.

Here the wrapper runs its plain version (the tensors are on the CPU); it
is held against the reference's jnp oracle and, at a few small shapes,
against the reference's Pallas kernel in interpret mode.  The CUDA kernel
itself is compared with the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 8); its launch plan (grid,
TMA boxes and strides, shared memory) and the wrapper's refusals are
pure Python and are checked here.  Tolerances are tests/test_kernels.py's:
2e-3 in float32, 2e-2 in bfloat16.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_ops
from repro.kernels.flash_attention import ref as j_ref
from repro_torch.kernels import hopper
from repro_torch.kernels.flash_attention import kernel as t_kernel
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.kernels.flash_attention import ref as t_ref

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-3, atol=2e-3)


# the plain version against the jnp oracle: the same float32 arithmetic,
# so 1e-5 in float32
ORACLE_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
              "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _qkv(b, sq, sk, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32))


def _both(arrays, name):
    tdt, jdt = DTYPES[name]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


def _kernel_layout(x):
    """(B, S, heads, D) numpy -> (B*heads, S, D), the oracles' layout."""
    b, s, h, d = x.shape
    return np.ascontiguousarray(np.moveaxis(x, 2, 1).reshape(b * h, s, d))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# G 3, 6, 12 and D 8: the heads of granite-moe-3b-a800m and
# command-r-plus-104b and their SMOKE sizes
@pytest.mark.parametrize("b,s,h,kv,d", [
    (2, 256, 4, 2, 64), (1, 512, 8, 8, 128), (2, 128, 4, 1, 64),
    (1, 96, 6, 2, 8), (2, 64, 12, 2, 16), (1, 80, 12, 1, 8),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference_oracle(b, s, h, kv, d, dtype):
    q, k, v = (_kernel_layout(a) for a in _qkv(b, s, s, h, kv, d, 0))
    (tq, tk, tv), (jq, jk, jv) = _both((q, k, v), dtype)
    out = t_ref.flash_attention_ref(tq, tk, tv, n_rep=h // kv)
    expect = j_ref.flash_attention_ref(jq, jk, jv, n_rep=h // kv)
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(_f32(out), _f32(expect), **ORACLE_TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_non_causal_and_rectangular(causal):
    q, k, v = _qkv(1, 24, 40, 4, 2, 16, 1)
    q, k, v = (_kernel_layout(a) for a in (q, k, v))
    (tq, tk, tv), (jq, jk, jv) = _both((q, k, v), "float32")
    out = t_ref.flash_attention_ref(tq, tk, tv, n_rep=2, causal=causal)
    expect = j_ref.flash_attention_ref(jq, jk, jv, n_rep=2, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), rtol=1e-5,
                               atol=1e-6)


# Pallas interpret mode is slow on the CPU: a few small cases only
@pytest.mark.parametrize("b,s,h,kv,d", [(2, 128, 4, 2, 64),
                                        (1, 256, 8, 2, 32),
                                        (2, 128, 4, 1, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_matches_reference_pallas_interpret(b, s, h, kv, d, dtype):
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(b, s, s, h, kv, d, 2), dtype)
    out = t_ops.flash_attention(tq, tk, tv)
    expect = j_ops.flash_attention(jq, jk, jv, causal=True, interpret=True)
    assert out.shape == (b, s, h, d) and out.dtype == tq.dtype
    np.testing.assert_allclose(_f32(out), _f32(expect), **_tol(dtype))


def test_wrapper_takes_strided_views():
    """The model hands the kernel views (q sliced out of a wider tensor);
    the wrapper reads them as they are."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 40, 40, 4, 2, 16, 3))
    wide = torch.zeros(2, 40, 4, 48)
    wide[..., 8:24] = q
    view = wide[..., 8:24]
    assert not view.is_contiguous()
    torch.testing.assert_close(t_ops.flash_attention(view, k, v),
                               t_ops.flash_attention(q, k, v), rtol=0,
                               atol=0)


def test_cpu_takes_the_plain_version_and_counts_it():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 1, 16, 4))
    t_ops.reset_counts()
    t_ops.flash_attention(q, k, v)
    t_ops.flash_attention(q, k, v, impl="torch")
    assert (t_ops.plain_count(), t_ops.launch_count()) == (2, 0)


def test_cuda_impl_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 1, 16, 5))
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="unknown attention impl"):
        t_ops.flash_attention(q, k, v, impl="xla")
    assert t_kernel.launches == 0


# ------------------------------------------------------- the bf16 launch plan
# The wgmma kernel's host-side plan (grid, rows a block, TMA boxes and
# byte strides, shared memory) is pure Python: the CPU reaches it here.

PLAN_SHAPES = [  # (B, Sq, Sk, H, KV, D, causal)
    (1, 2048, 2048, 32, 8, 128, True), (1, 1000, 1000, 8, 2, 128, True),
    (1, 1025, 1025, 16, 2, 64, True), (2, 8, 8, 8, 1, 16, True),
    (2, 77, 77, 4, 4, 32, True), (1, 40, 100, 8, 8, 64, False),
    (1, 100, 40, 8, 4, 128, True), (1, 300, 300, 64, 1, 128, True),
    (1, 300, 300, 16, 1, 128, True), (1, 90, 90, 40, 2, 32, True),
    (2, 300, 300, 12, 4, 64, True), (1, 333, 333, 12, 2, 128, True),
    (1, 200, 200, 24, 2, 8, True), (1, 50, 90, 12, 1, 8, False)]


def _contiguous_strides(shape):
    return torch.empty(shape).stride()


def _plan(b, sq, sk, h, kv, d, causal):
    qs, ks = (b, sq, h, d), (b, sk, kv, d)
    return t_kernel.flash_plan(qs, _contiguous_strides(qs), ks,
                               _contiguous_strides(ks),
                               _contiguous_strides(ks), causal=causal)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_flash_plan_covers_every_query_row_once(shape):
    b, sq, sk, h, kv, d, causal = shape
    plan = _plan(*shape)
    gx, gy, gz = plan.grid
    assert (gy, gz) == (kv, b)
    g = h // kv
    per_c = t_kernel.ROWS // g
    seen = collections.Counter()
    for bx in range(gx):
        for by in range(gy):
            rows = plan.block_rows(bx, by)
            # each consumer's rows past (64 // G) G are idle, none else
            assert [r for r, row in enumerate(rows) if row is None] == [
                c * t_kernel.ROWS + rr for c in range(2)
                for rr in range(per_c * g, t_kernel.ROWS)]
            seen.update(row for row in rows
                        if row is not None and row[0] < sq)
    assert set(seen) == {(p, hh) for p in range(sq) for hh in range(h)}
    assert max(seen.values()) == 1
    assert plan.rows_per_block == 2 * t_kernel.ROWS == 128
    assert plan.positions_per_block == 2 * per_c


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_flash_plan_loads_each_needed_key_position_once(shape):
    """A block's K/V tiles cover, once each, the positions its rows attend
    to (all of Sk, or up to its last valid row when causal), and no tile
    lies wholly past them."""
    b, sq, sk, h, kv, d, causal = shape
    plan = _plan(*shape)
    for bx in range(plan.grid[0]):
        last = max(row[0] for row in plan.block_rows(bx, 0)
                   if row is not None and row[0] < sq)
        need = min(sk, last + 1) if causal else sk
        covered = [k0 + i for k0 in plan.kv_tiles(bx)
                   for i in range(plan.block_n)]
        assert sorted(covered) == list(range(len(covered)))
        assert need <= len(covered) < need + plan.block_n


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_flash_plan_boxes_strides_and_shared_memory(shape):
    b, sq, sk, h, kv, d, causal = shape
    plan = _plan(*shape)
    g = h // kv
    dp = max(d, 16)       # D = 8: a 16-wide band, zero past the tensor's 8
    for tmap in (plan.q_map, plan.k_map, plan.v_map):
        assert all(1 <= x <= hopper.BOX_LIMIT for x in tmap.box)
        assert all(s % 16 == 0 for s in tmap.strides)
        assert tmap.swizzle == tmap.box[0] * 2 <= 128
        assert tmap.dims[0] == d and dp % tmap.box[0] == 0
    # Q: (64 // G positions, G heads, a band of D) per consumer; K, V: one
    # kv head, BLOCK_N positions
    assert plan.q_map.box == (min(dp, 64), g, 64 // g, 1)
    assert plan.k_map.box == plan.v_map.box == (min(dp, 64), 1,
                                                plan.block_n, 1)
    # the bytes each barrier expects fill the tiles' used rows exactly
    bands = dp // plan.q_map.box[0]
    assert 2 * bands * plan.q_map.box_bytes == 2 * (64 // g) * g * dp * 2
    assert bands * plan.k_map.box_bytes == plan.block_n * dp * 2
    assert plan.smem_bytes <= hopper.SMEM_LIMIT
    assert plan.threads == 384


def test_flash_plan_reads_strided_views_without_a_copy():
    """q, k, v sliced out of one fused projection: the maps carry the
    views' strides (multiples of 16 bytes) and their extents."""
    qkv = torch.zeros(2, 300, 6, 64, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:5], qkv[:, :, 5:6]
    plan = t_kernel.flash_plan(q.shape, q.stride(), k.shape, k.stride(),
                               v.stride())
    assert plan.q_map.dims == (64, 4, 300, 2)
    assert plan.q_map.strides == (128, 6 * 64 * 2, 300 * 6 * 64 * 2)
    assert plan.k_map.strides == plan.v_map.strides == plan.q_map.strides
    assert plan.q_map.spec() == [4, 64, 4, 300, 2, 128, 768, 230400,
                                 64, 4, 16, 1, 128]
    assert len(plan.args) == 13 + 3 * hopper.MAP_SPEC_LEN


def test_flash_plan_smem_fits_for_every_head_dim():
    for d in t_kernel.HEAD_DIMS:
        assert _plan(1, 64, 64, 8, 2, d, True).smem_bytes <= \
            hopper.SMEM_LIMIT


@pytest.mark.parametrize("case", ["head_dim", "groups", "dtype", "rows16",
                                  "shapes"])
def test_wrapper_refusals_are_unchanged(case):
    """What the kernel does not take is refused before any launch: D not
    in HEAD_DIMS, H / KV past 64, a dtype other than float32 or bfloat16,
    rows not on 16 bytes, mismatched shapes."""
    bf = torch.bfloat16
    q, k = torch.zeros(1, 8, 8, 64, dtype=bf), torch.zeros(1, 8, 2, 64,
                                                           dtype=bf)
    if case == "head_dim":
        q, k = q[..., :48], k[..., :48]
        err, match = ValueError, "D in"
    elif case == "groups":
        q = torch.zeros(1, 8, 130, 64, dtype=bf)
        err, match = ValueError, "H / KV in"
    elif case == "dtype":
        q, k = q.half(), k.half()
        err, match = TypeError, "float32 or bfloat16"
    elif case == "rows16":
        q = torch.zeros(1, 8, 8, 68, dtype=bf)[..., 2:66]
        err, match = ValueError, "16-byte"
    else:
        k = torch.zeros(1, 8, 2, 32, dtype=bf)
        err, match = ValueError, "share B and D"
    with pytest.raises(err, match=match):
        t_kernel.check_inputs(q, k, k)
    assert t_kernel.check_inputs(*(torch.zeros(1, 8, 8, 64, dtype=bf),
                                   torch.zeros(1, 8, 2, 64, dtype=bf),
                                   torch.zeros(1, 8, 2, 64, dtype=bf))) == 4


def test_tma_map_spec_layout():
    """hop::encode_map's layout: rank, extents, byte strides and box
    innermost first, padded to 4 dims, then the swizzle."""
    a, b = hopper.tile_maps(200, 64, b_mn_major=True)
    assert a.spec() == [2, 64, 64, 1, 1, 128, 0, 0, 64, 64, 1, 1, 128]
    assert b.spec() == [2, 200, 64, 1, 1, 400, 0, 0, 64, 64, 1, 1, 128]
    assert b.box_bytes == 64 * 64 * 2
    with pytest.raises(ValueError, match="32, 64 or 128"):
        hopper.tma_map((8, 24), (24, 1), (8, 24))
