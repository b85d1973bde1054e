"""The port's decode attention held against
`repro.kernels.decode_attention`.

Here the wrapper runs its plain version (the tensors are on the CPU); it
is held against the reference's jnp oracle and, at a few small shapes,
against the reference's Pallas kernel in interpret mode.  The CUDA kernel
itself is compared with the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 9).  Tolerances are
tests/test_kernels.py's: 2e-3 in float32, 2e-2 in bfloat16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as j_ops
from repro.kernels.decode_attention import ref as j_ref
from repro_torch.kernels import hopper
from repro_torch.kernels.decode_attention import kernel as t_kernel
from repro_torch.kernels.decode_attention import ops as t_ops
from repro_torch.kernels.decode_attention import ref as t_ref

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-3, atol=2e-3)


# the plain version against the jnp oracle: the same float32 arithmetic,
# so 1e-5 in float32
ORACLE_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
              "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _qkv(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32))


def _both(arrays, name):
    tdt, jdt = DTYPES[name]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# G 3, 6, 12 and D 8: the heads of granite-moe-3b-a800m and
# command-r-plus-104b and their SMOKE sizes
@pytest.mark.parametrize("b,s,h,kv,d", [
    (2, 1024, 8, 2, 64), (1, 512, 4, 4, 128), (2, 512, 16, 8, 64),
    (2, 300, 6, 2, 8), (1, 256, 12, 2, 64), (2, 200, 12, 1, 8),
])
@pytest.mark.parametrize("where", ["first", "mid", "last"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference_oracle(b, s, h, kv, d, where,
                                                dtype):
    length = {"first": 0, "mid": s // 2 + 3, "last": s - 1}[where]
    q, k, v = _qkv(b, s, h, kv, d, 0)
    g = h // kv
    q = q.reshape(b * kv, g, d)
    k = np.ascontiguousarray(np.moveaxis(k, 2, 1).reshape(b * kv, s, d))
    v = np.ascontiguousarray(np.moveaxis(v, 2, 1).reshape(b * kv, s, d))
    (tq, tk, tv), (jq, jk, jv) = _both((q, k, v), dtype)
    out = t_ref.decode_attention_ref(tq, tk, tv, length)
    expect = j_ref.decode_attention_ref(jq, jk, jv, jnp.asarray(length))
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(_f32(out), _f32(expect), **ORACLE_TOL[dtype])


# Pallas interpret mode is slow on the CPU: a few small cases only
@pytest.mark.parametrize("b,s,h,kv,d,length", [
    (2, 512, 8, 2, 64, 0), (1, 512, 4, 4, 32, 300),
    (2, 512, 16, 8, 16, 511)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_matches_reference_pallas_interpret(b, s, h, kv, d, length,
                                                    dtype):
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(b, s, h, kv, d, 1), dtype)
    out = t_ops.decode_attention(tq, tk, tv, length)
    expect = j_ops.decode_attention(jq, jk, jv, jnp.asarray(length),
                                    interpret=True)
    assert out.shape == (b, 1, h, d) and out.dtype == tq.dtype
    np.testing.assert_allclose(_f32(out), _f32(expect), **_tol(dtype))


def test_wrapper_takes_one_layer_of_the_model_cache():
    """The model passes ``cache["k"][i]``, a view into (L, B, S, KV, D)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 32, 4, 2, 16, 3))
    big_k = torch.zeros(3, *k.shape)
    big_v = torch.zeros(3, *v.shape)
    big_k[1], big_v[1] = k, v
    torch.testing.assert_close(t_ops.decode_attention(q, big_k[1], big_v[1], 20),
                               t_ops.decode_attention(q, k, v, 20), rtol=0,
                               atol=0)


# One block an SM: 132 SMs hold 2 splits of 64 rows; a split walks at
# least 32 tiles of 32 positions (a block's fixed cost outweighs more
# blocks in flight).
@pytest.mark.parametrize("n,rows,sms,expect", [
    (2101, 64, 132, (1056, 2)),        # chip_smoke phase 9, first shape
    (32768, 64, 132, (16384, 2)),      # decode_32k at a one-chip batch
    (1, 64, 132, (32, 1)),             # one position: one split
    (5000, 4, 132, (1280, 4)),         # few rows: as many as the tiles allow
])
def test_split_plan_covers_every_position_once(n, rows, sms, expect):
    chunk, splits = t_kernel.split_plan(n, rows, sms)
    assert (chunk, splits) == expect
    assert (splits - 1) * chunk < n <= splits * chunk
    assert chunk % t_kernel.BLOCK_N == 0
    assert rows * splits <= sms or splits == 1


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 64, 2101, 32767, 32768])
def test_decode_tiles_count_every_position_once_and_read_none_past_n(n):
    """Tile t counts positions [t BLOCK_N, min((t + 1) BLOCK_N, n)) and
    loads BLOCK_N rows that end at or before n (the last tile shifted
    back; rows before 0 come as TMA's zeros)."""
    bn = t_kernel.BLOCK_N
    chunk, splits = t_kernel.split_plan(n, 64, 132)
    per = chunk // bn
    counted = []
    for split in range(splits):
        for t in range(split * per, min((split + 1) * per, -(-n // bn))):
            start, lo = t_kernel.DecodePlan.tile_rows(t, n)
            assert start <= lo and start + bn <= max(n, bn)
            assert start + bn <= n or start < 0
            counted += [p for p in range(start, start + bn)
                        if lo <= p < n]
    assert counted == list(range(n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", t_kernel.HEAD_DIMS)
@pytest.mark.parametrize("h,kv", [(32, 8), (6, 2), (12, 1), (16, 1)])
def test_decode_plan_boxes_strides_and_shared_memory(dtype, d, h, kv):
    """The maps cover the cache's full S with boxes of one band of a
    tile; a bf16 D of 8 takes a 16-wide band (zeros past the tensor's
    8); the ring of STAGES stages fits a block's shared memory."""
    cache = torch.zeros(3, 2, 600, kv, d, dtype=dtype)
    k, v = cache[1], cache[2]
    q = torch.zeros(2, 1, h, d, dtype=dtype)
    es = q.element_size()
    plan = t_kernel.decode_plan(q.shape, q.stride(), k.shape, k.stride(),
                                v.stride(), es)
    assert plan.groups == h // kv and plan.d == d
    assert plan.dp == (16 if (d, es) == (8, 2) else d)
    for tmap in (plan.k_map, plan.v_map):
        assert tmap.dims == (d, kv, 600, 2)
        assert tmap.box == (min(plan.dp, 128 // es), 1, t_kernel.BLOCK_N, 1)
        assert tmap.swizzle == tmap.box[0] * es
        assert all(s % 16 == 0 for s in tmap.strides)
    assert plan.k_map.strides == plan.v_map.strides
    assert plan.smem_bytes <= hopper.SMEM_LIMIT
    stages = t_kernel.STAGES
    assert plan.smem_bytes == (1024 + stages * 2 * t_kernel.BLOCK_N * plan.dp
                               * es + 16 * stages + 16)
    assert len(plan.args) == 11 + 2 * hopper.MAP_SPEC_LEN


def test_cpu_takes_the_plain_version_and_counts_it():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 1, 16, 4))
    t_ops.reset_counts()
    t_ops.decode_attention(q, k, v, 5)
    t_ops.decode_attention(q, k, v, 5, impl="torch")
    assert (t_ops.plain_count(), t_ops.launch_count()) == (2, 0)


def test_cuda_impl_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 1, 16, 5))
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_ops.decode_attention(q, k, v, 3, impl="cuda")
    assert t_kernel.launches == 0
