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
from repro_torch.kernels.decode_attention import kernel as t_kernel
from repro_torch.kernels.decode_attention import ops as t_ops
from repro_torch.kernels.decode_attention import ref as t_ref

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-3, atol=2e-3)


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


@pytest.mark.parametrize("b,s,h,kv,d", [
    (2, 1024, 8, 2, 64), (1, 512, 4, 4, 128), (2, 512, 16, 8, 64),
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
    np.testing.assert_allclose(_f32(out), _f32(expect), **_tol(dtype))


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


@pytest.mark.parametrize("n,rows,sms,expect", [
    (2101, 64, 132, (234, 9)),         # chip_smoke phase 9, first shape
    (32768, 64, 132, (1024, 32)),      # decode_32k at a one-chip batch
    (1, 64, 132, (64, 1)),             # one position: one split
    (5000, 4, 132, (64, 79)),          # few rows: splits to fill the card
])
def test_split_plan_covers_every_position_once(n, rows, sms, expect):
    chunk, splits = t_kernel.split_plan(n, rows, sms)
    assert (chunk, splits) == expect
    assert (splits - 1) * chunk < n <= splits * chunk


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
