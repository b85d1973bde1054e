"""The port's flash attention held against `repro.kernels.flash_attention`.

Here the wrapper runs its plain version (the tensors are on the CPU); it
is held against the reference's jnp oracle and, at a few small shapes,
against the reference's Pallas kernel in interpret mode.  The CUDA kernel
itself is compared with the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 8).  Tolerances are
tests/test_kernels.py's: 2e-3 in float32, 2e-2 in bfloat16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_ops
from repro.kernels.flash_attention import ref as j_ref
from repro_torch.kernels.flash_attention import kernel as t_kernel
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.kernels.flash_attention import ref as t_ref

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-3, atol=2e-3)


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


@pytest.mark.parametrize("b,s,h,kv,d", [
    (2, 256, 4, 2, 64), (1, 512, 8, 8, 128), (2, 128, 4, 1, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference_oracle(b, s, h, kv, d, dtype):
    q, k, v = (_kernel_layout(a) for a in _qkv(b, s, s, h, kv, d, 0))
    (tq, tk, tv), (jq, jk, jv) = _both((q, k, v), dtype)
    out = t_ref.flash_attention_ref(tq, tk, tv, n_rep=h // kv)
    expect = j_ref.flash_attention_ref(jq, jk, jv, n_rep=h // kv)
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(_f32(out), _f32(expect), **_tol(dtype))


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
