"""The port's CIN layer held against `repro.kernels.cin_fuse`.

Here the wrapper runs its plain version (the tensors are on the CPU); it
is held against the reference's jnp oracle (`cin_layer_ref`) and the
reference's Pallas kernel in interpret mode, in float32, to a relative L2
error of 1e-5 (float32 rounding over K = Hk m <= 1521 terms is ~1e-7).
The CUDA kernel itself is compared with the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 14).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cin_fuse import ops as j_ops
from repro.kernels.cin_fuse import ref as j_ref
from repro_torch.kernels.cin_fuse import kernel as t_kernel
from repro_torch.kernels.cin_fuse import ops as t_ops
from repro_torch.kernels.cin_fuse import ref as t_ref

RTOL = 1e-5

# tests/test_kernels.py's shapes, then ragged batches (not multiples of
# the Pallas wrapper's block, which pads them)
SHAPES = [(512, 12, 6, 10, 16), (300, 8, 8, 4, 8), (64, 39, 39, 10, 200),
          (77, 39, 39, 10, 200), (5, 200, 39, 10, 16)]


def _inputs(b, hk, m, d, o, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hk, d)).astype(np.float32),
            rng.standard_normal((b, m, d)).astype(np.float32),
            (0.1 * rng.standard_normal((hk * m, o))).astype(np.float32))


def _rel_l2(x, y):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return np.linalg.norm(x - y) / np.linalg.norm(y)


@pytest.mark.parametrize("b,hk,m,d,o", SHAPES)
def test_plain_version_matches_reference_oracle(b, hk, m, d, o):
    xk, x0, w = _inputs(b, hk, m, d, o, 0)
    out = t_ops.cin_layer(*(torch.from_numpy(a) for a in (xk, x0, w)))
    expect = j_ref.cin_layer_ref(*(jnp.asarray(a) for a in (xk, x0, w)))
    assert out.shape == (b, o, d) and out.dtype == torch.float32
    assert _rel_l2(out.numpy(), expect) <= RTOL


@pytest.mark.parametrize("b,hk,m,d,o", SHAPES[1:4])
def test_plain_version_matches_reference_pallas_interpret(b, hk, m, d, o):
    xk, x0, w = _inputs(b, hk, m, d, o, 1)
    out = t_ref.cin_layer_ref(*(torch.from_numpy(a) for a in (xk, x0, w)))
    expect = j_ops.cin_layer(*(jnp.asarray(a) for a in (xk, x0, w)),
                             block_b=64, interpret=True)
    assert _rel_l2(out.numpy(), expect) <= RTOL


def test_bfloat16_rounds_the_outer_product_like_the_reference():
    """The outer product in the input dtype, the sum in float32: equal to
    the float32 oracle on inputs whose products bfloat16 holds exactly."""
    rng = np.random.default_rng(2)
    xk, x0 = (rng.integers(-8, 9, s).astype(np.float32)
              for s in ((6, 5, 4), (6, 3, 4)))
    w = rng.integers(-4, 5, (15, 7)).astype(np.float32)
    out = t_ops.cin_layer(*(torch.from_numpy(a).to(torch.bfloat16)
                            for a in (xk, x0, w)))
    expect = np.asarray(j_ref.cin_layer_ref(*(jnp.asarray(a)
                                              for a in (xk, x0, w))))
    assert out.dtype == torch.bfloat16
    # integer sums below 2^8 in magnitude are exact in bfloat16
    exact = np.abs(expect) < 256
    np.testing.assert_array_equal(out.float().numpy()[exact], expect[exact])


def test_cpu_takes_the_plain_version_and_counts_it():
    args = [torch.from_numpy(a) for a in _inputs(3, 2, 2, 2, 3, 3)]
    t_ops.reset_counts()
    t_ops.cin_layer(*args)
    t_ops.cin_layer(*args, impl="torch")
    assert (t_ops.plain_count(), t_ops.launch_count()) == (2, 0)


def test_cuda_impl_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _inputs(3, 2, 2, 2, 3, 4)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_ops.cin_layer(*args, impl="cuda")
    assert t_kernel.launches == 0
