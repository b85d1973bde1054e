"""The port's CIN layer held against `repro.kernels.cin_fuse`.

Here the wrapper runs its plain version (the tensors are on the CPU); it
is held against the reference's jnp oracle (`cin_layer_ref`) and the
reference's Pallas kernel in interpret mode, in float32, to a relative L2
error of 1e-5 (float32 rounding over K = Hk m <= 1521 terms is ~1e-7).
The CUDA kernel itself is compared with the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 14); its launch plan (grid,
W's TMA box, shared memory, split-K count) and the wrapper's refusals are
pure Python and are checked here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cin_fuse import ops as j_ops
from repro.kernels.cin_fuse import ref as j_ref
from repro_torch.kernels import hopper
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


# ------------------------------------------------------- the bf16 launch plan
# The wgmma kernel's host-side plan (grid, W's TMA box and strides, shared
# memory, split-K count) is pure Python: the CPU reaches it here.

PLAN_SHAPES = [  # (B, Hk, m, D, O): xDeepFM's layers at its two serving
    # batches, ragged and tiny batches, the card tests' narrow O, a wide O
    (512, 200, 39, 10, 200), (262_144, 200, 39, 10, 200),
    (262_144, 39, 39, 10, 200), (3, 39, 39, 10, 200), (1000, 12, 39, 10, 13),
    (4096, 12, 39, 10, 16), (77, 8, 8, 4, 300), (5, 200, 64, 10, 24)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_cin_plan_covers_rows_columns_and_k_once(shape):
    b, hk, m, d, o = shape
    plan = t_kernel.cin_plan(b, hk, m, d, o)
    gx, gy, gz = plan.grid
    rows = [r for bx in range(gx) for r in plan.block_rows(bx)]
    cols = [c for by in range(gy) for c in plan.block_cols(by)]
    ks = [k for bz in range(gz) for k in plan.block_k(bz)]
    assert rows == list(range(b * d))
    assert cols == list(range(o))
    assert ks == list(range(hk * m))
    assert all(len(plan.block_k(bz)) > 0 for bz in range(gz))
    assert plan.rows_per_block == 128 and plan.threads == 384
    assert 16 * plan.k_steps >= m > 16 * (plan.k_steps - 1)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_cin_plan_box_strides_and_shared_memory(shape):
    b, hk, m, d, o = shape
    plan = t_kernel.cin_plan(b, hk, m, d, o)
    w = plan.w_map
    # W read as (Hk, m, O): one h, 16 k_steps rows (those past m are out
    # of bounds, so zeros), a band of <= 64 columns
    assert w.dims == (plan.o_pad, m, hk)
    assert w.box == (min(plan.n_tile, 64), 16 * plan.k_steps, 1)
    assert all(1 <= x <= hopper.BOX_LIMIT for x in w.box)
    assert all(s % 16 == 0 for s in w.strides)
    assert w.swizzle == 2 * w.box[0]
    assert plan.n_tile % 8 == 0 and plan.n_tile in t_kernel.N_TILES + (
        t_kernel.WIDE_TILE,)
    assert plan.smem_bytes <= hopper.SMEM_LIMIT
    assert len(plan.args) == 14 + hopper.MAP_SPEC_LEN


@pytest.mark.parametrize("b,split", [(262_144, False), (4096, False),
                                     (1000, False), (512, True), (3, True)])
def test_cin_plan_splits_k_for_small_batches_only(b, split):
    """serve_bulk fills the card with row tiles; serve_p99 (B = 512, 40
    row tiles on 132 SMs) splits K over h, as far as one wave holds."""
    plan = t_kernel.cin_plan(b, 200, 39, 10, 200)
    assert (plan.splits > 1) == split
    assert plan.grid[0] * plan.splits <= max(132, plan.grid[0])
    assert t_kernel.cin_plan(b, 200, 39, 10, 200, n_sm=1).splits == 1


def test_cin_plan_pads_w_rows_to_16_bytes():
    """TMA needs W's rows on 16 bytes: O = 13, or W not 16-byte aligned,
    is handed over as a copy padded to a multiple of 8 columns."""
    assert not t_kernel.cin_plan(512, 200, 39, 10, 200).pad_w
    narrow = t_kernel.cin_plan(512, 12, 39, 10, 13)
    assert narrow.pad_w and narrow.o_pad == 16 and narrow.n_tile == 16
    assert t_kernel.cin_plan(512, 12, 39, 10, 16, w_aligned=False).pad_w


@pytest.mark.parametrize("case", ["fields", "row_values", "dtype", "shapes",
                                  "contiguous"])
def test_wrapper_refusals_are_unchanged(case):
    """Refused before any launch: m > 64 in bfloat16, Hk + m > 768, a
    dtype other than float32 or bfloat16, shapes that disagree, a
    non-contiguous input."""
    bf = torch.bfloat16
    xk, x0 = torch.zeros(2, 3, 4, dtype=bf), torch.zeros(2, 5, 4, dtype=bf)
    w = torch.zeros(15, 7, dtype=bf)
    if case == "fields":
        x0, w = torch.zeros(2, 65, 4, dtype=bf), torch.zeros(195, 7, dtype=bf)
        err, match = ValueError, "fields"
    elif case == "row_values":
        xk, w = torch.zeros(2, 764, 4), torch.zeros(764 * 5, 7)
        x0 = x0.float()
        err, match = ValueError, "exceeds"
    elif case == "dtype":
        xk, x0, w = xk.half(), x0.half(), w.half()
        err, match = TypeError, "float32 or bfloat16"
    elif case == "shapes":
        w = torch.zeros(14, 7, dtype=bf)
        err, match = ValueError, "agree"
    else:
        xk = torch.zeros(2, 4, 3, dtype=bf).transpose(1, 2)
        err, match = ValueError, "contiguous"
    with pytest.raises(err, match=match):
        t_kernel.check_inputs(xk, x0, w)
    t_kernel.check_inputs(torch.zeros(2, 3, 4, dtype=bf),
                          torch.zeros(2, 5, 4, dtype=bf),
                          torch.zeros(15, 7, dtype=bf))
