"""The port's EmbeddingBag held against `repro.kernels.embedding_bag` and
the model op `repro.models.recsys.embedding_bag`.

Here the wrapper runs its plain version (the tensors are on the CPU); it
is held against the reference's jnp oracle, against the reference's
Pallas kernel in interpret mode (prefix masks, the kernel's contract) and
against the model op for any mask.  The CUDA kernel itself is compared
with the plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py phase 13).  float32 throughout, rtol = atol = 1e-5, as
tests/test_kernels.py holds the Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as j_ops
from repro.kernels.embedding_bag import ref as j_ref
from repro.models import recsys as j_recsys
from repro_torch.kernels.embedding_bag import kernel as t_kernel
from repro_torch.kernels.embedding_bag import ops as t_ops
from repro_torch.kernels.embedding_bag import ref as t_ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _bags(r, d, b, f, m, seed, prefix=True):
    """table (r, d), ids (b, f, m) int32 and a mask: the first counts
    entries of each bag (prefix), or any subset."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((r, d)).astype(np.float32)
    ids = rng.integers(0, r, (b, f, m)).astype(np.int32)
    if prefix:
        counts = rng.integers(0, m + 1, (b, f))
        mask = np.arange(m)[None, None, :] < counts[:, :, None]
    else:
        mask = rng.random((b, f, m)) < 0.5
    return table, ids, mask


@pytest.mark.parametrize("r,d,b,f,m", [
    (1000, 16, 4, 6, 3), (512, 8, 8, 2, 1), (4096, 64, 2, 4, 5),
    (300, 1, 5, 7, 4), (2000, 10, 3, 39, 4),
])
def test_plain_version_matches_reference_oracle(r, d, b, f, m):
    table, ids, mask = _bags(r, d, b, f, m, 0)
    counts = mask.sum(-1).reshape(-1).astype(np.int32)
    flat = np.where(mask, ids, 0).reshape(b * f, m)
    out = t_ref.embedding_bag_ref(torch.from_numpy(table),
                                  torch.from_numpy(flat),
                                  torch.from_numpy(counts))
    expect = j_ref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(flat),
                                     jnp.asarray(counts))
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL)


# Pallas interpret mode runs one grid step per (bag, entry): small shapes
@pytest.mark.parametrize("r,d,b,f,m", [
    (256, 8, 3, 5, 4), (100, 1, 2, 6, 3), (512, 16, 2, 3, 4),
])
def test_wrapper_matches_reference_pallas_interpret(r, d, b, f, m):
    table, ids, mask = _bags(r, d, b, f, m, 1)
    out = t_ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                              torch.from_numpy(mask))
    expect = j_ops.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                 jnp.asarray(mask), interpret=True)
    assert out.shape == (b, f, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL)


@pytest.mark.parametrize("d", [1, 10, 16])
@pytest.mark.parametrize("prefix", [True, False])
def test_wrapper_matches_reference_model_op(d, prefix):
    """Any mask: the model op's contract, which the Pallas wrapper's
    counts do not keep for a non-prefix mask."""
    table, ids, mask = _bags(777, d, 6, 39, 4, 2, prefix=prefix)
    out = t_ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                              torch.from_numpy(mask))
    expect = j_recsys.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                    jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL)


def test_masked_ids_are_never_read_and_empty_bags_are_zero():
    table, ids, mask = _bags(50, 4, 2, 3, 4, 3, prefix=False)
    mask[0, 0] = False                        # an all-masked bag
    far = np.where(mask, ids, 10 ** 9).astype(np.int64)   # past the table
    args = [torch.from_numpy(x) for x in (table, far, mask)]
    out = t_ops.embedding_bag(*args)
    same = t_ops.embedding_bag(*[torch.from_numpy(x)
                                 for x in (table, ids, mask)])
    torch.testing.assert_close(out, same, rtol=0, atol=0)
    assert torch.equal(out[0, 0], torch.zeros(4))


def test_cpu_takes_the_plain_version_and_counts_it():
    args = [torch.from_numpy(x) for x in _bags(20, 3, 2, 2, 2, 4)]
    t_ops.reset_counts()
    t_ops.embedding_bag(*args)
    t_ops.embedding_bag(*args, impl="torch")
    assert (t_ops.plain_count(), t_ops.launch_count()) == (2, 0)


@pytest.mark.parametrize("d,dtype,unit", [
    (10, torch.bfloat16, 4), (1, torch.bfloat16, 2), (8, torch.bfloat16, 16),
    (16, torch.bfloat16, 16), (128, torch.bfloat16, 16),
    (6, torch.bfloat16, 4), (10, torch.float32, 8), (1, torch.float32, 4),
    (3, torch.float32, 4), (16, torch.float32, 16)])
def test_bag_plan_takes_the_widest_unit_a_row_allows(d, dtype, unit):
    """A lane's load is the widest of 16/8/4/2 bytes dividing a row: 5 x 4
    bytes at xDeepFM's D = 10 bf16, 2 bytes for the wide D = 1 table."""
    table = torch.zeros((64, d), dtype=dtype)
    ids = torch.zeros((5, 39, 4), dtype=torch.int64)
    mask = torch.ones((5, 39, 4), dtype=torch.bool)
    plan = t_kernel.bag_plan(table, ids, mask)
    assert plan == t_kernel.BagPlan(unit, True)
    assert (d * table.element_size()) % plan.unit_bytes == 0


def test_bag_plan_narrows_for_unaligned_views():
    """A table, ids or mask that starts off alignment (a view at an
    offset) takes narrower loads; M other than 4 takes the scalar path."""
    table = torch.zeros(64 * 16 + 1, dtype=torch.bfloat16)[1:].view(64, 16)
    ids = torch.zeros(5 * 4 + 1, dtype=torch.int32)[1:].view(5, 4)
    mask = torch.ones(5 * 4 + 1, dtype=torch.bool)[1:].view(5, 4)
    assert t_kernel.bag_plan(table, ids, mask) == t_kernel.BagPlan(2, False)
    aligned = torch.zeros(5, 4, dtype=torch.int32)
    assert not t_kernel.bag_plan(table, aligned, mask).vec4
    assert t_kernel.bag_plan(table, aligned, torch.ones(5, 4)).vec4
    three = torch.zeros(5, 3, dtype=torch.int32)
    assert not t_kernel.bag_plan(table, three,
                                 torch.ones(5, 3, dtype=torch.bool)).vec4


def test_cuda_impl_refuses_cpu_tensors():
    args = [torch.from_numpy(x) for x in _bags(20, 3, 2, 2, 2, 5)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_ops.embedding_bag(*args, impl="cuda")
    assert t_kernel.launches == 0
