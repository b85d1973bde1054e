"""The port's (max,+) scan held against `repro.kernels.maxplus_scan`.

The plain PyTorch scan runs here; the reference runs its jnp oracles and,
at tiny shapes, its Pallas kernel in interpret mode.  The CUDA kernel
itself is compared with the plain scan on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.maxplus_scan import ops as j_ops
from repro.kernels.maxplus_scan import ref as j_ref
from repro_torch.kernels.maxplus_scan import kernel as t_kernel
from repro_torch.kernels.maxplus_scan import ops as t_ops
from repro_torch.kernels.maxplus_scan import ref as t_ref

RTOL = 1e-5     # the reference's own kernel tolerance (tests/test_kernels.py)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(size=shape), -1).astype(np.float32)
    svc = rng.exponential(size=shape).astype(np.float32)
    return arr + svc, svc


@pytest.mark.parametrize("shape", [(4, 1024), (1, 37), (2, 3, 500),
                                   (8, 4096), (5, 1)])
def test_plain_scan_matches_reference_oracle(shape):
    a, b = _inputs(shape, 0)
    ta, tb = t_ref.maxplus_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    ra, rb = jax.jit(j_ref.maxplus_scan_ref)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ra), rtol=RTOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(rb), rtol=RTOL)


def test_plain_scan_equals_sequential():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=(3, 257)))
    b = torch.from_numpy(rng.exponential(size=(3, 257)))
    ra, rb = t_ref.maxplus_scan_ref(a, b)
    sa, sb = t_ref.maxplus_scan_sequential(a, b)
    np.testing.assert_allclose(ra.numpy(), sa.numpy(), rtol=1e-12)
    np.testing.assert_allclose(rb.numpy(), sb.numpy(), rtol=1e-12)
    ja, jb = j_ref.maxplus_scan_sequential(jnp.asarray(a.numpy()),
                                           jnp.asarray(b.numpy()))
    np.testing.assert_allclose(sa.numpy(), np.asarray(ja), rtol=RTOL)


@pytest.mark.parametrize("shape", [(3, 300), (2, 2, 77)])
def test_wrapper_matches_reference_pallas_interpret(shape):
    a, b = _inputs(shape, 2)
    ta, tb = t_ops.maxplus_scan(torch.from_numpy(a), torch.from_numpy(b))
    ra, rb = j_ops.maxplus_scan(jnp.asarray(a), jnp.asarray(b),
                                interpret=True)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ra), rtol=RTOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(rb), rtol=RTOL)


@pytest.mark.parametrize("with_b", [False, True])
def test_seeded_scan_matches_reference(with_b):
    a, b = _inputs((4, 300), 3)
    rng = np.random.default_rng(4)
    ca = rng.normal(size=4).astype(np.float32) * 50.0
    cb = rng.exponential(size=4).astype(np.float32) if with_b else None
    ta, tb = t_ops.maxplus_scan_seeded(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(ca),
        None if cb is None else torch.from_numpy(cb))
    ra, rb = j_ops.maxplus_scan_seeded(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(ca),
        None if cb is None else jnp.asarray(cb), interpret=True)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ra), rtol=RTOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(rb), rtol=RTOL)
    # seeding is composition BEFORE the scan: scanning [seed, x] equals it
    seed_a = ca if cb is None else ca
    seed_b = np.zeros(4, np.float32) if cb is None else cb
    fa, fb = t_ref.maxplus_scan_sequential(
        torch.from_numpy(np.concatenate([seed_a[:, None], a], -1)),
        torch.from_numpy(np.concatenate([seed_b[:, None], b], -1)))
    np.testing.assert_allclose(ta.numpy(), fa[:, 1:].numpy(), rtol=RTOL)
    np.testing.assert_allclose(tb.numpy(), fb[:, 1:].numpy(), rtol=RTOL)


@pytest.mark.parametrize("seeded", [False, True])
def test_out_a_only_equals_the_two_output_out_a(seeded):
    """``with_b=False`` (what the simulator's FCFS queues call) returns
    the two-output call's out_a and no out_b on the plain path."""
    a, b = map(torch.from_numpy, _inputs((3, 300), 7))
    if seeded:
        carry = torch.linspace(0.0, 40.0, 3)
        both = t_ops.maxplus_scan_seeded(a, b, carry, 0.5 * carry)
        only = t_ops.maxplus_scan_seeded(a, b, carry, 0.5 * carry,
                                         with_b=False)
    else:
        both = t_ops.maxplus_scan(a, b)
        only = t_ops.maxplus_scan(a, b, with_b=False)
    assert only[1] is None
    assert torch.equal(only[0], both[0])


def test_resolve_scan_impl():
    assert t_ops.resolve_scan_impl("auto", "cpu") == "torch"
    assert t_ops.resolve_scan_impl("auto", "cuda") == "cuda"
    assert t_ops.resolve_scan_impl("auto") == "cuda"     # the default device
    assert t_ops.resolve_scan_impl("torch", "cuda") == "torch"
    with pytest.raises(ValueError, match="unknown scan impl"):
        t_ops.resolve_scan_impl("pallas")


def test_cuda_impl_refuses_cpu_tensors_and_counts_nothing():
    """No fallback: asking for the kernel on CPU tensors raises before any
    build or launch, and the plain CPU path never counts a launch."""
    a, b = _inputs((2, 64), 5)
    before = t_ops.launch_count()
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_ops.maxplus_scan(torch.from_numpy(a), torch.from_numpy(b),
                           impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_kernel.maxplus_scan_cuda(torch.from_numpy(a), torch.from_numpy(b))
    t_ops.maxplus_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert t_ops.launch_count() == before


def test_kernel_source_is_packaged():
    src = t_kernel.SOURCES[0]
    assert src.exists() and src.suffix == ".cu"
    text = src.read_text()
    assert "maxplus_scan_pallas" in text          # names what it replaces
    for name in ("maxplus_scan_f32", "maxplus_scan_f64"):
        assert f'extern "C" int {name}' in text
    assert "arch=compute_90a,code=sm_90a" in t_kernel.NVCC_FLAGS
