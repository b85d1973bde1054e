"""The port's segmented (max,+) scan held against `repro.kernels.maxplus_scan`.

The plain PyTorch scan runs here; the reference runs its jnp oracle and,
at small shapes, its Pallas kernel in interpret mode.  Flags are random
segment heads, shapes ragged.  The CUDA kernel itself is compared with
the plain scan on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.maxplus_scan import ops as j_ops
from repro.kernels.maxplus_scan import ref as j_ref
from repro_torch.kernels.jsq_route import kernel as jsq_kernel
from repro_torch.kernels.maxplus_scan import kernel as t_kernel
from repro_torch.kernels.maxplus_scan import ops as t_ops
from repro_torch.kernels.maxplus_scan import ref as t_ref

RTOL = {np.float32: 1e-6, np.float64: 1e-12}


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _inputs(shape, seed, dtype=np.float32, p_flag=0.05):
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(size=shape), -1)
    svc = rng.exponential(size=shape)
    f = rng.random(shape) < p_flag
    f[..., 0] = True
    return (arr + svc).astype(dtype), svc.astype(dtype), f


def _check(got, want, dtype):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=RTOL[dtype])


@pytest.mark.parametrize("shape", [(4, 1024), (1, 37), (2, 3, 500),
                                   (5, 4097), (3, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_segment_scan_matches_reference_oracle(x64, shape, dtype):
    a, b, f = _inputs(shape, 0, dtype)
    got = t_ref.maxplus_segment_scan_ref(*map(torch.from_numpy, (a, b, f)))
    want = jax.jit(j_ref.maxplus_segment_scan_ref)(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(f))
    _check(got, want, dtype)


@pytest.mark.parametrize("shape", [(3, 300), (2, 2, 77)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wrapper_matches_reference_pallas_interpret(x64, shape, dtype):
    a, b, f = _inputs(shape, 1, dtype, p_flag=0.1)
    got = t_ops.maxplus_segment_scan(*map(torch.from_numpy, (a, b, f)))
    want = j_ops.maxplus_segment_scan(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(f), interpret=True)
    _check(got, want, dtype)


@pytest.mark.parametrize("shape", [(3, 300), (2, 2, 77)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_out_a_only_matches_two_outputs_and_reference(x64, shape, dtype):
    """``with_b=False`` (the simulator's entry) returns the two-output
    call's out_a and None; out_a agrees with the Pallas kernel."""
    a, b, f = _inputs(shape, 7, dtype, p_flag=0.1)
    ta, tb, tf = map(torch.from_numpy, (a, b, f))
    only_a, none = t_ops.maxplus_segment_scan(ta, tb, tf, with_b=False)
    both_a, both_b = t_ops.maxplus_segment_scan(ta, tb, tf)
    assert none is None and both_b is not None
    assert torch.equal(only_a, both_a)
    want_a, _ = j_ops.maxplus_segment_scan(jnp.asarray(a), jnp.asarray(b),
                                           jnp.asarray(f), interpret=True)
    np.testing.assert_allclose(only_a.numpy(), np.asarray(want_a),
                               rtol=RTOL[dtype])


def test_plain_segment_scan_equals_sequential():
    a, b, f = _inputs((3, 257), 2, np.float64, p_flag=0.2)
    got = t_ref.maxplus_segment_scan_ref(*map(torch.from_numpy, (a, b, f)))
    want = t_ref.maxplus_segment_scan_sequential(
        *map(torch.from_numpy, (a, b, f)))
    _check(got, [w.numpy() for w in want], np.float64)
    ja, jb = j_ref.maxplus_segment_scan_sequential(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(f))
    np.testing.assert_allclose(want[0].numpy(), np.asarray(ja), rtol=1e-6)


def test_segments_are_independent_plain_scans():
    """Each flagged run is exactly the plain scan of that run."""
    a, b, f = _inputs((1, 600), 3, np.float64, p_flag=0.02)
    out_a, out_b = t_ref.maxplus_segment_scan_ref(
        *map(torch.from_numpy, (a, b, f)))
    heads = list(np.flatnonzero(f[0])) + [600]
    for lo, hi in zip(heads[:-1], heads[1:]):
        pa, pb = t_ref.maxplus_scan_ref(torch.from_numpy(a[:, lo:hi]),
                                        torch.from_numpy(b[:, lo:hi]))
        np.testing.assert_allclose(out_a[:, lo:hi].numpy(), pa.numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(out_b[:, lo:hi].numpy(), pb.numpy(),
                                   rtol=1e-12)


@pytest.mark.parametrize("kind", ["bool", "uint8", "float"])
def test_flag_dtypes_and_broadcast_rows_agree(kind):
    """(S, 1, n) flags shared by p rows equal the materialized (S, p, n)
    flags, whatever the flag dtype (float cuts where > 0)."""
    a, b, _ = _inputs((3, 5, 200), 4, np.float64)
    f = np.random.default_rng(5).random((3, 1, 200)) < 0.1
    conv = {"bool": f, "uint8": f.astype(np.uint8),
            "float": f.astype(np.float64)}[kind]
    got = t_ops.maxplus_segment_scan(torch.from_numpy(a), torch.from_numpy(b),
                                     torch.from_numpy(conv))
    want = t_ref.maxplus_segment_scan_sequential(
        torch.from_numpy(a), torch.from_numpy(b),
        torch.from_numpy(np.broadcast_to(f, a.shape).copy()))
    _check(got, [w.numpy() for w in want], np.float64)


@pytest.mark.parametrize("fshape,rows", [((3, 1, 77), 3), ((1, 5, 77), 15),
                                         ((77,), 1), ((3, 5, 77), 15),
                                         ((5, 1), 15)])
def test_flag_rows_avoid_materializing_shared_flags(fshape, rows):
    """The kernel's flag layout: one row per distinct flag row, so p server
    rows of a scenario read one (chunk,) flag row."""
    f = torch.rand(fshape, generator=torch.Generator().manual_seed(0)) < 0.2
    flags = t_ops._flag_rows(f, torch.Size((3, 5, 77)))
    assert flags.dtype == torch.uint8 and flags.shape == (rows, 77)
    per_row = 15 // rows
    full = f.expand(3, 5, 77).reshape(15, 77)
    assert torch.equal(flags.bool()[torch.arange(15) // per_row], full)


def test_cuda_impl_refuses_cpu_tensors_and_counts_nothing():
    a, b, f = map(torch.from_numpy, _inputs((2, 64), 6))
    before = t_ops.segment_launch_count()
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_ops.maxplus_segment_scan(a, b, f, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        jsq_kernel.jsq_route_cuda(torch.zeros(1, 2, 3), torch.ones(1, 4),
                                  torch.ones(1, 3, 4), torch.ones(1, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_kernel.maxplus_segment_scan_cuda(a, b, f.to(torch.uint8),
                                           with_b=False)
    t_ops.maxplus_segment_scan(a, b, f)
    t_ops.maxplus_segment_scan(a, b, f, with_b=False)
    assert t_ops.segment_launch_count() == before


def test_kernel_sources_are_packaged():
    seg = t_kernel.SEGMENT_LIB.source
    text = seg.read_text()
    assert "maxplus_segment_scan_pallas" in text   # names what it replaces
    for name in ("maxplus_segment_scan_f32", "maxplus_segment_scan_f64"):
        assert f'extern "C" int {name}' in text
    assert all(h.exists() for h in t_kernel.SEGMENT_LIB.headers)
    jsq = jsq_kernel.LIB.source.read_text()
    assert "_jsq_route" in jsq
    for name in ("jsq_route_f32", "jsq_route_f64"):
        assert f'extern "C" int {name}' in jsq
