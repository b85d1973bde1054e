"""The port's `launch.elastic` held against `repro.launch.elastic`.

Mirrors tests/test_elastic.py test for test (the survivor mesh, its
refusal, `plan_downsize`, the straggler tax, the hedge threshold), each
port against reference.  It also holds `AutoscalePolicy`'s validation and
`for_slo` (tests/test_autoscale.py:216 and :228, mirrored here beside the
policy's other arithmetic), `autoscale_scan`'s plain path against the
reference's `lax.scan` on the same numpy inputs in float64 (active counts
exact, carries to 1e-10), and the hypothesis chunking-invariance property
of tests/test_autoscale.py:319.  The CUDA fleet scan that runs the same
recurrence on the card is held against this plain path in
tests/test_torch_gpu.py.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queueing as jq
from repro.launch import elastic as jel
from repro_torch.launch import elastic as tel

CPU = "cpu"
F64 = torch.float64


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def test_survivor_mesh_shrinks_data_axis():
    for args in [((8, 4), 2, 4, ("data", "model")),
                 ((2, 8, 4), 3, 4, ("pod", "data", "model"))]:
        assert tel.survivor_mesh_shape(*args) == jel.survivor_mesh_shape(
            *args)
    assert tel.survivor_mesh_shape(
        (8, 4), failed_hosts=2, chips_per_host=4,
        axes=("data", "model")) == (6, 4)


def test_survivor_mesh_raises_when_capacity_gone():
    with pytest.raises(ValueError, match="surviving capacity"):
        tel.survivor_mesh_shape((2, 4), failed_hosts=4, chips_per_host=4,
                                axes=("data", "model"))


def test_plan_downsize_factors_are_reciprocal():
    plan = tel.plan_downsize((8, 4), (6, 4))
    ref = jel.plan_downsize((8, 4), (6, 4))
    assert plan.throughput_fraction == pytest.approx(0.75)
    assert plan.step_time_factor == pytest.approx(4.0 / 3.0)
    assert (plan.old_shape, plan.new_shape, plan.throughput_fraction,
            plan.step_time_factor) == (ref.old_shape, ref.new_shape,
                                       ref.throughput_fraction,
                                       ref.step_time_factor)


@pytest.mark.parametrize("p", [0, 1, 4, 7, 16, 100])
def test_expected_straggler_tax_is_harmonic(p):
    assert tel.expected_straggler_tax(p) == pytest.approx(
        jel.expected_straggler_tax(p), rel=1e-6)
    assert tel.expected_straggler_tax(4) == pytest.approx(25.0 / 12.0,
                                                          rel=1e-5)
    assert tel.expected_straggler_tax(p) == pytest.approx(
        float(jq.harmonic_number(max(p, 1))), rel=1e-6)


def test_hedge_threshold_scales_with_log_p():
    r = 0.050
    assert tel.hedge_threshold(r, 16) == pytest.approx(r * math.log(16))
    assert tel.hedge_threshold(r, 16, duplicate_cost_fraction=2.0) == \
        jel.hedge_threshold(r, 16, duplicate_cost_fraction=2.0)


def test_policy_validation():
    with pytest.raises(ValueError, match="min_r <= max_r"):
        tel.AutoscalePolicy(min_r=3, max_r=2)
    with pytest.raises(ValueError, match="target_utilization"):
        tel.AutoscalePolicy(min_r=1, max_r=2, target_utilization=1.5)
    with pytest.raises(ValueError, match="scale steps"):
        tel.AutoscalePolicy(min_r=1, max_r=2, scale_up_step=0)
    with pytest.raises(ValueError, match="decision_interval"):
        tel.AutoscalePolicy(min_r=1, max_r=2, decision_interval_seconds=0)
    with pytest.raises(ValueError, match="stabilization"):
        tel.AutoscalePolicy(min_r=1, max_r=2, stabilization_intervals=0)
    with pytest.raises(ValueError, match="queue_trigger"):
        tel.AutoscalePolicy(min_r=1, max_r=2, queue_trigger_seconds=-1.0)
    with pytest.raises(ValueError, match="init_r"):
        tel.AutoscalePolicy(min_r=2, max_r=4, init_r=1)
    assert tel.AutoscalePolicy(min_r=2, max_r=4).start_r == 2
    assert tel.AutoscalePolicy(min_r=2, max_r=4, init_r=3).start_r == 3
    assert hash(tel.AutoscalePolicy(1, 4)) == hash(tel.AutoscalePolicy(1, 4))


def test_for_slo_wires_straggler_tax():
    """for_slo budgets the Eq 6 synchronization tax H_p into the trigger,
    as the reference does: more servers per replica => lower target."""
    kw = dict(mean_service=0.05, slo_seconds=0.5)
    t4 = tel.AutoscalePolicy.for_slo(1, 4, p=4, **kw).target_utilization
    t64 = tel.AutoscalePolicy.for_slo(1, 4, p=64, **kw).target_utilization
    assert t64 < t4 < 1.0
    for p in (4, 64, 1000):
        ref = jel.AutoscalePolicy.for_slo(1, 4, p=p, **kw)
        port = tel.AutoscalePolicy.for_slo(1, 4, p=p, **kw)
        np.testing.assert_allclose(port.target_utilization,
                                   ref.target_utilization, rtol=1e-6)
    expect4 = 1.0 - tel.expected_straggler_tax(4) * 0.05 / 0.5
    np.testing.assert_allclose(t4, expect4, rtol=1e-12)


_POLICY_KW = dict(min_r=1, max_r=5, target_utilization=0.55,
                  decision_interval_seconds=0.25, stabilization_intervals=2)


def _stream(n, s=3, seed=0):
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(0.05, (s, n))
    gaps[:, -7:] = 0.0                      # a padded tail: advances nothing
    demand = rng.exponential(0.3, (s, n))
    demand[:, -7:] = 0.0
    demand[1] *= 4.0                        # a hot scenario scales out
    upf = rng.choice([1.0, 0.8, 0.6, 0.2], size=(s, n))
    return gaps, demand, upf


@pytest.mark.parametrize("trigger", [None, 2.0])
@pytest.mark.parametrize("faulty", [False, True])
def test_autoscale_scan_matches_reference(x64, trigger, faulty):
    kw = dict(_POLICY_KW, queue_trigger_seconds=trigger, init_r=2)
    jpol, tpol = jel.AutoscalePolicy(**kw), tel.AutoscalePolicy(**kw)
    gaps, demand, upf = _stream(400)
    jcarry = jel.autoscale_init(jpol, 3, jnp.float64)
    jc, jn = jel.autoscale_scan(jpol, 8, jcarry, jnp.asarray(gaps),
                                jnp.asarray(demand),
                                jnp.asarray(upf) if faulty else None)
    tcarry = tel.autoscale_init(tpol, 3, F64, device=CPU)
    tc, tn = tel.autoscale_scan(tpol, 8, tcarry, torch.from_numpy(gaps),
                                torch.from_numpy(demand),
                                torch.from_numpy(upf) if faulty else None)
    assert tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert len(set(tn.flatten().tolist())) > 2       # the policy moves
    for t, j in zip(tc, jc):
        if t.dtype == torch.int32:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       rtol=1e-10, atol=1e-300)


# ------------------------------------------------ hypothesis: carry chaining

try:
    from hypothesis import given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:
    _POL = tel.AutoscalePolicy(min_r=1, max_r=5, target_utilization=0.55,
                               decision_interval_seconds=0.25,
                               stabilization_intervals=2,
                               queue_trigger_seconds=2.0)
    _N = 96
    _GAPS = torch.from_numpy(
        np.random.default_rng(0).exponential(0.05, (2, _N))).float()
    _DEMAND = torch.from_numpy(
        np.random.default_rng(1).exponential(0.3, (2, _N))).float()

    @given(st.lists(st.integers(min_value=1, max_value=_N - 1),
                    min_size=0, max_size=6, unique=True))
    @settings(max_examples=30, deadline=None)
    def test_autoscale_scan_chunking_invariant(cuts):
        """Splitting the stream at ANY boundaries and chaining the carry
        reproduces the monolithic per-query active counts exactly, as
        the reference's property holds its own controller."""
        carry0 = tel.autoscale_init(_POL, 2, torch.float32, device=CPU)
        _, whole = tel.autoscale_scan(_POL, 8, carry0, _GAPS, _DEMAND)
        bounds = [0] + sorted(cuts) + [_N]
        carry = tel.autoscale_init(_POL, 2, torch.float32, device=CPU)
        parts = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            carry, n = tel.autoscale_scan(_POL, 8, carry, _GAPS[:, a:b],
                                          _DEMAND[:, a:b])
            parts.append(n)
        assert torch.equal(torch.cat(parts, dim=1), whole)
else:
    @pytest.mark.skip(reason="property tests need hypothesis (see "
                      "pyproject [project.optional-dependencies].test)")
    def test_autoscale_scan_chunking_invariant():
        pass
