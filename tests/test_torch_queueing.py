"""The port's analytical model held against `repro.core.queueing`.

Every function runs on the same dense lambda x p grids (made with numpy,
passed to both packages as arrays) and must agree to float32 rtol 1e-6;
saturated points are +inf on both sides.
"""

import numpy as np
import pytest
import torch

from repro.core import capacity as jcap
from repro.core import queueing as jq
from repro_torch.core import capacity as tcap
from repro_torch.core import queueing as tq

CPU = "cpu"
RTOL = 1e-6
P_GRID = np.array([1, 2, 3, 4, 8, 16, 64, 100, 1024], np.float32)[None, :]
LAM_GRID = np.linspace(0.25, 60.0, 97, dtype=np.float32)[:, None]


def _params(scale):
    """Table 5 service times scaled per p column; (1, len(P_GRID)) fields."""
    b = jcap.TABLE5_PARAMS
    f = np.linspace(0.4, 1.2, P_GRID.shape[1], dtype=np.float32)[None, :]
    fields = dict(p=P_GRID, s_broker=np.float32(b.s_broker) * f * scale,
                  s_hit=np.float32(b.s_hit) * f, s_miss=np.float32(b.s_miss)
                  * f, s_disk=np.float32(b.s_disk) * f,
                  hit=np.full_like(f, b.hit))
    return (jq.ServerParams(**fields),
            tq.ServerParams(**{k: torch.from_numpy(v.copy())
                               for k, v in fields.items()}))


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL)


def test_harmonic_number_dense():
    for p in (np.arange(0, 4097, dtype=np.float32),
              np.linspace(0.0, 3000.0, 12_001, dtype=np.float32)):
        _close(tq.harmonic_number(torch.from_numpy(p)),
               jq.harmonic_number(p))


@pytest.mark.parametrize("name", [
    "fork_join_lower_bound", "fork_join_upper_bound",
    "fork_join_interpolation", "broker_residence_time"])
def test_lambda_p_surfaces(name):
    for scale in (1.0, 40.0):      # a broker far from / near saturation
        pj, pt = _params(scale)
        _close(getattr(tq, name)(torch.from_numpy(LAM_GRID), pt),
               getattr(jq, name)(LAM_GRID, pj))


def test_response_time_bounds_dense():
    pj, pt = _params(1.0)
    lo_t, hi_t = tq.response_time_bounds(torch.from_numpy(LAM_GRID), pt)
    lo_j, hi_j = jq.response_time_bounds(LAM_GRID, pj)
    _close(lo_t, lo_j)
    _close(hi_t, hi_j)
    assert np.isinf(hi_t.numpy()).any() and np.isfinite(hi_t.numpy()).any()


def test_elementwise_terms_dense():
    pj, pt = _params(1.0)
    lam = torch.from_numpy(LAM_GRID)
    _close(tq.service_time_server(pt), jq.service_time_server(pj))
    s = jq.service_time_server(pj)
    _close(tq.utilization(lam, tq.service_time_server(pt)),
           jq.utilization(LAM_GRID, s))
    _close(tq.mm1_residence_time(lam, tq.service_time_server(pt)),
           jq.mm1_residence_time(LAM_GRID, s))
    _close(tq.saturation_rate(pt), jq.saturation_rate(pj))
    _close(tq.expected_max_exponential(torch.from_numpy(P_GRID),
                                       torch.from_numpy(LAM_GRID)),
           jq.expected_max_exponential(P_GRID, LAM_GRID))


def test_result_cache_dense():
    pj, pt = _params(1.0)
    lam = torch.from_numpy(LAM_GRID)
    hit = np.linspace(0.0, 1.0, 11, dtype=np.float32)[:, None, None]
    _close(tq.response_time_with_result_cache(
        lam, pt, torch.from_numpy(hit), 0.069e-3),
        jq.response_time_with_result_cache(LAM_GRID, pj, hit, 0.069e-3))
    resp = np.linspace(0.01, 1.0, 97, dtype=np.float32)[:, None]
    _close(tq.apply_result_cache(torch.from_numpy(resp), lam, 0.3, 2e-3),
           jq.apply_result_cache(resp, LAM_GRID, 0.3, 2e-3))


@pytest.mark.parametrize("c", [1, 2, 3, 4, 8])
def test_erlang_c_and_mmc_dense(c):
    lam = np.linspace(0.05, 1.1 * c, 200, dtype=np.float32)
    _close(tq.erlang_c(torch.from_numpy(lam), 1.0, c),
           jq.erlang_c(lam, 1.0, c))
    _close(tq.mmc_residence_time(torch.from_numpy(lam), 1.0, c),
           jq.mmc_residence_time(lam, 1.0, c))
    pj, pt = _params(1.0)
    lo_t, hi_t = tq.response_time_bounds_mmc(torch.from_numpy(LAM_GRID), pt,
                                             c)
    lo_j, hi_j = jq.response_time_bounds_mmc(LAM_GRID, pj, c)
    _close(lo_t, lo_j)
    _close(hi_t, hi_j)


def test_two_phase_and_quantile_dense():
    pj, pt = _params(1.0)
    lam = torch.from_numpy(LAM_GRID)
    _close(tq.two_phase_response_upper(lam, pt, s_docserver=2e-3,
                                       p_docservers=16),
           jq.two_phase_response_upper(LAM_GRID, pj, s_docserver=2e-3,
                                       p_docservers=16))
    for q in (0.5, 0.9, 0.95, 0.99, 0.999):
        _close(tq.response_time_quantile_upper(lam, pt, q),
               jq.response_time_quantile_upper(LAM_GRID, pj, q))


def test_paper_numbers_on_the_port():
    """Spot checks of tests/test_queueing.py, run through the port."""
    pr = tcap.TABLE5_PARAMS
    assert np.isclose(float(tq.harmonic_number(4, device=CPU)),
                      1 + 0.5 + 1 / 3 + 0.25, atol=1e-5)
    assert np.isclose(float(tq.harmonic_number(100, device=CPU)), 5.18738,
                      atol=1e-3)
    assert np.isinf(float(tq.mm1_residence_time(1.0, 1.0, device=CPU)))
    u = tq.utilization(28.0, tq.service_time_server(pr, device=CPU))
    assert 0.90 < float(u) < 0.95
    lo, hi = tq.response_time_bounds(20.0, pr, device=CPU)
    r_b = tq.broker_residence_time(20.0, pr, device=CPU)
    ratio = (float(hi) - float(r_b)) / (float(lo) - float(r_b))
    assert np.isclose(ratio, float(tq.harmonic_number(8, device=CPU)),
                      rtol=1e-5)
    for lam in (1.0, 10.0, 20.0, 28.0):
        mid = tq.fork_join_interpolation(lam, pr, device=CPU)
        assert float(tq.fork_join_lower_bound(lam, pr, device=CPU)) <= \
            float(mid) <= float(tq.fork_join_upper_bound(
                lam, pr, device=CPU)) * (1 + 1e-6)


def test_float64_mirrors_the_reference_float32_pins():
    """harmonic_number and the M/M/1 service time stay float32 in a
    float64 call, as in the reference; the rate keeps float64."""
    lam = torch.linspace(1.0, 20.0, 5, dtype=torch.float64)
    assert tq.harmonic_number(torch.tensor([8.0], dtype=torch.float64)
                              ).dtype == torch.float32
    s = torch.full((5,), 0.02, dtype=torch.float64)
    r = tq.mm1_residence_time(lam, s)
    assert r.dtype == torch.float64
    expect = np.float32(0.02) / (1.0 - lam.numpy() * np.float32(0.02))
    np.testing.assert_allclose(r.numpy(), expect, rtol=1e-15)


def test_default_device_is_cuda():
    """Entry points given no tensor and no device= run on the card."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        tq.harmonic_number(8)
    assert tq.harmonic_number(8, device=CPU).device.type == "cpu"
