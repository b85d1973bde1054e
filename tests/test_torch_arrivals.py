"""The port's ArrivalProcess held against `repro.core.arrivals`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.arrivals import ArrivalProcess as J
from repro_torch.core.arrivals import ArrivalProcess as T

CPU = "cpu"


def _same(tp, jp):
    np.testing.assert_array_equal(tp.rates.numpy(), np.asarray(jp.rates))
    np.testing.assert_array_equal(tp.bin_seconds.numpy(),
                                  np.asarray(jp.bin_seconds))
    assert (tp.trace_gaps is None) == (jp.trace_gaps is None)
    if tp.trace_gaps is not None:
        np.testing.assert_array_equal(tp.trace_gaps.numpy(),
                                      np.asarray(jp.trace_gaps))
    np.testing.assert_allclose(tp.mean_rate.numpy(),
                               np.asarray(jp.mean_rate), rtol=1e-6)
    np.testing.assert_array_equal(tp.peak_rate.numpy(),
                                  np.asarray(jp.peak_rate))
    assert tp.n_bins == jp.n_bins
    np.testing.assert_array_equal(tp.period_seconds.numpy(),
                                  np.asarray(jp.period_seconds))


RATES = np.array([[3.0, 9.0, 27.0, 12.0], [1.0, 2.0, 4.0, 8.0]], np.float32)


def _pairs():
    return {
        "stationary": (T.stationary(np.array([5.0, 7.5]), device=CPU),
                       J.stationary(jnp.asarray([5.0, 7.5]))),
        "piecewise": (T.piecewise(RATES, 90.0, device=CPU),
                      J.piecewise(RATES, 90.0)),
        "piecewise_1d": (T.piecewise(RATES[0], 15.0, device=CPU),
                         J.piecewise(RATES[0], 15.0)),
        "flash_crowd": (
            T.flash_crowd(np.array([10.0, 20.0]), burst_starts=[50.0, 700.0],
                          burst_seconds=5.0, burst_multiplier=3.0,
                          period_seconds=900.0, bin_seconds=60.0,
                          device=CPU),
            J.flash_crowd(jnp.asarray([10.0, 20.0]),
                          burst_starts=[50.0, 700.0], burst_seconds=5.0,
                          burst_multiplier=3.0, period_seconds=900.0,
                          bin_seconds=60.0)),
    }


@pytest.mark.parametrize("kind", ["stationary", "piecewise", "piecewise_1d",
                                  "flash_crowd"])
def test_constructors_and_rate_at(kind):
    tp, jp = _pairs()[kind]
    _same(tp, jp)
    # negative times wrap forward (floor modulo, the sign of the divisor)
    t = np.linspace(-1000.0, 2500.0, 101, dtype=np.float32)
    if tp.rates.ndim == 1:
        points = [t]
    else:                                  # one (S,) clock per call
        points = list(np.stack([t, t[::-1] * 0.7], -1)[:, :tp.rates.shape[0]])
    for tt in points:
        np.testing.assert_array_equal(
            tp.rate_at(torch.from_numpy(tt)).numpy(),
            np.asarray(jp.rate_at(jnp.asarray(tt))))
    scale = np.array([2.0, 0.5], np.float32)[:tp.rates.shape[0]] \
        if tp.rates.ndim == 2 else np.float32(3.0)
    _same(tp.scaled_by(torch.tensor(scale)), jp.scaled_by(jnp.asarray(scale)))
    np.testing.assert_allclose(tp.normalized().rates.numpy(),
                               np.asarray(jp.normalized().rates), rtol=1e-6)


def test_flash_crowd_sub_bin_burst_is_not_dropped():
    tp = T.flash_crowd(10.0, burst_starts=[130.0], burst_seconds=2.0,
                       period_seconds=600.0, bin_seconds=60.0, device=CPU)
    assert (tp.rates.numpy() > 10.0).sum() == 1


def test_from_trace_differences_in_float64():
    """Sub-100 ms gaps near the end of a week-long window survive: they
    are differenced before the float32 cast, exactly as the reference."""
    rng = np.random.default_rng(3)
    ts = 604_000.0 + np.cumsum(rng.exponential(0.02, 5000))
    tp = T.from_trace(ts, device=CPU)
    _same(tp, J.from_trace(ts))
    assert (tp.trace_gaps[1:] > 0).all()
    t64 = T.from_trace(ts, device=CPU, dtype=torch.float64)
    np.testing.assert_array_equal(t64.trace_gaps.numpy(),
                                  np.diff(ts, prepend=ts[:1]))


def test_to_moves_every_tensor():
    tp = T.from_trace(np.arange(10.0), device=CPU).to(CPU, torch.float64)
    assert tp.rates.dtype == tp.trace_gaps.dtype == torch.float64
