"""The port's workload characterization and load generators held against
`repro.core.workload` and `repro.workloadgen`.

Fits run on the same numpy samples in both packages (float32).  The
closed-form fits (exponential, lognormal, Pareto) agree to 1e-5; the
gamma and Weibull fits run 25 Newton steps on derivatives taken another
way (torch's trigamma and autograd against JAX's zeta-based polygamma and
`jax.grad`), so their parameters agree to 1e-4.  CDFs follow at 1e-4,
and the KS and SSQ statistics — sums and maxima of small CDF differences,
which magnify a parameter's difference — at 1e-3.  `querygen` is a
numpy copy: its universe and streams are equal bit for bit.  Statistical tests mirror tests/test_workload.py on the
port's own draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import workload as JW
from repro.workloadgen import loadgen as j_loadgen
from repro.workloadgen import querygen as j_querygen
from repro_torch.core import workload as TW
from repro_torch.workloadgen import loadgen as t_loadgen
from repro_torch.workloadgen import querygen as t_querygen

CPU = "cpu"


def _samples():
    rng = np.random.default_rng(0)
    n = 20_000
    return {
        "exponential": rng.exponential(0.035, n),
        "gamma": rng.gamma(3.0, 2.0, n),
        "weibull": 1.5 * rng.weibull(2.0, n),
        "lognormal": np.exp(rng.normal(-2.0, 0.5, n)),
        "pareto": 0.01 * (1.0 + rng.pareto(2.5, n)),
    }


SAMPLES = {k: v.astype(np.float32) for k, v in _samples().items()}
FITS = ["fit_exponential", "fit_gamma", "fit_weibull", "fit_lognormal",
        "fit_pareto"]
FIT_RTOL = {"fit_exponential": 1e-5, "fit_gamma": 1e-4,
            "fit_weibull": 1e-4, "fit_lognormal": 1e-5, "fit_pareto": 1e-5}


@pytest.mark.parametrize("sample", sorted(SAMPLES))
@pytest.mark.parametrize("fit", FITS)
def test_fits_match_reference(fit, sample):
    x = SAMPLES[sample]
    ref = getattr(JW, fit)(jnp.asarray(x))
    port = getattr(TW, fit)(torch.from_numpy(x))
    assert port.name == ref.name and port.params.keys() == ref.params.keys()
    for k in ref.params:
        np.testing.assert_allclose(float(port.params[k]),
                                   float(ref.params[k]),
                                   rtol=FIT_RTOL[fit], err_msg=k)
    t = np.quantile(x, [0.01, 0.1, 0.5, 0.9, 0.99]).astype(np.float32)
    np.testing.assert_allclose(port.cdf(torch.from_numpy(t)).numpy(),
                               np.asarray(ref.cdf(jnp.asarray(t))),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("criterion", ["ks", "ssq"])
@pytest.mark.parametrize("sample", sorted(SAMPLES))
def test_goodness_of_fit_matches_reference(sample, criterion):
    x = SAMPLES[sample]
    j_win, j_stats = JW.best_fit(jnp.asarray(x), criterion=criterion)
    t_win, t_stats = TW.best_fit(torch.from_numpy(x), criterion=criterion)
    assert t_win == j_win
    for name in j_stats:
        np.testing.assert_allclose(float(t_stats[name]),
                                   float(j_stats[name]), rtol=1e-3,
                                   atol=1e-6, err_msg=name)
    xs, ecdf = TW.empirical_cdf_points(torch.from_numpy(x))
    j_xs, j_ecdf = JW.empirical_cdf_points(jnp.asarray(x))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(j_xs))
    np.testing.assert_array_equal(ecdf.numpy(), np.asarray(j_ecdf))


def test_paper_fit_claims_on_port_draws():
    """tests/test_workload.py's recoveries on the port's own samples: MLEs
    recover their parameters, and KS prefers the exponential family for
    Poisson gaps (paper Fig 6)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.empty(20_000).exponential_(generator=gen) * 0.035
    assert np.isclose(float(TW.fit_exponential(x).params["mu"]), 0.035,
                      rtol=0.05)
    winner, stats = TW.best_fit(x, criterion="ks")
    assert winner in ("exponential", "gamma", "weibull")
    assert float(stats["exponential"]) < float(stats["lognormal"])
    assert float(stats["exponential"]) < float(stats["pareto"])
    _, ssq = TW.best_fit(x, criterion="ssq")
    assert float(ssq["exponential"]) < float(ssq["pareto"])
    g = torch.distributions.Gamma(3.0, 0.5).sample((20_000,))
    fit = TW.fit_gamma(g)
    assert np.isclose(float(fit.params["k"]), 3.0, rtol=0.1)
    assert np.isclose(float(fit.params["theta"]), 2.0, rtol=0.1)
    u = torch.rand(20_000, generator=gen)
    fit = TW.fit_weibull(1.5 * (-torch.log(u)) ** 0.5)
    assert np.isclose(float(fit.params["k"]), 2.0, rtol=0.1)
    assert np.isclose(float(fit.params["lam"]), 1.5, rtol=0.1)


@pytest.mark.parametrize("alpha", [0.82, 0.98, 1.09])
def test_zipf_matches_reference(alpha):
    np.testing.assert_allclose(
        TW.zipf_probs(5000, alpha, device=CPU).numpy(),
        np.asarray(JW.zipf_probs(5000, alpha)), rtol=1e-5)
    ids = np.asarray(JW.sample_zipf(jax.random.PRNGKey(4), 5000, alpha,
                                    (50_000,)))
    freqs = TW.rank_frequencies(torch.from_numpy(ids), 5000)
    np.testing.assert_array_equal(freqs.numpy(),
                                  np.asarray(JW.rank_frequencies(
                                      jnp.asarray(ids), 5000)))
    np.testing.assert_allclose(
        float(TW.fit_zipf_alpha(freqs)),
        float(JW.fit_zipf_alpha(jnp.asarray(freqs.numpy()))), rtol=1e-5)


@pytest.mark.parametrize("alpha", [0.82, 0.98])
def test_zipf_alpha_recovery_on_port_draws(alpha):
    """Fig 2: recover alpha from the port's own Zipf sample."""
    ids = TW.sample_zipf(4, 5000, alpha, (200_000,), device=CPU)
    assert ids.dtype == torch.int32
    est = float(TW.fit_zipf_alpha(TW.rank_frequencies(ids, 5000)))
    assert abs(est - alpha) < 0.08, (alpha, est)


def test_folding_and_poisson_arrivals():
    """Table 3: folding 243 days by a 1-week window boosts 35x, in both;
    and the port's Poisson timestamps have the asked rate."""
    t = np.sort(np.random.default_rng(0).random(5000) * 243 * 86400
                ).astype(np.float32)   # the reference folds in float32
    folded, boost = TW.fold_timestamps(torch.from_numpy(t), 7 * 86400.0)
    j_folded, j_boost = JW.fold_timestamps(jnp.asarray(t), 7 * 86400.0)
    assert int(boost) == int(j_boost) == 35
    np.testing.assert_array_equal(folded.numpy(), np.asarray(j_folded))
    assert bool((torch.diff(folded) >= 0).all())
    arr = TW.sample_poisson_arrivals(1, 20.0, 50_000, device=CPU)
    assert bool((torch.diff(arr) >= 0).all())
    assert abs(float(arr[-1]) / 50_000 * 20.0 - 1.0) < 0.02


def test_loadgen_matches_reference():
    for kw in (dict(), dict(base_rate=3.0, peak_hour=11.0,
                            peak_to_trough=6.0, weekend_factor=1.3)):
        np.testing.assert_allclose(
            t_loadgen.diurnal_rates(device=CPU, **kw).numpy(),
            np.asarray(j_loadgen.diurnal_rates(**kw)), rtol=1e-6)
    proc = t_loadgen.diurnal_process(2.0, bin_seconds=60.0, device=CPU)
    j_proc = j_loadgen.diurnal_process(2.0, bin_seconds=60.0)
    np.testing.assert_allclose(proc.rates.numpy(), np.asarray(j_proc.rates),
                               rtol=1e-6)
    assert float(proc.bin_seconds) == float(j_proc.bin_seconds) == 60.0
    np.testing.assert_array_equal(
        t_loadgen.poisson_arrivals(3.0, 1000.0, seed=2),
        j_loadgen.poisson_arrivals(3.0, 1000.0, seed=2))
    t = t_loadgen.diurnal_arrivals(1.0, days=7, seed=0, device=CPU)
    j_t = j_loadgen.diurnal_arrivals(1.0, days=7, seed=0)
    np.testing.assert_array_equal(t, j_t)
    folded, boost = t_loadgen.fold(t, 86400.0)
    j_folded, j_boost = j_loadgen.fold(j_t, 86400.0)
    np.testing.assert_array_equal(folded, j_folded)
    assert boost == j_boost
    replay = t_loadgen.replay_process(t, device=CPU)
    np.testing.assert_allclose(replay.trace_gaps.numpy(),
                               np.diff(t, prepend=t[:1]), rtol=1e-6)
    assert t_loadgen.WEEK_SECONDS == j_loadgen.WEEK_SECONDS


def test_loadgen_diurnal_profile():
    """tests/test_workload.py: peak-hour traffic well above the trough."""
    t = t_loadgen.diurnal_arrivals(1.0, days=7, seed=0, device=CPU)
    counts = np.bincount(((t % 86400.0) // 3600).astype(int), minlength=24)
    assert counts.max() > 2.0 * max(counts.min(), 1)


@pytest.mark.parametrize("config", ["small", "radix"])
def test_querygen_bit_identical(config):
    cfg = (j_querygen.WorkloadConfig("t", n_unique_queries=3000,
                                     vocab_size=2000, seed=0)
           if config == "small" else j_querygen.RADIX)
    t_cfg = t_querygen.WorkloadConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    uni, j_uni = t_querygen.build_universe(t_cfg), \
        j_querygen.build_universe(cfg)
    for f in ("terms", "lengths", "popularity"):
        np.testing.assert_array_equal(getattr(uni, f), getattr(j_uni, f))
        assert getattr(uni, f).dtype == getattr(j_uni, f).dtype
    qids, terms = t_querygen.sample_query_stream(uni, 30_000)
    j_qids, j_terms = j_querygen.sample_query_stream(j_uni, 30_000)
    np.testing.assert_array_equal(qids, j_qids)
    np.testing.assert_array_equal(terms, j_terms)
    if config == "small":
        lens = (terms >= 0).sum(1)
        assert abs((lens == 1).mean() - 0.32) < 0.1
        assert abs((lens == 2).mean() - 0.41) < 0.1
        assert np.median(lens) == 2   # paper: median query length 2
    assert t_querygen.TODOBR == t_querygen.WorkloadConfig(
        **{f: getattr(j_querygen.TODOBR, f)
           for f in j_querygen.TODOBR.__dataclass_fields__})
