"""The port's disk-cache imbalance model held against
`repro.core.imbalance`.

Both packages get the same float32 geometry: Zipf term rates and Pareto
list sizes built as tests/test_engine.py:146 builds them, over a
`querygen` universe.  Che's bisection and the per-query sums reduce over
every term in another order in torch than in XLA, so T_c, the hit
probabilities and the Eq 1 parameters agree to rtol 1e-5, not bit for
bit.  On the card the sums take yet another order; chip_smoke.py phase
16d holds the card against the CPU at rtol 1e-4 (a comparison at the
bisection boundary may flip by one step there, which moves T_c by a few
float32 ulps of its logarithm).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import imbalance as JI
from repro.core import queueing as jq
from repro_torch.core import imbalance as TI
from repro_torch.core import queueing as tq
from repro_torch.workloadgen import querygen

RTOL = 1e-5


def _geometry(n_terms, alpha, scale=10.0, seed=0):
    """tests/test_engine.py:146's rates and list sizes, as numpy."""
    rng = np.random.default_rng(seed)
    rates = np.diff(np.concatenate([[0], querygen._zipf_cdf(n_terms, alpha)]))
    sizes = (rng.pareto(1.2, n_terms) + 1) * 2e4
    return (rates * scale).astype(np.float32), sizes.astype(np.float32)


UNIVERSE = querygen.build_universe(querygen.WorkloadConfig(
    "t", n_unique_queries=4000, vocab_size=3000, seed=0))
RATES, SIZES = _geometry(3000, querygen.TODOBR.term_zipf_alpha)


def _both(cache_bytes, p):
    return (TI.CacheGeometry(torch.from_numpy(RATES), torch.from_numpy(SIZES),
                             cache_bytes, p),
            JI.CacheGeometry(jnp.asarray(RATES), jnp.asarray(SIZES),
                             cache_bytes, p))


@pytest.mark.parametrize("p", [2, 8, 25, 100, 200])
@pytest.mark.parametrize("cache_bytes", [2.5e5, 1e6, 1e12])
def test_cache_model_matches_reference(cache_bytes, p):
    tg, jg = _both(cache_bytes, p)
    t_c, j_c = TI.che_characteristic_time(tg), JI.che_characteristic_time(jg)
    assert bool(torch.isinf(t_c)) == bool(jnp.isinf(j_c))
    if cache_bytes < 1e12:
        np.testing.assert_allclose(float(t_c), float(j_c), rtol=RTOL)
    np.testing.assert_allclose(TI.term_hit_probabilities(tg).numpy(),
                               np.asarray(JI.term_hit_probabilities(jg)),
                               rtol=RTOL, atol=1e-7)
    terms = torch.from_numpy(UNIVERSE.terms)
    lengths = torch.from_numpy(UNIVERSE.lengths)
    np.testing.assert_allclose(
        TI.query_full_hit_probability(tg, terms, lengths).numpy(),
        np.asarray(JI.query_full_hit_probability(
            jg, jnp.asarray(UNIVERSE.terms), jnp.asarray(UNIVERSE.lengths))),
        rtol=RTOL, atol=1e-7)
    sp = TI.service_params_from_cache_model(tg, terms, lengths)
    sj = JI.service_params_from_cache_model(
        jg, jnp.asarray(UNIVERSE.terms), jnp.asarray(UNIVERSE.lengths))
    for f in dataclasses.fields(jq.ServerParams):
        np.testing.assert_allclose(float(getattr(sp, f.name)),
                                   float(getattr(sj, f.name)), rtol=RTOL,
                                   atol=1e-9, err_msg=f.name)
    np.testing.assert_allclose(float(TI.service_time_cv(sp)),
                               float(JI.service_time_cv(sj)), rtol=RTOL)


def test_padding_ids_wrap_to_the_last_term():
    """Padded terms (-1) read the last term's hit probability before the
    mask drops them, in both packages."""
    tg, jg = _both(1e6, 8)
    terms = np.array([[0, -1, -1], [5, 7, -1], [2999, 3, 4]], np.int32)
    lengths = np.array([1, 2, 3], np.int32)
    np.testing.assert_allclose(
        TI.query_full_hit_probability(tg, torch.from_numpy(terms),
                                      torch.from_numpy(lengths)).numpy(),
        np.asarray(JI.query_full_hit_probability(
            jg, jnp.asarray(terms), jnp.asarray(lengths))), rtol=RTOL)


def test_che_cache_model_properties():
    """tests/test_engine.py: hit grows with memory AND with p (paper Sec
    3.4: more servers -> smaller lists -> better caching)."""
    rates, sizes = _geometry(2000, 1.0)
    rng = np.random.default_rng(0)

    def hit(p, mem):
        geom = TI.CacheGeometry(torch.from_numpy(rates),
                                torch.from_numpy(sizes), mem, p)
        qt = torch.from_numpy(rng.integers(0, 2000, (200, 2)).astype(
            np.int32))
        ln = torch.full((200,), 2, dtype=torch.int32)
        return float(torch.mean(TI.query_full_hit_probability(geom, qt, ln)))

    assert hit(8, 1e6) < hit(8, 1e7) <= 1.0
    assert hit(2, 3e6) < hit(32, 3e6) <= 1.0


def test_imbalance_probability_and_cv():
    h = torch.tensor([0.0, 0.5, 1.0])
    pi = TI.imbalance_probability(h, 8)
    assert float(pi[0]) == 0.0 and float(pi[2]) == 0.0
    assert float(pi[1]) > 0.99  # half-hit rate nearly guarantees a split
    hq = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    for p in (2, 8, 100):
        np.testing.assert_allclose(
            TI.imbalance_probability(torch.from_numpy(hq), p).numpy(),
            np.asarray(JI.imbalance_probability(jnp.asarray(hq), p)),
            rtol=RTOL, atol=1e-7)
    for hit in (0.0, 0.17, 1.0):
        params = dict(p=8, s_broker=0.0, s_hit=9.2e-3, s_miss=10.04e-3,
                      s_disk=28.08e-3, hit=hit)
        np.testing.assert_allclose(
            float(TI.service_time_cv(tq.ServerParams(**params))),
            float(JI.service_time_cv(jq.ServerParams(**params))), rtol=RTOL)
