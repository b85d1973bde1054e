"""The port's toy search engine (`repro_torch.engine`) held against
`repro.engine`.

Mirrors tests/test_engine.py's engine cases, the partition cases of
tests/test_extensions.py and test_sharding.py's 8-shard distributed
search on one device.  Host-side construction (corpus, index, the three
partitionings, the LRU and result caches) is the reference's numpy code,
so its arrays must be bit-identical from the same seed.  The scorer and
the broker merge run in torch on the CPU here: ids must equal the
reference's (ties, -inf padding included: the lower index first, as
``jax.lax.top_k`` orders them), scores within 1e-6 relative.  The card
holds its scorer against the CPU in tests/test_torch_gpu.py and
chip_smoke.py phase 19a.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import broker as j_broker
from repro.engine import cache as j_cache
from repro.engine import corpus as j_corpus
from repro.engine import index as j_index
from repro.engine import partition as j_part
from repro.engine import server as j_server
from repro.workloadgen import querygen as j_qg
from repro_torch.core import queueing
from repro_torch.engine import broker, cache, distributed, partition, server
from repro_torch.engine import corpus as corpus_lib
from repro_torch.engine import index as index_lib
from repro_torch.engine import scoring
from repro_torch.launch.mesh import make_mesh

CPU = "cpu"
SCORE_RTOL = 1e-6
_CFG = dict(n_docs=2000, vocab_size=1500, mean_doc_len=40, seed=0)


@pytest.fixture(scope="module")
def world():
    """The reference's and the port's corpus + index, and a query stream
    with an empty query and a no-match query in it."""
    jc = j_corpus.generate_corpus(j_corpus.CorpusConfig(**_CFG))
    tc = corpus_lib.generate_corpus(corpus_lib.CorpusConfig(**_CFG))
    uni = j_qg.build_universe(j_qg.WorkloadConfig(
        "t", n_unique_queries=500, vocab_size=1500, seed=0))
    _, qterms = j_qg.sample_query_stream(uni, 128)
    qterms = qterms.copy()
    qterms[3] = -1                           # an empty query
    qterms[7, :3] = [0, 1499, 1498]          # rare terms: few or no matches
    qterms[7, 3:] = -1
    return jc, j_index.build_index(jc), tc, index_lib.build_index(tc), qterms


def _same_arrays(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _same_topk(ref, port, what=""):
    """ids equal; scores within SCORE_RTOL, -inf where the reference's."""
    rs, rd = (np.asarray(x) for x in ref)
    ps, pd = (x.cpu().numpy() for x in port)
    np.testing.assert_array_equal(pd, rd, err_msg=f"ids {what}")
    np.testing.assert_array_equal(np.isneginf(ps), np.isneginf(rs))
    fin = np.isfinite(rs)
    np.testing.assert_allclose(ps[fin], rs[fin], rtol=SCORE_RTOL,
                               err_msg=f"scores {what}")


def test_corpus_and_index_bit_identical(world):
    jc, ji, tc, ti, _ = world
    _same_arrays(jc, tc, ("doc_terms", "doc_offsets", "tf"))
    _same_arrays(ji, ti, ("term_offsets", "doc_ids", "tf", "doc_norms",
                          "idf"))
    np.testing.assert_array_equal(ti.list_bytes(), ji.list_bytes())
    assert ti.index_bytes() == ji.index_bytes()


def test_device_arrays_types(world):
    jc, ji, tc, ti, _ = world
    offs, docs, w, norms = ti.as_device_arrays(CPU)
    assert (offs.dtype, docs.dtype, w.dtype, norms.dtype) == (
        torch.int64, torch.int32, torch.float32, torch.float32)
    ref = ji.as_device_arrays()
    for t, r in zip((offs, docs, w, norms), ref):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))


def test_index_invariants(world):
    _, _, tc, ti, _ = world
    assert ti.n_postings == tc.n_postings
    lens = ti.list_lengths()
    assert lens.sum() == ti.n_postings
    for t in np.random.default_rng(0).integers(0, 1500, 20):
        docs = ti.doc_ids[ti.term_offsets[t]:ti.term_offsets[t + 1]]
        assert (np.diff(docs) > 0).all()


@pytest.mark.parametrize("k", [5, 10, 64])
def test_scoring_matches_reference(world, k):
    """Top-k ids equal and scores within 1e-6, empty and no-match queries
    (-inf padding, tie order of the -inf entries) included."""
    _, ji, _, ti, qterms = world
    ref = j_server.IndexServer(ji, k_local=k).process(jnp.asarray(qterms))
    port = server.IndexServer(ti, k_local=k, device=CPU).process(qterms)
    assert np.isneginf(np.asarray(ref[0])).any()    # padding is exercised
    assert port[1].dtype == torch.int32
    _same_topk(ref, port, f"k={k}")


def test_scoring_budget_truncation_matches_reference(world):
    """A budget under the longest list (the paper's partial evaluation)
    truncates both sides alike."""
    _, ji, _, ti, qterms = world
    ref = j_server.IndexServer(ji, k_local=10, budget=50).process(
        jnp.asarray(qterms))
    port = server.IndexServer(ti, k_local=10, budget=50,
                              device=CPU).process(qterms)
    _same_topk(ref, port, "budget 50")


def test_scoring_matches_bruteforce(world):
    _, _, tc, ti, qterms = world
    srv = server.IndexServer(ti, k_local=5, device=CPU)
    scores, docs = (x.numpy() for x in srv.process(qterms[:16]))
    lens = np.diff(tc.doc_offsets)
    doc_of = np.repeat(np.arange(tc.n_docs), lens)
    checked = 0
    for qi in range(16):
        terms = qterms[qi][qterms[qi] >= 0]
        if not len(terms):
            assert np.isneginf(scores[qi]).all()
            continue
        weights = np.zeros(tc.n_docs)
        match = np.ones(tc.n_docs, bool)
        for t in terms:
            sel = tc.doc_terms == t
            hit = np.zeros(tc.n_docs, bool)
            hit[doc_of[sel]] = True
            weights[doc_of[sel]] += tc.tf[sel] * ti.idf[t]
            match &= hit
        if not match.any():
            assert np.isneginf(scores[qi]).all()
            continue
        cos = np.where(match, weights / ti.doc_norms, -np.inf)
        best = np.argmax(cos)
        assert np.isclose(scores[qi, 0], cos[best], rtol=1e-4)
        assert cos[docs[qi, 0]] >= cos[best] * (1 - 1e-5)
        checked += 1
    assert checked >= 4


def test_local_topk_tie_order():
    """Equal values: the lower index first, as jax.lax.top_k."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (6, 50)).astype(np.float32)
    x[1] = -np.inf
    x[2, ::3] = -np.inf
    ref = jax.lax.top_k(jnp.asarray(x), 12)
    s, i = scoring.local_topk(torch.from_numpy(x), 12)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref[0]))


@pytest.mark.parametrize("k", [5, 10])
def test_merge_topk_matches_reference(k):
    """Partial answers with tied and -inf entries (a shard with fewer
    than k matches): ids and scores equal the reference's merge."""
    rng = np.random.default_rng(1)
    p, q, kl = 4, 16, 10
    s = np.sort(rng.integers(0, 6, (p, q, kl)).astype(np.float32),
                axis=-1)[..., ::-1].copy()
    s[1, :4, 3:] = -np.inf
    s[:, 5] = -np.inf                         # nothing matched anywhere
    d = rng.integers(0, 10_000, (p, q, kl)).astype(np.int32)
    ref = j_broker.merge_topk(jnp.asarray(s), jnp.asarray(d), k=k)
    port = broker.merge_topk(torch.from_numpy(s), torch.from_numpy(d), k=k)
    _same_topk(ref, port)
    (ts, td), dt = broker.timed_merge_topk(torch.from_numpy(s),
                                           torch.from_numpy(d), k=k)
    assert dt > 0.0
    np.testing.assert_array_equal(td.numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("scheme", ["document", "hybrid", "term"])
def test_partitions_bit_identical(world, scheme):
    jc, _, tc, _, _ = world
    if scheme == "document":
        jp, tp = (j_part.partition_documents(jc, 4),
                  partition.partition_documents(tc, 4))
        for a, b in zip(jp.local_to_global, tp.local_to_global):
            np.testing.assert_array_equal(a, b)
    elif scheme == "hybrid":
        jp, tp = (j_part.partition_hybrid(jc, 4),
                  partition.partition_hybrid(tc, 4))
    else:
        jp, tp = j_part.partition_terms(jc, 3), partition.partition_terms(
            tc, 3)
        np.testing.assert_array_equal(jp.term_owner, tp.term_owner)
    assert tp.scheme == jp.scheme and tp.p == jp.p
    for a, b in zip(jp.shards, tp.shards):
        assert a.n_docs == b.n_docs
        _same_arrays(a, b, ("term_offsets", "doc_ids", "tf", "doc_norms",
                            "idf"))


def test_document_partition_equals_single(world):
    """p-way document partitioning + broker merge == single index top-k —
    the correctness contract of Fig 1 — with the reference's merge of the
    reference's shards giving the same ids."""
    jc, _, tc, ti, qterms = world
    q = qterms[:8]
    s_ref, _ = server.IndexServer(ti, k_local=5, device=CPU).process(q)
    tp = partition.partition_documents(tc, 4)
    jp = j_part.partition_documents(jc, 4)
    ps, pd, js, jd = [], [], [], []
    for sh in range(4):
        ss, dd = server.IndexServer(tp.shards[sh], k_local=5,
                                    device=CPU).process(q)
        ps.append(ss.numpy())
        pd.append(tp.local_to_global[sh][dd.numpy()])
        rs, rd = j_server.IndexServer(jp.shards[sh], k_local=5).process(
            jnp.asarray(q))
        js.append(np.asarray(rs))
        jd.append(jp.local_to_global[sh][np.asarray(rd)])
    ms, md = broker.merge_topk(torch.from_numpy(np.stack(ps)),
                               torch.from_numpy(np.stack(pd)), k=5)
    np.testing.assert_allclose(ms.numpy(), s_ref.numpy(), rtol=1e-4)
    ref = j_broker.merge_topk(jnp.asarray(np.stack(js)),
                              jnp.asarray(np.stack(jd)), k=5)
    _same_topk(ref, (ms, md))


def test_distributed_search_8_shards():
    """The stacked 8-shard search on one device == single-index search
    (test_sharding.py's property), and the shard-by-shard scores and ids
    equal the reference's per-shard scorer merged by its broker."""
    cfg = dict(n_docs=4000, vocab_size=2000, mean_doc_len=40)
    tc = corpus_lib.generate_corpus(corpus_lib.CorpusConfig(**cfg))
    ti = index_lib.build_index(tc)
    uni = j_qg.build_universe(j_qg.WorkloadConfig(
        "t", n_unique_queries=400, vocab_size=2000))
    _, qterms = j_qg.sample_query_stream(uni, 32)
    s_ref, _ = server.IndexServer(ti, k_local=5, device=CPU).process(qterms)

    part = partition.partition_documents(tc, 8)
    stacked = distributed.stack_shards(part, device=CPU)
    assert stacked.meta["p"] == 8
    search = distributed.make_search_fn(None, stacked, k=5)
    s_dist, d_dist = search(qterms)
    np.testing.assert_allclose(s_dist.numpy(), s_ref.numpy(), rtol=1e-4)

    # the reference's scorer on the same stacked (padded) shards
    n_docs, budget = stacked.meta["b_max"], stacked.meta["budget"]
    js, jd = [], []
    for s in range(8):
        ss, dd = j_server.score_queries(
            *(jnp.asarray(getattr(stacked, f)[s].numpy()) for f in (
                "term_offsets", "doc_ids", "weights", "doc_norms")),
            jnp.asarray(qterms), n_docs=n_docs, budget=budget, k=5)
        js.append(np.asarray(ss))
        jd.append(stacked.local_to_global[s].numpy()[np.asarray(dd)])
    ref = j_broker.merge_topk(jnp.asarray(np.stack(js)),
                              jnp.asarray(np.stack(jd)), k=5)
    _same_topk(ref, (s_dist, d_dist))


def test_make_search_fn_refuses_a_mesh(world):
    """A mesh that is not the port's `DeviceMesh`, or whose one axis is
    not the search's (tests/test_torch_sharding.py runs the sharded
    search)."""
    _, _, tc, _, _ = world
    stacked = distributed.stack_shards(partition.partition_documents(tc, 2),
                                       device=CPU)
    with pytest.raises(TypeError, match="DeviceMesh"):
        distributed.make_search_fn(object(), stacked)
    for axes in (("scenario",), ("servers", "model")):
        mesh = make_mesh((2,) * len(axes), axes, devices=[CPU] * 4)
        with pytest.raises(ValueError, match="'servers'"):
            distributed.make_search_fn(mesh, stacked)


def test_lru_replay_exact(world):
    """Hits, disk times and stats equal the reference's replay."""
    _, ji, _, ti, qterms = world
    stream = np.tile(qterms, (4, 1))
    sizes = ti.list_bytes()
    hits = []
    for frac in (0.02, 0.1, 0.5):
        cap = int(sizes.sum() * frac)
        ts, th, td = cache.measure_cache_behavior(stream, sizes, cap,
                                                  warmup=64)
        rs, rh, rd = j_cache.measure_cache_behavior(
            stream, ji.list_bytes(), cap, warmup=64)
        np.testing.assert_array_equal(th, rh)
        np.testing.assert_array_equal(td, rd)
        assert vars(ts) == vars(rs)
        hits.append(ts.hit)
    assert hits[0] <= hits[1] <= hits[2]
    assert hits[2] > 0.3


def test_result_cache_matches_reference():
    ids = np.random.default_rng(0).zipf(1.5, 5000) % 500
    port, ref = cache.ResultCache(100), j_cache.ResultCache(100)
    for i in ids:
        assert port.lookup(int(i)) == ref.lookup(int(i))
    assert port.hit_ratio == ref.hit_ratio
    assert 0.3 < port.hit_ratio < 0.99


def test_measured_params_drive_model(world):
    """The full paper methodology: measure one server, feed Eq 1-7."""
    _, ji, _, ti, qterms = world
    srv = server.IndexServer(ti, k_local=5, device=CPU)
    stream = np.tile(qterms, (3, 1))
    params = server.measure_service_params(
        srv, stream, cache_bytes=ti.index_bytes() // 10,
        p=8, s_broker=0.5e-3, batch=32)
    ref = j_server.measure_service_params(
        j_server.IndexServer(ji, k_local=5), stream,
        cache_bytes=ji.index_bytes() // 10, p=8, s_broker=0.5e-3, batch=32)
    assert params.hit == ref.hit and params.s_disk == ref.s_disk
    s = float(queueing.service_time_server(params, device=CPU))
    assert 0 < s < 1.0
    lo, hi = queueing.response_time_bounds(0.5 / s, params, device=CPU)
    assert float(lo) < float(hi) < 10.0


def test_busy_trace_matches_reference_replay(world):
    """measure_busy_trace: the cache split equals the reference's, the
    partial top-k equals the reference scorer's, busy = cpu + disk."""
    _, ji, _, ti, qterms = world
    srv = server.IndexServer(ti, k_local=5, device=CPU)
    busy, hit, disk, scores, docs = server.measure_busy_trace(
        srv, qterms, ti.index_bytes() // 10, batch=32)
    _, rh, rd = j_cache.measure_cache_behavior(
        qterms, ji.list_bytes(), ji.index_bytes() // 10, warmup=0)
    np.testing.assert_array_equal(hit, rh.astype(np.float64))
    np.testing.assert_array_equal(disk, np.where(rh, 0.0, rd))
    cpu = (busy - disk).reshape(-1, 32)
    assert (cpu > 0).all()
    # one timed value a batch, shared by its queries (busy - disk rounds)
    np.testing.assert_allclose(cpu, np.broadcast_to(cpu[:, :1], cpu.shape),
                               rtol=0, atol=1e-12)
    ref = j_server.IndexServer(ji, k_local=5).process(jnp.asarray(qterms))
    _same_topk(ref, (torch.from_numpy(scores), torch.from_numpy(docs)))
    with pytest.raises(ValueError, match="multiple of batch"):
        server.measure_busy_trace(srv, qterms[:40], 1000, batch=32)


def test_hybrid_partition_balances_postings():
    cfg = corpus_lib.CorpusConfig(n_docs=1500, vocab_size=800,
                                  mean_doc_len=30, seed=2)
    corp = corpus_lib.generate_corpus(cfg)
    hybrid = partition.partition_hybrid(corp, 4)
    term = partition.partition_terms(corp, 4)

    def imbalance(part):
        sizes = np.array([s.n_postings for s in part.shards], float)
        return sizes.max() / max(sizes.mean(), 1.0)

    assert sum(s.n_postings for s in hybrid.shards) == corp.n_postings
    assert imbalance(hybrid) <= imbalance(term) + 0.05


def test_partition_schemes_same_global_df():
    cfg = corpus_lib.CorpusConfig(n_docs=800, vocab_size=400,
                                  mean_doc_len=25, seed=3)
    corp = corpus_lib.generate_corpus(cfg)
    doc = partition.partition_documents(corp, 3)
    hyb = partition.partition_hybrid(corp, 3)
    np.testing.assert_allclose(doc.shards[0].idf, hyb.shards[0].idf,
                               rtol=1e-6)
