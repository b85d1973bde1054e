"""Scenario sharding and the sharded engine held against the reference.

The port's counterpart of tests/test_sharding.py's sweep and search
cases, on meshes that repeat the CPU (`make_sweep_mesh(devices=...)`,
the port's eight virtual host devices).  The reference's own sharded
simulated sweep stops in ``shard_map`` under this JAX (ROADMAP queue 3),
so the sharded paths are held against its unsharded entries:

* analytic: ``sweep_analytical(mesh=)`` bitwise the port's unsharded
  surfaces (each scenario goes through the same elementwise operations),
  and those within 1e-5 of the reference's `sweep_analytical`, as
  tests/test_torch_sweep.py holds them;
* simulated: shard d of dispatch k gets the reference's draws of the
  key ``split(split(key, n_p * n_r)[k], n_dev)[d]`` through ``draws=``,
  and its scenarios' ``sum_response`` equal the reference's
  `simulate_fork_join_batch` run directly on that key and shard slab
  (rtol 1e-6, as the reference's test holds device 0's shard);
* a fault axis through ``mesh=``: every shard equals the port's batch
  entry run on its own seed ``_mix(_mix(seed, k), d)``, exactly;
* the engine: the 8-shard search over an 8-device mesh equals the
  one-device stacked search exactly and the single index to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simulator as jsim
from repro.core import sweep as jsweep
from repro.core.arrivals import ArrivalProcess as JArrival
from repro.core.cluster import ClusterSpec as JCluster
from repro.core.queueing import ServerParams as JParams
from repro_torch import interop
from repro_torch.core import simulator as tsim
from repro_torch.core import sweep as tsweep
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.faults import FaultSpec
from repro_torch.core.queueing import ServerParams
from repro_torch.engine import corpus as corpus_lib
from repro_torch.engine import distributed, partition, server
from repro_torch.engine import index as index_lib
from repro_torch.launch.mesh import DeviceMesh, make_mesh, make_sweep_mesh
from repro.workloadgen import querygen as j_qg

CPU = "cpu"
CACHE = (0.2, 2e-3)
# tests/test_sharding.py's grid: 5 lam x p 4 x cpu 2 x hit 2 x r 2; a
# (p, r) slab holds 20 scenarios, 24 after padding to 8 shards of 3
AXES = dict(lam=np.linspace(40.0, 160.0, 5), p=[4.0], cpu=[1.0, 1.5],
            disk=[1.0], hit=[0.3, 0.7], r=[1.0, 2.0])
N_QUERIES, CHUNK = 3000, 512


def _grids(result_cache=CACHE, **axes):
    """(reference grid, port grid) from the same float32 axes."""
    axes = {k: np.asarray(v, np.float32) for k, v in axes.items()}
    return (jsweep.SweepGrid.build(
                **{k: jnp.asarray(v) for k, v in axes.items()},
                result_cache=result_cache),
            tsweep.SweepGrid.build(
                **{k: torch.from_numpy(v) for k, v in axes.items()},
                result_cache=result_cache, device=CPU))


def cpu_mesh(n):
    return make_sweep_mesh(devices=[CPU] * n)


def test_meshes():
    mesh = cpu_mesh(8)
    assert mesh.size == 8 and mesh.axis_names == ("scenario",)
    assert make_sweep_mesh(3, devices=[CPU] * 8).size == 3
    two = make_mesh((2, 4), ("data", "model"), devices=[CPU] * 8)
    assert two.shape == (2, 4) and two.size == 8
    with pytest.raises(ValueError, match="9 devices but there are 8 given"):
        make_sweep_mesh(9, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="needs 6 devices"):
        DeviceMesh((torch.device(CPU),) * 4, (2, 3), ("a", "b"))
    if not torch.cuda.is_available():
        # no fallback: a mesh of the (absent) cards raises, naming them
        with pytest.raises(ValueError, match="0 visible CUDA devices"):
            make_sweep_mesh()


@pytest.mark.parametrize("n_dev", [3, 8])
def test_analytic_sharded_bitwise(n_dev):
    """40 scenarios over 3 devices (padded to 42) and 8 (no padding)."""
    jg, tg = _grids(**AXES)
    base = tsweep.sweep_analytical(tg)
    sharded = tsweep.sweep_analytical(tg, mesh=cpu_mesh(n_dev))
    ref = jsweep.sweep_analytical(jg)
    for name in ("response_lower", "response_upper", "utilization"):
        a, b = getattr(base, name), getattr(sharded, name)
        assert b.shape == tg.shape and b.dtype == a.dtype
        assert torch.equal(a, b), name          # inf cells included
        r = np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(np.isinf(b.numpy()), np.isinf(r))
        fin = np.isfinite(r)
        np.testing.assert_allclose(b.numpy()[fin], r[fin], rtol=1e-5,
                                   err_msg=name)


def test_non_1d_mesh_raises():
    _, tg = _grids(**AXES)
    mesh = make_mesh((2, 4), ("data", "model"), devices=[CPU] * 8)
    with pytest.raises(ValueError, match="needs a 1-D mesh"):
        tsweep.sweep_analytical(tg, mesh=mesh)
    with pytest.raises(ValueError, match="needs a 1-D mesh"):
        tsweep.sweep_simulated(tg, mesh=mesh, n_queries=512)


def _slab(grid, i, j):
    """The (i, j) dispatch's flat (L*C*D*H) scenario slab as numpy."""
    lam_full, params_full = grid.broadcast_full()

    def flat(x):
        return np.asarray(jnp.moveaxis(x, (1, 5), (0, 1))[i, j]).reshape(-1)
    return flat(lam_full), {f.name: flat(getattr(params_full, f.name))
                            for f in dataclasses.fields(JParams)}


def _shard_draws(key, s, p, params, r_cache):
    """The reference's per-chunk draws for one shard key: the base plan
    and the result cache's salted side streams."""
    jp = JParams(**{k: jnp.asarray(v) for k, v in params.items()})
    out = []
    for c in range(-(-N_QUERIES // CHUNK)):
        g, b, sv = jsim.chunk_random_draws(key, c, s, CHUNK, p, jp,
                                           "exponential")
        kh, ks = jax.random.split(jax.random.fold_in(
            jax.random.fold_in(key, c), jsim._CACHE_SALT))
        side = {"cache_hit": np.asarray(jax.random.bernoulli(
                    kh, jnp.full((s, CHUNK), r_cache, jnp.float32))),
                "cache_unit": np.asarray(jax.random.exponential(
                    ks, (s, CHUNK)))}
        out.append((np.asarray(g), np.asarray(b), np.asarray(sv), side))
    return out


def test_simulated_sharded_equals_reference_per_shard():
    """8 shards of 3 scenarios (20 padded to 24) in each of the two (p, r)
    dispatches; every real scenario of every shard equals the reference's
    direct batch run on that shard's key."""
    jg, tg = _grids(**AXES)
    n_dev, per = 8, 3
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 2)              # n_p * n_r dispatches
    direct, per_dispatch = {}, {}
    for j, r in enumerate((1, 2)):
        lam, params = _slab(jg, 0, j)
        pad = n_dev * per - lam.size
        lam = np.pad(lam, (0, pad), mode="edge")
        params = {k: np.pad(v, (0, pad), mode="edge")
                  for k, v in params.items()}
        shard_keys = jax.random.split(keys[j], n_dev)
        shard_draws = []
        for d in range(n_dev):
            sl = slice(d * per, (d + 1) * per)
            p_d = {k: v[sl] for k, v in params.items()}
            res = jsim.simulate_fork_join_batch(
                shard_keys[d], JArrival.stationary(jnp.asarray(lam[sl])),
                JParams(**{k: jnp.asarray(v) for k, v in p_d.items()}),
                N_QUERIES, p=4, chunk_size=CHUNK,
                cluster=JCluster(r=r, result_cache=CACHE))
            direct[j, d] = np.asarray(res.sum_response)
            shard_draws.append(interop.draws_from_numpy(
                _shard_draws(shard_keys[d], per, 4, p_d, CACHE[0]),
                device=CPU))
        per_dispatch[j] = tuple(shard_draws)
    port = tsweep.sweep_simulated(tg, 0, n_queries=N_QUERIES,
                                  chunk_size=CHUNK, mesh=cpu_mesh(n_dev),
                                  draws=per_dispatch.__getitem__)
    assert port.mean.shape == tg.shape                # padding sliced off
    assert bool(torch.isfinite(port.mean).all())
    slab_shape = (5, 2, 1, 2)                          # (L, C, D, H)
    for j in range(2):
        for s in range(20):
            l, c, d_, h = np.unravel_index(s, slab_shape)
            got = float(port.stats.sum_response[l, 0, c, d_, h, j])
            want = direct[j, s // per][s % per]
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       err_msg=f"dispatch {j} scenario {s}")


def test_fault_axis_through_mesh():
    """A fault axis (the fault-free baseline and an MTBF/MTTR spec) at r
    = 2 over 3 shards (4 scenarios padded to 6): each shard is the batch
    entry run directly on its own seed, exactly, and the baseline's
    fault channels come back as zeros."""
    _, tg = _grids(result_cache=None, lam=[20.0, 40.0], p=[4.0],
                   cpu=[1.0, 2.0], disk=[1.0], hit=[0.3], r=[2.0])
    faults = (None, FaultSpec(mtbf_seconds=30.0, mttr_seconds=5.0))
    tg = dataclasses.replace(tg, fault=faults)
    n, chunk, seed, n_dev = 1024, 256, 7, 3
    port = tsweep.sweep_simulated(tg, seed, n_queries=n, chunk_size=chunk,
                                  cluster=ClusterSpec(routing="jsq"),
                                  mesh=cpu_mesh(n_dev))
    assert port.mean.shape == tg.shape
    assert float(port.stats.spill_count[..., 0].abs().sum()) == 0.0
    lam_full, params_full = tg.broadcast_full()
    padded = [0, 1, 2, 3, 3, 3]                  # edge-replicated slab
    for j, fault in enumerate(faults):
        lam = lam_full[:, 0, :, :, :, j].reshape(-1)
        fields = {f.name: getattr(params_full, f.name)[:, 0, :, :, :, j]
                  .reshape(-1) for f in dataclasses.fields(ServerParams)}
        for d in range(n_dev):
            idx = padded[2 * d: 2 * d + 2]
            res = tsim.simulate_fork_join_batch(
                tsim._mix(tsim._mix(seed, j), d),
                ArrivalProcess.stationary(lam[idx], device=CPU),
                ServerParams(**{k: v[idx] for k, v in fields.items()}),
                n, p=4, chunk_size=chunk, device=CPU,
                cluster=ClusterSpec(r=2, routing="jsq", fault=fault))
            for q, s in enumerate(idx):
                if 2 * d + q >= 4:               # padding: sliced off
                    continue
                l, c = divmod(s, 2)
                for name in ("count", "sum_response", "sumsq_response"):
                    assert torch.equal(
                        getattr(port.stats, name)[l, 0, c, 0, 0, j],
                        getattr(res, name)[q]), (name, j, s)


def test_draws_per_shard_checked():
    _, tg = _grids(**AXES)
    with pytest.raises(ValueError, match="2 shards' draws for a mesh of 8"):
        tsweep.sweep_simulated(tg, n_queries=512, mesh=cpu_mesh(8),
                               draws=lambda k: (None, None))


@pytest.mark.parametrize("n_dev", [3, 8])
def test_distributed_search_8_shards_on_mesh(n_dev):
    """tests/test_sharding.py::test_distributed_search_8_shards on a
    ("servers",) mesh: 8 shards over 8 devices (one a device) and over
    3 (shard s on device s % 3)."""
    cfg = corpus_lib.CorpusConfig(n_docs=4000, vocab_size=2000,
                                  mean_doc_len=40)
    tc = corpus_lib.generate_corpus(cfg)
    uni = j_qg.build_universe(j_qg.WorkloadConfig(
        "t", n_unique_queries=400, vocab_size=2000))
    _, qterms = j_qg.sample_query_stream(uni, 32)
    s_ref, _ = server.IndexServer(index_lib.build_index(tc), k_local=5,
                                  device=CPU).process(qterms)
    stacked = distributed.stack_shards(partition.partition_documents(tc, 8),
                                       device=CPU)
    s_one, d_one = distributed.make_search_fn(None, stacked, k=5)(qterms)
    mesh = make_mesh((n_dev,), ("servers",), devices=[CPU] * n_dev)
    s_dist, d_dist = distributed.make_search_fn(mesh, stacked, k=5)(qterms)
    assert torch.equal(d_dist, d_one) and torch.equal(s_dist, s_one)
    np.testing.assert_allclose(s_dist.numpy(), s_ref.numpy(), rtol=1e-6)
