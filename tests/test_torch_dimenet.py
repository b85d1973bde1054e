"""The port's DimeNet, graph sampler and segment ops held against the
reference (`repro.models.dimenet`, `repro.models.gnn_common`,
`repro.data.graph_sampler`) on the CPU.

The sampler's arrays are bit-identical to the reference's for the same
seeds (a power-law graph, a neighbor sample, its padded batch, a
molecule batch); the bases agree to 1e-6 times the upward recurrence's
growth (the same float32 recurrences, but sin and cos may differ by an
ulp, and j_l's recurrence multiplies an error by (2k + 1) / z at each
order k < l: at FULL's l = 6 and z ~ 0.1 by ~10^4; measured, the
difference stays under 1.2e-7 of that growth); `forward` on a molecule
batch and on a sampled subgraph to 1e-5 of the largest output,
`train_step_loss` to rtol 1e-5 and its gradients to 1e-4 of each
tensor's largest entry, one `TrainStep` (AdamW) by relative L2 a tensor,
at the SMOKE config in float32 with the reference's weights carried
across by `interop.dimenet_params_from_numpy`.  The reference's bfloat16
segment sum sums in bfloat16 and the port's in float32 (ROADMAP queue
3), so nothing here runs in bfloat16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dimenet as j_cfgs
from repro.data import graph_sampler as j_gs
from repro.models import dimenet as j_dn
from repro.models import gnn_common as j_gnn
from repro.train.optimizer import AdamW as JAdamW
from repro.train.trainer import TrainStep as JTrainStep
from repro_torch import interop
from repro_torch.configs import dimenet as t_cfgs
from repro_torch.data import graph_sampler as t_gs
from repro_torch.models import dimenet as t_dn
from repro_torch.models import gnn_common as t_gnn
from repro_torch.train.optimizer import AdamW, named_tensors
from repro_torch.train.trainer import TrainStep

BASIS_ATOL = 1e-6
FWD_RTOL, LOSS_RTOL, GRAD_RTOL, STEP_RL2 = 1e-5, 1e-5, 1e-4, 1e-3
D_FEAT = 8
FIELDS = [f.name for f in dataclasses.fields(j_gnn.GraphBatch)]


def _molecule(mod, **kw):
    return mod.make_molecule_batch(n_molecules=4, n_atoms=8, n_bonds=16,
                                   d_feat=D_FEAT, seed=0, **kw)


def _sampled(mod, **kw):
    g = mod.make_power_law_graph(500, avg_degree=8, d_feat=D_FEAT, seed=3)
    nodes, es, ed = mod.neighbor_sample(g, np.arange(16), fanouts=(4, 3),
                                        seed=1)
    batch = mod.build_graph_batch(g, nodes, es, ed, pad_nodes=512,
                                  pad_edges=512, pad_triplets=2048, seed=2,
                                  **kw)
    return g, (nodes, es, ed), batch


@pytest.fixture(scope="module", params=["molecule", "sampled"])
def graphs(request):
    """(reference batch as jnp, port batch on the CPU, targets numpy)."""
    if request.param == "molecule":
        jb, y = _molecule(j_gs)
        tb, ty = _molecule(t_gs, device="cpu")
        np.testing.assert_array_equal(ty.numpy(), y)
    else:
        jb, tb = _sampled(j_gs)[2], _sampled(t_gs, device="cpu")[2]
        y = np.random.default_rng(4).normal(size=(1, 1)).astype(np.float32)
    return jax.tree.map(jnp.asarray, jb), tb, y


@pytest.fixture(scope="module")
def weights():
    cfg = j_cfgs.SMOKE
    tree = jax.tree.map(np.asarray, j_dn.init_params(
        jax.random.PRNGKey(0), cfg, d_feat=D_FEAT))
    return tree


def _params(tree):
    p = interop.dimenet_params_from_numpy(tree, t_cfgs.SMOKE, device="cpu")
    for t in named_tensors(p).values():
        t.requires_grad_(True)
    return p


def _flat(tree):
    return {k: np.asarray(v) for k, v in named_tensors(tree).items()}


# ---------------------------------------------------------------- sampler

def test_power_law_graph_and_sample_bit_identical():
    jg, j_sample, jb = _sampled(j_gs)
    tg, t_sample, tb = _sampled(t_gs, device="cpu")
    for f in ("n_nodes", "csr_offsets", "csr_indices", "positions",
              "features"):
        a, b = getattr(jg, f), getattr(tg, f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for a, b in zip(j_sample, t_sample):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("make", ["molecule", "sampled"])
def test_graph_batch_bit_identical(make):
    if make == "molecule":
        jb, tb = _molecule(j_gs)[0], _molecule(t_gs, device="cpu")[0]
    else:
        jb, tb = _sampled(j_gs)[2], _sampled(t_gs, device="cpu")[2]
    assert [f.name for f in dataclasses.fields(tb)] == FIELDS
    for f in FIELDS:
        a, b = getattr(jb, f), getattr(tb, f)
        if f == "n_graphs":
            assert a == b
            continue
        assert a.dtype == b.numpy().dtype, f
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f)
    moved = tb.to("cpu")
    assert moved.n_graphs == tb.n_graphs and moved.n_nodes == tb.n_nodes


def test_triplet_builder_correctness():
    """Every triplet (k->j->i): tri_kj's dst == tri_ji's src, and k != i
    (the reference's test_configs_smoke check, on the port's batch)."""
    g = t_gs.make_power_law_graph(200, avg_degree=6, d_feat=4)
    nodes, es, ed = t_gs.neighbor_sample(g, np.arange(8), fanouts=(4,),
                                         seed=1)
    batch = t_gs.build_graph_batch(g, nodes, es, ed, pad_nodes=256,
                                   pad_edges=256, pad_triplets=1024,
                                   device="cpu")
    m = batch.tri_mask.numpy()
    kj = batch.tri_kj.numpy()[m]
    ji = batch.tri_ji.numpy()[m]
    src, dst = batch.edge_src.numpy(), batch.edge_dst.numpy()
    assert m.sum() > 0
    assert (dst[kj] == src[ji]).all()
    assert (src[kj] != dst[ji]).all()


# ------------------------------------------------------------------ bases

@pytest.mark.parametrize("which", ["SMOKE", "FULL"])
def test_bases_match_reference(which, graphs):
    j_cfg, t_cfg = getattr(j_cfgs, which), getattr(t_cfgs, which)
    np.testing.assert_allclose(
        t_dn.spherical_bessel_roots(t_cfg.n_spherical, t_cfg.n_radial),
        j_dn.spherical_bessel_roots(j_cfg.n_spherical, j_cfg.n_radial),
        rtol=1e-12)
    jb, tb, _ = graphs
    rbf = t_dn.radial_bessel(tb.edge_dist, t_cfg.n_radial, t_cfg.cutoff)
    np.testing.assert_allclose(
        rbf.numpy(), j_dn.radial_bessel(jb.edge_dist, j_cfg.n_radial,
                                        j_cfg.cutoff), atol=BASIS_ATOL)
    dist = tb.edge_dist[tb.tri_kj.long()]
    sbf = t_dn.spherical_basis(dist, tb.tri_angle, t_cfg)
    expect = np.asarray(j_dn.spherical_basis(jb.edge_dist[jb.tri_kj],
                                             jb.tri_angle, j_cfg))
    assert sbf.dtype == torch.float32 and sbf.shape == expect.shape
    err = np.abs(sbf.numpy() - expect)
    assert (err <= BASIS_ATOL * _growth(dist.numpy(), t_cfg)).all(), \
        err.max()


def _growth(dist, cfg):
    """(T, L*Nr): prod_{k=1}^{l-1} max(1, (2k + 1) / z) at each basis
    entry's argument z = z_ln d / c, the factor by which the upward
    recurrence can grow an error in j_0 and j_1."""
    roots = t_dn.spherical_bessel_roots(cfg.n_spherical, cfg.n_radial)
    z = roots[None] * (np.clip(dist, 0, cfg.cutoff) / cfg.cutoff
                       )[:, None, None]
    growth = np.ones_like(z)
    for l in range(cfg.n_spherical):
        for k in range(1, l):
            growth[:, l] *= np.maximum(1.0, (2 * k + 1) / z[:, l])
    return growth.reshape(len(dist), -1)


# ------------------------------------------------------------------ model

def test_init_params_layout_and_scales():
    """The port's random weights have the reference's tree, shapes and
    dtypes, and its scales: std fan_in^-0.5 (fan_in a matrix's leading
    axis), the bilinear tensor's 1 / sqrt(nb h), within 5 standard
    errors of a sample's std."""
    cfg = t_cfgs.SMOKE
    ref = _flat(jax.tree.map(np.asarray, j_dn.init_params(
        jax.random.PRNGKey(1), j_cfgs.SMOKE, d_feat=D_FEAT)))
    port = named_tensors(t_dn.init_params(1, cfg, D_FEAT, device="cpu"))
    assert port.keys() == ref.keys()
    for k, t in port.items():
        assert tuple(t.shape) == ref[k].shape and t.dtype == torch.float32
        shape = t.shape[1:] if k.startswith("blocks/") else t.shape
        scale = ((cfg.n_bilinear * cfg.d_hidden) ** -0.5
                 if k == "blocks/bilinear" else shape[0] ** -0.5)
        tol = 5 / np.sqrt(2 * t.numel())
        assert abs(float(t.std()) / scale - 1) < tol, k


def test_forward_matches_reference(graphs, weights):
    jb, tb, _ = graphs
    expect = np.asarray(j_dn.forward(weights, j_cfgs.SMOKE, jb))
    with torch.no_grad():
        out = t_dn.forward(_params(weights), t_cfgs.SMOKE, tb)
    assert out.shape == expect.shape == (tb.n_graphs, 1)
    np.testing.assert_allclose(out.numpy(), expect,
                               atol=FWD_RTOL * np.abs(expect).max())


def test_padded_nodes_contribute_exact_zeros(weights):
    """A batch padded with 64 more nodes (node_graph = n_graphs - 1, the
    reference's fill) gives the same predictions bit for bit."""
    tb = _molecule(t_gs, device="cpu")[0]
    pad = 64
    padded = dataclasses.replace(
        tb, node_feat=torch.cat([tb.node_feat,
                                 torch.zeros(pad, D_FEAT)]),
        node_graph=torch.cat([tb.node_graph, torch.full(
            (pad,), tb.n_graphs - 1, dtype=torch.int32)]))
    params = _params(weights)
    with torch.no_grad():
        assert torch.equal(t_dn.forward(params, t_cfgs.SMOKE, padded),
                           t_dn.forward(params, t_cfgs.SMOKE, tb))


def test_loss_and_gradients_match_reference(graphs, weights):
    jb, tb, y = graphs
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_dn.train_step_loss(p, j_cfgs.SMOKE, jb,
                                       jnp.asarray(y))))(weights)
    params = _params(weights)
    named = named_tensors(params)
    loss = t_dn.train_step_loss(params, t_cfgs.SMOKE, tb, torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=LOSS_RTOL)
    port = _flat(interop.dimenet_params_to_numpy(dict(zip(named, grads))))
    ref = _flat(j_grads)
    assert port.keys() == ref.keys()
    for k, g in ref.items():
        np.testing.assert_allclose(port[k], g, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(g).max(),
                                   err_msg=k)


def test_adamw_step_matches_reference(weights):
    jb, y = _molecule(j_gs)
    tb, ty = _molecule(t_gs, device="cpu")
    jb = jax.tree.map(jnp.asarray, jb)
    j_step = JTrainStep(lambda p, b: j_dn.train_step_loss(
        p, j_cfgs.SMOKE, jb, b["y"]), JAdamW(lr=1e-2))
    j_params, _, j_loss = jax.jit(j_step)(
        weights, j_step.init_state(weights), {"y": jnp.asarray(y)})
    step = TrainStep(lambda p, b: t_dn.train_step_loss(
        p, t_cfgs.SMOKE, tb, b["y"]), AdamW(lr=1e-2))
    params = _params(weights)
    state = step.init_state(params)
    params, state, loss = step(params, state, {"y": ty})
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    port = _flat(interop.dimenet_params_to_numpy(params))
    for k, w in _flat(j_params).items():
        rel = np.linalg.norm(port[k] - w) / np.linalg.norm(w)
        assert rel <= STEP_RL2, (k, rel)


# ---------------------------------------------------------- segment ops

def test_segment_ops_match_reference():
    rng = np.random.default_rng(7)
    data = rng.normal(size=(300, 5)).astype(np.float32)
    ids = rng.integers(0, 12, 300).astype(np.int32)
    ids[:40] = 3                                     # a long run
    for name in ("segment_sum", "segment_mean", "segment_softmax"):
        got = getattr(t_gnn, name)(torch.from_numpy(data),
                                   torch.from_numpy(ids), 13)
        expect = getattr(j_gnn, name)(jnp.asarray(data), jnp.asarray(ids),
                                      13)
        np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5,
                                   atol=1e-6, err_msg=name)
