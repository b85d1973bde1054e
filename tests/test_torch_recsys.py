"""The port's CTR recommenders held against `repro.models.recsys`.

DeepFM, xDeepFM and AutoInt at their SMOKE configs and at a narrow
xDeepFM with fields on both sides of the one-hot threshold: the
reference's weights are carried across with
`interop.recsys_params_from_numpy`, both packages serve the same
`ctr_batch` requests, and the logits agree to a relative L2 error of 1e-4
in float32 (float32 rounding through a few layers is ~1e-6).  Here the
kernels' plain versions run (CPU tensors); on the card they are held
against the kernels (tests/test_torch_gpu.py, chip_smoke.py phase 15).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.data import recsys_data as j_data
from repro.models import recsys as j_recsys
from repro_torch import interop
from repro_torch.configs import registry as t_registry
from repro_torch.data import recsys_data as t_data
from repro_torch.models import recsys as t_recsys

RTOL = 1e-4
ARCHS = ("deepfm", "xdeepfm", "autoint")

# fields of more than 1000 ids are one-hot in ctr_batch, the others 4-hot
NARROW = dataclasses.replace(
    j_registry.get_arch("xdeepfm").smoke_config, name="xdeepfm-narrow",
    n_sparse=8, embed_dim=10,
    field_vocabs=(1000, 20, 5000, 300, 1200, 64, 10, 2000), mlp=(32, 16),
    cin_layers=(24, 24, 24))


def _port_cfg(cfg):
    from repro_torch.configs.base import RecsysConfig
    return RecsysConfig(**dataclasses.asdict(cfg))


def _rel_l2(x, y):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return np.linalg.norm(x - y) / np.linalg.norm(y)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


CASES = [(a, j_registry.get_arch(a).smoke_config) for a in ARCHS] + [
    ("xdeepfm", NARROW)]


@pytest.mark.parametrize("arch,cfg", CASES, ids=[c.name for _, c in CASES])
def test_logits_match_reference(arch, cfg):
    init = getattr(j_recsys, f"init_{arch}")
    j_logits = getattr(j_recsys, f"{arch}_logits")
    t_logits = getattr(t_recsys, f"{arch}_logits")
    tree = _numpy_tree(init(jax.random.key(0), cfg))
    t_cfg = _port_cfg(cfg)
    params = interop.recsys_params_from_numpy(tree, t_cfg, device="cpu")
    ids, mask, _ = t_data.ctr_batch(t_cfg, 64, step=3, seed=1)
    out = t_logits(params, t_cfg, torch.from_numpy(ids),
                   torch.from_numpy(mask))
    expect = j_logits(tree, cfg, jnp.asarray(ids, jnp.int32),
                      jnp.asarray(mask))
    assert out.shape == (64,) and out.dtype == torch.float32
    assert _rel_l2(out.numpy(), expect) <= RTOL


@pytest.mark.parametrize("cfg", [j_registry.get_arch("xdeepfm").smoke_config,
                                 NARROW], ids=["smoke", "narrow"])
def test_cin_interaction_matches_reference(cfg):
    tree = _numpy_tree(j_recsys.init_xdeepfm(jax.random.key(1), cfg))
    t_cfg = _port_cfg(cfg)
    params = interop.recsys_params_from_numpy(tree, t_cfg, device="cpu")
    v = np.random.default_rng(0).standard_normal(
        (33, cfg.n_sparse, cfg.embed_dim)).astype(np.float32)
    out = t_recsys.cin_interaction(params, t_cfg, torch.from_numpy(v))
    expect = j_recsys.cin_interaction(tree, cfg, jnp.asarray(v))
    assert _rel_l2(out.numpy(), expect) <= RTOL


def test_fm_interaction_matches_reference():
    v = np.random.default_rng(1).standard_normal((40, 39, 10)).astype(
        np.float32)
    out = t_recsys.fm_interaction(torch.from_numpy(v))
    expect = j_recsys.fm_interaction(jnp.asarray(v))
    assert _rel_l2(out.numpy(), expect) <= RTOL


@pytest.mark.parametrize("cfg", [j_registry.get_arch("deepfm").smoke_config,
                                 NARROW], ids=["smoke", "narrow"])
@pytest.mark.parametrize("batch,step,seed", [(64, 0, 0), (7, 5, 3)])
def test_ctr_batch_is_bit_identical(cfg, batch, step, seed):
    port = t_data.ctr_batch(_port_cfg(cfg), batch, step=step, seed=seed)
    ref = j_data.ctr_batch(cfg, batch, step=step, seed=seed)
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_table_sizes_equal_reference(arch):
    port, ref = t_registry.get_arch(arch), j_registry.get_arch(arch)
    for which in ("config", "smoke_config"):
        p, r = getattr(port, which), getattr(ref, which)
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert p.total_rows == r.total_rows
        assert t_recsys.padded_rows(p.total_rows) == \
            j_recsys.padded_rows(r.total_rows)
        np.testing.assert_array_equal(t_recsys.field_offsets(p),
                                      j_recsys.field_offsets(r))
    for f in ("arch_id", "family", "source", "notes"):
        assert getattr(port, f) == getattr(ref, f)
    assert ([(s.name, s.kind, s.dims) for s in port.shapes]
            == [(s.name, s.kind, s.dims) for s in ref.shapes])
    full = port.config
    assert full.total_rows == 33_775_577
    assert t_recsys.padded_rows(full.total_rows) == 33_775_616


def test_init_draws_the_reference_layout():
    cfg = _port_cfg(NARROW)
    params = t_recsys.init_xdeepfm(0, cfg, device="cpu")
    tree = j_recsys.init_xdeepfm(jax.random.key(0), NARROW)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == shapes
    # tables x 0.01, dense matrices x fan_in^-0.5, biases 0
    assert abs(float(params["embedding"]["table"].std()) - 0.01) < 1e-3
    w = params["cin"][1]
    assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1.0) < 0.05
    assert not params["mlp"][0]["b"].any()
    again = t_recsys.init_xdeepfm(0, cfg, device="cpu")
    assert torch.equal(again["cin"][2], params["cin"][2])
