"""The port's MIND (multi-interest retrieval) held against
`repro.models.recsys`, and its batches against `repro.data.recsys_data`.

`mind_batch` is numpy on both sides: bit-identical arrays.  The model
runs on mind-smoke in float32 on weights drawn with numpy in the
reference's layout (`init_mind`'s) and handed to both: interests, both
branches of the training logits and the two losses within rtol 1e-5 /
atol 1e-6 (float32 rounding through the 3 routing iterations and the
label-aware softmax); retrieval's top-k ids equal and its scores within
1e-5 (the scores are distinct here, so the order is the scores').
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mind as j_mind
from repro.data import recsys_data as j_data
from repro.models import recsys as j_recsys
from repro_torch import interop
from repro_torch.configs import mind as t_mind
from repro_torch.configs import registry as t_registry
from repro_torch.data import recsys_data as t_data
from repro_torch.models import recsys as t_recsys

TOL = dict(rtol=1e-5, atol=1e-6)
B = 16


def test_config_equals_reference():
    for which in ("FULL", "SMOKE"):
        port, ref = getattr(t_mind, which), getattr(j_mind, which)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.total_rows == ref.total_rows
    spec = t_registry.get_arch("mind")
    assert (spec.arch_id, spec.family, spec.source, spec.notes) == (
        j_mind.SPEC.arch_id, j_mind.SPEC.family, j_mind.SPEC.source,
        j_mind.SPEC.notes)
    assert t_mind.FULL.item_vocab == 1_000_000


@pytest.mark.parametrize("which,batch,step,seed", [
    ("SMOKE", 16, 0, 0), ("SMOKE", 7, 3, 2), ("FULL", 64, 1, 5)])
def test_mind_batch_is_bit_identical(which, batch, step, seed):
    cfg = getattr(t_mind, which)
    port = t_data.mind_batch(cfg, batch, step=step, seed=seed)
    ref = j_data.mind_batch(getattr(j_mind, which), batch, step=step,
                            seed=seed)
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def world():
    """mind-smoke weights (numpy, the reference's layout) on both sides,
    and one batch."""
    cfg = j_mind.SMOKE
    shapes = jax.eval_shape(lambda: j_recsys.init_mind(
        jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(7)
    d = cfg.embed_dim
    # the table x 0.3, not the reference's x 0.01: small rows leave the
    # routing logits near their uniform start, which would test little
    tree = {
        "item_table": (rng.standard_normal(shapes["item_table"].shape)
                       * 0.3).astype(np.float32),
        "bilinear_s": (rng.standard_normal((d, d)) * d ** -0.5
                       ).astype(np.float32),
        "out_mlp": [{"w": (rng.standard_normal(lyr["w"].shape)
                           * lyr["w"].shape[0] ** -0.5).astype(np.float32),
                     "b": (rng.standard_normal(lyr["b"].shape) * 0.1
                           ).astype(np.float32)}
                    for lyr in shapes["out_mlp"]],
    }
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = interop.recsys_params_from_numpy(tree, t_mind.SMOKE,
                                               device="cpu")
    hist, mask, target = t_data.mind_batch(t_mind.SMOKE, B)
    return cfg, jparams, tparams, hist, mask, target


def test_init_draws_the_reference_layout():
    params = t_recsys.init_mind(0, t_mind.SMOKE, device="cpu")
    ref = jax.eval_shape(lambda: j_recsys.init_mind(jax.random.PRNGKey(0),
                                                    j_mind.SMOKE))
    assert (jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), ref))
    assert abs(float(params["item_table"].std()) - 0.01) < 1e-3
    again = t_recsys.init_mind(0, t_mind.SMOKE, device="cpu")
    assert torch.equal(again["bilinear_s"], params["bilinear_s"])


def test_interests_match_reference(world):
    cfg, jp, tp, hist, mask, _ = world
    ref = j_recsys.mind_user_interests(jp, cfg, jnp.asarray(hist),
                                       jnp.asarray(mask))
    port = t_recsys.mind_user_interests(tp, t_mind.SMOKE,
                                        torch.from_numpy(hist),
                                        torch.from_numpy(mask))
    assert port.shape == (B, cfg.n_interests, cfg.embed_dim)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("negatives", [None, 12])
def test_train_logits_and_losses_match_reference(world, negatives):
    """In-batch negatives (B, B), and 12 shared sampled negatives
    (B, 1 + 12); the sampled-softmax loss of each and the CTR loss."""
    cfg, jp, tp, hist, mask, target = world
    neg = (None if negatives is None else np.random.default_rng(3)
           .integers(0, cfg.item_vocab, negatives).astype(np.int32))
    ref = j_recsys.mind_train_logits(
        jp, cfg, jnp.asarray(hist), jnp.asarray(mask), jnp.asarray(target),
        None if neg is None else jnp.asarray(neg))
    port = t_recsys.mind_train_logits(
        tp, t_mind.SMOKE, torch.from_numpy(hist), torch.from_numpy(mask),
        torch.from_numpy(target), None if neg is None
        else torch.from_numpy(neg))
    assert port.shape == ((B, B) if neg is None else (B, 1 + negatives))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)
    inbatch = neg is None
    np.testing.assert_allclose(
        float(t_recsys.sampled_softmax_loss(port, inbatch=inbatch)),
        float(j_recsys.sampled_softmax_loss(ref, inbatch=inbatch)), **TOL)
    labels = (np.random.default_rng(4).random(port.shape) < 0.3
              ).astype(np.float32)
    np.testing.assert_allclose(
        float(t_recsys.ctr_loss(port, torch.from_numpy(labels))),
        float(j_recsys.ctr_loss(ref, jnp.asarray(labels))), **TOL)


@pytest.mark.parametrize("cands", ["all", "subset"])
def test_retrieve_matches_reference(world, cands):
    """One user against every item (the retrieval_cand cell's shape at
    smoke size), and two users against a shuffled candidate subset."""
    cfg, jp, tp, hist, mask, _ = world
    if cands == "all":
        ids, users, k = np.arange(cfg.item_vocab, dtype=np.int32), 1, 10
    else:
        ids = np.random.default_rng(5).permutation(cfg.item_vocab)[:100]
        ids, users, k = ids.astype(np.int32), 2, 20
    rs, ri = j_recsys.mind_retrieve(jp, cfg, jnp.asarray(hist[:users]),
                                    jnp.asarray(mask[:users]),
                                    jnp.asarray(ids), k=k)
    ps, pi = t_recsys.mind_retrieve(tp, t_mind.SMOKE,
                                    torch.from_numpy(hist[:users]),
                                    torch.from_numpy(mask[:users]),
                                    torch.from_numpy(ids), k=k)
    assert pi.dtype == torch.int32 and pi.shape == (users, k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), **TOL)


def test_retrieve_ties_keep_the_lower_position():
    """Equal scores (duplicate candidates) rank the lower position first,
    as ``jax.lax.top_k``."""
    params = t_recsys.init_mind(0, t_mind.SMOKE, device="cpu")
    hist, mask, _ = t_data.mind_batch(t_mind.SMOKE, 1)
    ids = torch.tensor([5, 9, 5, 9, 5], dtype=torch.int64)
    s, i = t_recsys.mind_retrieve(params, t_mind.SMOKE,
                                  torch.from_numpy(hist),
                                  torch.from_numpy(mask), ids, k=5)
    s, i = s[0].tolist(), i[0].tolist()
    assert sorted(i) == list(range(5)) and len(set(s)) == 2
    for a in range(4):
        assert s[a] >= s[a + 1]
        if s[a] == s[a + 1]:
            assert i[a] < i[a + 1]
