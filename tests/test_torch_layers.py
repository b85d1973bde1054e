"""The port's model layers held against `repro.models.layers`.

Weights are drawn by the reference (`init_params`), carried across with
`repro_torch.interop.lm_params_from_numpy`, and every function is run
by both packages on the same numpy inputs in float32.  Tolerance: rtol
1e-5 (float32 rounding; the port's attention is one online softmax where
the reference's is chunked, so sums are taken in another order), with an
atol of 1e-6 for entries near zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_8b as j_cfgs
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro_torch import interop
from repro_torch.configs import qwen3_8b as t_cfgs
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf

TOL = dict(rtol=1e-5, atol=1e-6)
J_CFG, T_CFG = j_cfgs.SMOKE, t_cfgs.SMOKE


def _perturbed_tree(seed=0):
    """Reference weights with norm scales moved off 1, so the scales are
    exercised."""
    tree = jax.tree.map(np.asarray,
                        j_tf.init_params(jax.random.PRNGKey(seed), J_CFG))
    rng = np.random.default_rng(seed)

    def move(path, x):
        if path[-1].key == "scale":
            return (x * rng.uniform(0.5, 1.5, x.shape)).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(move, tree)


@pytest.fixture(scope="module")
def weights():
    tree = _perturbed_tree()
    layer0 = jax.tree.map(lambda x: jnp.asarray(x[0]), tree["layers"])
    model = interop.lm_params_from_numpy(tree, T_CFG, device="cpu")
    return layer0, model.layers[0]


def _dims():
    return t_tf._dims(T_CFG), j_tf._dims(J_CFG)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def test_rmsnorm(weights):
    j_w, t_w = weights
    x = _x((2, 5, T_CFG.d_model), 0)
    _check(t_layers.rmsnorm(t_w.ln_attn, torch.from_numpy(x)),
           j_layers.rmsnorm(j_w["ln_attn"], jnp.asarray(x)))


def test_apply_rope_split_halves():
    x = _x((2, 7, 4, 16), 1)
    pos = np.random.default_rng(2).integers(0, 5000, (2, 7)).astype(np.int32)
    _check(t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               1e6),
           j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


def test_project_qkv_norms_then_rotates(weights):
    j_w, t_w = weights
    t_dims, j_dims = _dims()
    x = _x((2, 9, T_CFG.d_model), 3)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    port = t_layers._project_qkv(t_w.attn, t_dims, torch.from_numpy(x),
                                 torch.from_numpy(pos.copy()))
    ref = j_layers._project_qkv(j_w["attn"], j_dims, jnp.asarray(x),
                                jnp.asarray(pos))
    for p, r in zip(port, ref):
        _check(p, r)


def test_attention_prefill_chunked(weights):
    j_w, t_w = weights
    t_dims, j_dims = _dims()
    x = _x((2, 16, T_CFG.d_model), 4)
    port = t_layers.attention_prefill_chunked(t_w.attn, t_dims,
                                              torch.from_numpy(x), chunk=8)
    ref = j_layers.attention_prefill_chunked(j_w["attn"], j_dims,
                                             jnp.asarray(x), chunk=8)
    for p, r in zip(port, ref):
        _check(p, r)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        t_layers.attention_prefill_chunked(t_w.attn, t_dims,
                                           torch.from_numpy(x), chunk=5)


@pytest.mark.parametrize("cache_len", [0, 13, 31])
def test_attention_decode_writes_in_place(weights, cache_len):
    j_w, t_w = weights
    t_dims, j_dims = _dims()
    x = _x((2, 1, T_CFG.d_model), 5)
    kc = _x((2, 32, T_CFG.n_kv_heads, T_CFG.d_head), 6)
    vc = _x((2, 32, T_CFG.n_kv_heads, T_CFG.d_head), 7)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out, k2, v2 = t_layers.attention_decode(t_w.attn, t_dims,
                                            torch.from_numpy(x), tk, tv,
                                            cache_len)
    assert k2 is tk and v2 is tv
    ref = j_layers.attention_decode(j_w["attn"], j_dims, jnp.asarray(x),
                                    jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.asarray(cache_len, jnp.int32))
    for p, r in zip((out, tk, tv), ref):
        _check(p, r)
    with pytest.raises(ValueError, match="outside the cache"):
        t_layers.attention_decode(t_w.attn, t_dims, torch.from_numpy(x), tk,
                                  tv, 32)


def test_mlp_swiglu(weights):
    j_w, t_w = weights
    x = _x((2, 5, T_CFG.d_model), 8)
    _check(t_layers.mlp_swiglu(t_w.mlp, torch.from_numpy(x)),
           j_layers.mlp_swiglu(j_w["mlp"], jnp.asarray(x)))


def test_init_draws_the_reference_distributions():
    """Not the reference's numbers (Philox is not threefry), its laws:
    normal x fan_in^-0.5, embedding x 0.02, norm scales 1."""
    cfg = T_CFG
    model = t_tf.init_params(0, cfg, device="cpu")
    blk = model.layers[0]
    for w, fan_in in ((blk.attn.wq.weight, cfg.d_model),
                      (blk.attn.wo.weight, cfg.n_heads * cfg.d_head),
                      (blk.mlp.w_down.weight, cfg.d_ff),
                      (model.lm_head.weight, cfg.d_model)):
        assert w.shape[1] == fan_in
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.1
    assert abs(float(model.embed.std()) / 0.02 - 1.0) < 0.1
    assert bool((blk.attn.q_norm.scale == 1).all())
    assert not any(p.requires_grad for p in model.parameters())
    again = t_tf.init_params(0, cfg, device="cpu")
    assert torch.equal(again.layers[2].mlp.w_up.weight,
                       model.layers[2].mlp.w_up.weight)
