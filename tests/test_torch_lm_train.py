"""The port's LM training path held against `repro.models` on the CPU.

`attention_train` on both paths (the full softmax, chunk 0, and the
blockwise recurrence, chunk 8 over 3 blocks) against the reference's,
value and gradients (inputs and weights); `chunked_lm_loss` against
`cross_entropy_sharded` of the full logits; remat on and off equal;
`train_step_loss` and its gradient against `jax.value_and_grad` for all
five LM smoke configs (and qwen3-1.7b-smoke with ``attn_chunk=8``),
through `interop.lm_params_to_numpy`; one `TrainStep` (AdamW, two
microbatches) against the reference's.

Weights are drawn with numpy in the reference's layout and carried
across with `interop.lm_params_from_numpy`.  float32 throughout.
Tolerances: rtol 1e-5 on values and losses (float32 rounding through
two layers: ~1e-6); gradients rtol 1e-4 with atol 1e-4 of each
tensor's largest entry (sums over tokens in another order, then through
two layers of backward); remat on and off bitwise (the same operations
recomputed).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import command_r_plus_104b as j_cr
from repro.configs import granite_moe_3b_a800m as j_granite
from repro.configs import qwen3_1_7b as j_17b
from repro.configs import qwen3_8b as j_8b
from repro.configs import qwen3_moe_30b_a3b as j_qmoe
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro.train.optimizer import AdamW as JAdamW
from repro.train.optimizer import cosine_schedule as j_cosine
from repro.train.trainer import TrainStep as JTrainStep
from repro_torch import interop
from repro_torch.configs import command_r_plus_104b as t_cr
from repro_torch.configs import granite_moe_3b_a800m as t_granite
from repro_torch.configs import qwen3_1_7b as t_17b
from repro_torch.configs import qwen3_8b as t_8b
from repro_torch.configs import qwen3_moe_30b_a3b as t_qmoe
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf
from repro_torch.train.optimizer import AdamW, cosine_schedule
from repro_torch.train.trainer import TrainStep
from test_torch_moe import _numpy_weights

VALUE = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4
B, S = 2, 16

CONFIGS = {
    "qwen3-1.7b-smoke": (j_17b.SMOKE, t_17b.SMOKE),
    "qwen3-8b-smoke": (j_8b.SMOKE, t_8b.SMOKE),
    "command-r-smoke": (j_cr.SMOKE, t_cr.SMOKE),
    "qwen3-moe-smoke": (j_qmoe.SMOKE, t_qmoe.SMOKE),
    "granite-moe-smoke": (j_granite.SMOKE, t_granite.SMOKE),
    "qwen3-1.7b-smoke-chunk8": (
        dataclasses.replace(j_17b.SMOKE, attn_chunk=8),
        dataclasses.replace(t_17b.SMOKE, attn_chunk=8)),
}


def _grad_close(port, ref, what):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(np.asarray(port), ref, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * scale, err_msg=what)


def _flat(tree, path=""):
    """path -> numpy array of a nested dict of arrays."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}/{key}").items()}
    return {path: np.asarray(tree)}


def _same_keys(port, ref):
    port, ref = _flat(port), _flat(ref)
    assert port.keys() == ref.keys(), (sorted(port), sorted(ref))
    return port, ref


def _rel_l2(x, y) -> float:
    return float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30))


def _lm(name, seed=0):
    j_cfg, t_cfg = CONFIGS[name]
    tree = _numpy_weights(jax.eval_shape(
        lambda: j_tf.init_params(jax.random.PRNGKey(0), j_cfg)), seed)
    model = interop.lm_params_from_numpy(tree, t_cfg, device="cpu")
    return j_cfg, t_cfg, tree, model


def _tokens(cfg, b=B, s=S, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1                            # masked
    labels[0, 3] = -1
    return tokens, labels


# ------------------------------------------------------------------ attention

def _attention_pair(s):
    j_cfg, t_cfg = CONFIGS["qwen3-1.7b-smoke"]
    dims_j = j_tf._dims(j_cfg)
    dims_t = t_tf._dims(t_cfg)
    tree = _numpy_weights(jax.eval_shape(
        lambda: j_layers.init_attention(jax.random.PRNGKey(0), dims_j,
                                        jnp.float32)), 4)
    tree["q_norm"]["scale"] = np.linspace(0.5, 1.5, dims_j.d_head,
                                          dtype=np.float32)
    mod = t_layers.Attention(dims_t, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for n in ("wq", "wk", "wv", "wo"):
            getattr(mod, n).weight.copy_(torch.from_numpy(tree[n].T))
        mod.q_norm.scale.copy_(torch.from_numpy(tree["q_norm"]["scale"]))
        mod.k_norm.scale.copy_(torch.from_numpy(tree["k_norm"]["scale"]))
    mod.requires_grad_(True)
    x = np.random.default_rng(5).standard_normal(
        (B, s, dims_j.d_model)).astype(np.float32)
    w = np.random.default_rng(6).standard_normal(
        (B, s, dims_j.d_model)).astype(np.float32)
    return dims_j, dims_t, tree, mod, x, w


@pytest.mark.parametrize("chunk", [0, 8])
def test_attention_train_value_and_grads(chunk):
    s = 24
    dims_j, dims_t, tree, mod, x, w = _attention_pair(s)

    @jax.jit
    def ref(tree, x):
        def f(tree, x):
            out = j_layers.attention_train(tree, dims_j, x, chunk=chunk)
            return jnp.sum(out * w), out
        (_, out), grads = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(tree, x)
        return out, grads
    j_out, (j_gw, j_gx) = ref(tree, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    out = t_layers.attention_train(mod, dims_t, xt, chunk=chunk)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **VALUE)
    _grad_close(xt.grad.numpy(), j_gx, "x")
    for n in ("wq", "wk", "wv", "wo"):
        _grad_close(getattr(mod, n).weight.grad.numpy().T, j_gw[n], n)
    _grad_close(mod.q_norm.scale.grad.numpy(), j_gw["q_norm"]["scale"],
                "q_norm")


def test_attention_train_paths_agree():
    """The blockwise path is the full softmax's recurrence: the two agree
    to float32 rounding, and a sequence that is not a multiple of the
    chunk is refused."""
    _, dims_t, _, mod, x, _ = _attention_pair(24)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        full = t_layers.attention_train(mod, dims_t, xt, chunk=0)
        blocks = t_layers.attention_train(mod, dims_t, xt, chunk=8)
        whole = t_layers.attention_train(mod, dims_t, xt, chunk=24)
    torch.testing.assert_close(blocks, full, **VALUE)
    assert torch.equal(whole, full)               # chunk >= S: full path
    with pytest.raises(ValueError, match="multiple"):
        t_layers.attention_train(mod, dims_t, xt[:, :20], chunk=8)


# -------------------------------------------------------------------- the loss

def test_chunked_lm_loss_equals_full_cross_entropy():
    j_cfg, t_cfg, tree, model = _lm("qwen3-1.7b-smoke")
    tokens, labels = _tokens(j_cfg)
    tt, tl = torch.from_numpy(tokens), torch.from_numpy(labels)
    with torch.no_grad():
        x, _ = t_tf.forward_hidden(model, t_cfg, tt)
        logits, _ = t_tf.forward_train(model, t_cfg, tt)
        full = t_tf.cross_entropy_sharded(logits, tl)
        chunked = [t_tf.chunked_lm_loss(model, t_cfg, x, tl, chunk=c)
                   for c in (4, 8, S, 2048)]
    for c in chunked:
        torch.testing.assert_close(c, full, rtol=1e-6, atol=0)
    ref = j_tf.cross_entropy_sharded(jnp.asarray(logits.numpy()),
                                     jnp.asarray(labels))
    np.testing.assert_allclose(float(full), float(ref), rtol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        t_tf.chunked_lm_loss(model, t_cfg, x, tl, chunk=5)


def test_remat_on_and_off_equal():
    j_cfg, t_cfg, _, model = _lm("granite-moe-smoke")
    model.requires_grad_(True)
    tokens, labels = _tokens(j_cfg)
    tt, tl = torch.from_numpy(tokens), torch.from_numpy(labels)
    params = list(model.parameters())
    out = {}
    for remat in (True, False):
        logits, aux = t_tf.forward_train(model, t_cfg, tt, remat=remat)
        loss = t_tf.cross_entropy_sharded(logits, tl) + 0.01 * aux
        out[remat] = (logits.detach(), aux.detach(),
                      torch.autograd.grad(loss, params))
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    for a, b in zip(out[True][2], out[False][2]):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grad(j_cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, t, lab: j_tf.train_step_loss(p, j_cfg, t, lab)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step_loss_and_grad_match_reference(name):
    j_cfg, t_cfg, tree, model = _lm(name)
    tokens, labels = _tokens(j_cfg)
    j_loss, j_grads = _reference_loss_and_grad(j_cfg)(
        tree, jnp.asarray(tokens), jnp.asarray(labels))

    model.requires_grad_(True)
    loss = t_tf.train_step_loss(model, t_cfg, torch.from_numpy(tokens),
                                torch.from_numpy(labels))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    port, ref = _same_keys(
        interop.lm_params_to_numpy(dict(zip(names, grads)), t_cfg), j_grads)
    for k in ref:
        _grad_close(port[k], ref[k], k)
    if t_cfg.moe is not None:       # the aux loss reaches the router
        assert float(grads[names.index("layers.0.moe.router")].abs().max()
                     ) > 0


def test_params_to_numpy_inverts_from_numpy():
    j_cfg, t_cfg, tree, model = _lm("granite-moe-smoke")
    back, ref = _same_keys(interop.lm_params_to_numpy(model, t_cfg), tree)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


def test_train_step_microbatches_match_reference():
    """Two steps of AdamW (a cosine schedule, clipping) over a batch of 4
    in two microbatches: the losses, and each updated tensor against the
    reference's by relative L2 norm: the weights to 1e-5, their change
    over the two steps to 1e-3.  Not element by element: Adam's step
    m / sqrt(v) is ~ +-lr whatever the gradient's size, so an element
    whose gradient is near zero carries the gradients' absolute error
    (<= 1e-4 of the largest, above) whole into its step."""
    j_cfg, t_cfg, tree, model = _lm("qwen3-1.7b-smoke")
    tokens, labels = _tokens(j_cfg, b=4, seed=7)

    def j_loss(p, batch):
        return j_tf.train_step_loss(p, j_cfg, batch["tokens"],
                                    batch["labels"])

    def t_loss(p, batch):
        return t_tf.train_step_loss(p, t_cfg, batch["tokens"],
                                    batch["labels"])

    j_step = JTrainStep(j_loss, JAdamW(lr=j_cosine(1e-2, 2, 10)),
                        microbatches=2)
    t_step = TrainStep(t_loss, AdamW(lr=cosine_schedule(1e-2, 2, 10)),
                       microbatches=2)
    j_params, j_state = tree, j_step.init_state(tree)
    state = t_step.init_state(model)
    j_jit = jax.jit(j_step)
    for _ in range(2):
        j_params, j_state, j_l = j_jit(
            j_params, j_state, {"tokens": jnp.asarray(tokens),
                                "labels": jnp.asarray(labels)})
        model, state, loss = t_step(model, state, {
            "tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)})
        np.testing.assert_allclose(float(loss), float(j_l), rtol=1e-5)
    assert int(state["opt"].step) == 2
    start = _flat(tree)
    port, ref = _same_keys(interop.lm_params_to_numpy(model, t_cfg),
                           j_params)
    for k in ref:
        assert _rel_l2(port[k], ref[k]) <= 1e-5, (k, _rel_l2(port[k], ref[k]))
        assert _rel_l2(port[k] - start[k], ref[k] - start[k]) <= 1e-3, k
