"""The port's MoE FFN and the LMs it serves held against the reference.

`repro_torch.models.moe.moe_ffn` against `repro.models.moe.moe_ffn` on
the weights the reference draws, carried across as they are: on
qwen3-moe-smoke (8 experts, top-2, padded to 8) and granite-moe-smoke
(5 experts padded to 6, the pad masked out of the router), in float32:
outputs within rtol 1e-5 / atol 1e-5, the Switch aux loss within rtol
1e-6.  A capacity factor small enough that experts overflow drops the
same (token, choice) pairs as the reference (its slot positions, lines
84-91 of src/repro/models/moe.py, rebuilt here from its own top-k), and
the outputs still agree.  Through whole LMs (both MoE smokes and
command-r-smoke, the first config without qk-norm): prefill then 3
decode steps, and `LMServer`'s streams, logits within 1e-4.
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
from repro.configs import qwen3_moe_30b_a3b as j_qwen_moe
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro.serving import engine as j_engine
from repro_torch import interop
from repro_torch.configs import command_r_plus_104b as t_cr
from repro_torch.configs import granite_moe_3b_a800m as t_granite
from repro_torch.configs import qwen3_moe_30b_a3b as t_qwen_moe
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.serving import engine as t_engine
from test_torch_serving import _Recorder

FFN = dict(rtol=1e-5, atol=1e-5)
AUX_RTOL = 1e-6
LOGITS = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS = 2, 16, 3

# the reference's entries, jitted: one compile a shape instead of one a
# primitive (the values are the eager entries')
_j_moe_ffn = jax.jit(j_moe.moe_ffn, static_argnums=1)
_j_prefill = jax.jit(j_tf.prefill, static_argnums=1,
                     static_argnames=("chunk", "remat"))
_j_decode = jax.jit(j_tf.decode_step, static_argnums=1)

MOE = {"qwen3-moe-smoke": (j_qwen_moe.SMOKE, t_qwen_moe.SMOKE),
       "granite-moe-smoke": (j_granite.SMOKE, t_granite.SMOKE)}
LMS = dict(MOE, **{"command-r-smoke": (j_cr.SMOKE, t_cr.SMOKE)})


def _numpy_weights(shapes, seed):
    """Weights for the reference's parameter layout ``shapes`` (a pytree
    of ShapeDtypeStructs) drawn with numpy as the reference's init draws
    them: norm scales 1, the embedding and the router normal x 0.02,
    every other matrix normal x (its leading non-layer axis)^-0.5."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [getattr(k, "key", "") for k in path]
        shape = leaf.shape
        if "scale" in names:
            return np.ones(shape, np.float32)
        if names[-1] in ("embed", "router"):
            scale = 0.02
        else:
            scale = shape[1 if names[0] == "layers" else 0] ** -0.5
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _both_moe(j_cfg, t_cfg, seed=0):
    """MoE weights (one layer) for the reference and the port's copy."""
    tree = _numpy_weights(jax.eval_shape(
        lambda: j_moe.init_moe(jax.random.PRNGKey(0), j_cfg.d_model,
                               j_cfg.moe, jnp.float32)), seed)
    mod = t_moe.MoE(t_cfg.d_model, t_cfg.moe, device="cpu",
                    dtype=torch.float32)
    with torch.no_grad():
        for name in ("router", "w_gate", "w_up", "w_down"):
            getattr(mod, name).copy_(torch.from_numpy(tree[name]))
    return tree, mod


def _x(cfg, s=S, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)


def _port_dropped(mod, spec, x):
    """(B, S, k) bool: the port's dropped choices, from its router and
    slot rule."""
    b, s, _ = x.shape
    _, _, top_e = t_moe._route(mod, spec, torch.from_numpy(x))
    _, keep = t_moe._slots(top_e.reshape(b, s * spec.top_k),
                           spec.n_experts_padded or spec.n_experts,
                           t_moe._capacity(s, spec))
    return ~keep.view(b, s, spec.top_k).numpy()


@functools.partial(jax.jit, static_argnums=1)
def _reference_dropped(tree, spec, x):
    """(B, S, k) bool: the reference's dropped choices, from its router's
    top-k and its slot rule (src/repro/models/moe.py:55-62, 84-91)."""
    e = spec.n_experts_padded or spec.n_experts
    logits = jnp.asarray(x) @ tree["router"]
    if e != spec.n_experts:
        logits = jnp.where(jnp.arange(e) >= spec.n_experts, -jnp.inf, logits)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, -1), spec.top_k)
    ef = top_e.reshape(x.shape[0], -1)
    onehot = jax.nn.one_hot(ef, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=1) - onehot
    slot = jnp.take_along_axis(pos, ef[..., None], axis=2)[..., 0]
    keep = slot < j_moe._capacity(x.shape[1], spec)
    return ~keep.reshape(top_e.shape)


@pytest.mark.parametrize("name", sorted(MOE))
def test_moe_ffn_matches_reference(name):
    j_cfg, t_cfg = MOE[name]
    tree, mod = _both_moe(j_cfg, t_cfg)
    x = _x(j_cfg)
    j_out, j_aux = _j_moe_ffn(tree, j_cfg.moe, jnp.asarray(x))
    t_out, t_aux = t_moe.moe_ffn(mod, t_cfg.moe, torch.from_numpy(x))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **FFN)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=AUX_RTOL)
    np.testing.assert_array_equal(_port_dropped(mod, t_cfg.moe, x),
                                  _reference_dropped(tree, j_cfg.moe, x))
    if t_cfg.moe.n_experts_padded != t_cfg.moe.n_experts:
        # granite: 5 experts padded to 6; the pad is never chosen
        _, _, top_e = t_moe._route(mod, t_cfg.moe, torch.from_numpy(x))
        assert int(top_e.max()) < t_cfg.moe.n_experts


@pytest.mark.parametrize("name", sorted(MOE))
def test_moe_dropped_tokens_match_reference(name):
    """capacity_factor 0.3 over 32 tokens: each expert holds a few slots,
    so most experts overflow and drop choices."""
    j_cfg, t_cfg = MOE[name]
    j_spec = dataclasses.replace(j_cfg.moe, capacity_factor=0.3)
    t_spec = dataclasses.replace(t_cfg.moe, capacity_factor=0.3)
    tree, mod = _both_moe(j_cfg, t_cfg, seed=1)
    x = _x(j_cfg, s=32, seed=4)
    want = _reference_dropped(tree, j_spec, x)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(_port_dropped(mod, t_spec, x), want)
    j_out, j_aux = _j_moe_ffn(tree, j_spec, jnp.asarray(x))
    t_out, t_aux = t_moe.moe_ffn(mod, t_spec, torch.from_numpy(x))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **FFN)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=AUX_RTOL)


def _drive(srv):
    """Two slots, four 8-token requests: admissions as slots free up, so
    a later request reuses a slot (and its stale cache lines)
    mid-stream; tests/test_torch_serving.py's drive, one prompt length
    (one prefill shape for the reference to compile)."""
    rng = np.random.default_rng(0)
    queue = [(i, rng.integers(0, 128, 8).astype(np.int32), n)
             for i, n in enumerate((5, 3, 4, 2))]
    admitted = []
    for _ in range(40):
        while queue and srv.admit(*queue[0]):
            admitted.append(queue.pop(0)[0])
        if not srv.step() and not queue:
            break
    return admitted


@pytest.fixture(scope="module", params=sorted(LMS))
def lm(request):
    j_cfg, t_cfg = LMS[request.param]
    tree = _numpy_weights(jax.eval_shape(
        lambda: j_tf.init_params(jax.random.PRNGKey(0), j_cfg)), seed=1)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = interop.lm_params_from_numpy(tree, t_cfg, device="cpu")
    tokens = np.random.default_rng(2).integers(
        0, j_cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    return j_cfg, t_cfg, jparams, model, tokens


def test_lm_prefill_and_decode_match_reference(lm):
    j_cfg, t_cfg, jparams, model, tokens = lm
    assert (model.layers[0].moe is None) == (t_cfg.moe is None)
    t_logits, t_pre = t_tf.prefill(model, t_cfg,
                                   torch.from_numpy(tokens[:, :S]), chunk=8)
    j_logits, j_pre = _j_prefill(jparams, j_cfg, jnp.asarray(tokens[:, :S]),
                                 chunk=8)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               **LOGITS)
    t_cache = t_tf.init_kv_cache(t_cfg, B, S + STEPS, device="cpu")
    t_cache["k"][:, :, :S], t_cache["v"][:, :, :S] = t_pre["k"], t_pre["v"]
    t_cache["len"] = S
    j_cache = j_tf.init_kv_cache(j_cfg, B, S + STEPS)
    j_cache["k"] = j_cache["k"].at[:, :, :S].set(j_pre["k"])
    j_cache["v"] = j_cache["v"].at[:, :, :S].set(j_pre["v"])
    j_cache["len"] = jnp.asarray(S, jnp.int32)
    for step in range(STEPS):
        tok = tokens[:, S + step:S + step + 1]
        t_logits, t_cache = t_tf.decode_step(model, t_cfg,
                                             torch.from_numpy(tok), t_cache)
        j_logits, j_cache = _j_decode(jparams, j_cfg, jnp.asarray(tok),
                                      j_cache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   **LOGITS)


def test_lm_server_matches_reference(lm, monkeypatch):
    """Greedy streams of `_drive` through both servers."""
    j_cfg, t_cfg, jparams, model, _ = lm
    j_rec, t_rec = _Recorder(), _Recorder()
    monkeypatch.setattr(j_tf, "prefill", j_rec.prefill(_j_prefill))
    monkeypatch.setattr(t_tf, "prefill", t_rec.prefill(t_tf.prefill))
    j_srv = j_engine.LMServer(j_cfg, jparams, slots=2, max_seq=48)
    t_srv = t_engine.LMServer(t_cfg, model, slots=2, max_seq=48,
                              device="cpu")
    j_srv._decode = j_rec.decode(j_srv._decode, j_srv)
    monkeypatch.setattr(t_tf, "decode_step",
                        t_rec.decode(t_tf.decode_step, t_srv))
    assert _drive(t_srv) == _drive(j_srv) == [0, 1, 2, 3]
    assert len(t_rec.calls) == len(j_rec.calls)
    for (t_log, active), (j_log, _) in zip(t_rec.calls, j_rec.calls):
        np.testing.assert_allclose(t_log, j_log, **LOGITS)
        for row in active:
            a, b = int(np.argmax(t_log[row])), int(np.argmax(j_log[row]))
            if a != b:       # a near-tie: the histories part from here on
                gap = abs(float(j_log[row, a]) - float(j_log[row, b]))
                assert gap <= LOGITS["atol"] + LOGITS["rtol"] * abs(
                    float(j_log[row, b])), (row, a, b, gap)
                return
    assert ({c["req_id"]: list(map(int, c["tokens"]))
             for c in t_srv.completed}
            == {c["req_id"]: list(map(int, c["tokens"]))
                for c in j_srv.completed})


@pytest.mark.parametrize("cfg", [t_qwen_moe.FULL, t_granite.FULL],
                         ids=lambda c: c.name)
def test_full_moe_configs_build(cfg):
    """Every MoE FULL config builds (on the meta device: no memory), its
    expert stacks padded as the config says, the router float32."""
    model = t_tf.Transformer(cfg, device="meta")
    assert len(model.layers) == cfg.n_layers
    blk = model.layers[0]
    e = cfg.moe.n_experts_padded
    assert blk.mlp is None and blk.moe.router.dtype == torch.float32
    assert tuple(blk.moe.router.shape) == (cfg.d_model, e)
    assert tuple(blk.moe.w_gate.shape) == (e, cfg.d_model, cfg.moe.d_expert)
    assert tuple(blk.moe.w_down.shape) == (e, cfg.moe.d_expert, cfg.d_model)
    assert blk.moe.w_up.dtype == torch.bfloat16
