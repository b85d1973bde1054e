"""The port's `prefill` / `decode_step` held against
`repro.models.transformer`, on both SMOKE configs (and a tied-embedding
variant), in float32.

Weights are drawn by the reference and carried across with
`repro_torch.interop.lm_params_from_numpy`.  Logits and caches are
compared, never sampled tokens.  Tolerance: rtol 1e-5 with atol 1e-5 on
logits and caches (float32 rounding through a few layers; the values are
of order 1).  Prefill then decode is also held against the
reference's full forward pass (`forward_train`), the oracle for what a
cache must reproduce.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_1_7b as j_17b
from repro.configs import qwen3_8b as j_8b
from repro.models import transformer as j_tf
from repro_torch import interop
from repro_torch.configs import qwen3_1_7b as t_17b
from repro_torch.configs import qwen3_8b as t_8b
from repro_torch.models import transformer as t_tf

LOGITS = dict(rtol=1e-5, atol=1e-5)
CACHE = LOGITS
B, S, MAX_SEQ, STEPS = 2, 16, 32, 3

CONFIGS = {
    "qwen3-8b-smoke": (j_8b.SMOKE, t_8b.SMOKE),
    "qwen3-1.7b-smoke": (j_17b.SMOKE, t_17b.SMOKE),
    "tied": (dataclasses.replace(j_8b.SMOKE, tie_embeddings=True),
             dataclasses.replace(t_8b.SMOKE, tie_embeddings=True)),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    j_cfg, t_cfg = CONFIGS[request.param]
    jparams = j_tf.init_params(jax.random.PRNGKey(1), j_cfg)
    model = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         t_cfg, device="cpu")
    tokens = np.random.default_rng(2).integers(
        0, j_cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    return j_cfg, t_cfg, jparams, model, tokens


def _close(port, ref, tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **tol)


def test_prefill_logits_and_caches(pair):
    j_cfg, t_cfg, jparams, model, tokens = pair
    prompt = tokens[:, :S]
    t_logits, t_cache = t_tf.prefill(model, t_cfg, torch.from_numpy(prompt),
                                     chunk=8)
    j_logits, j_cache = j_tf.prefill(jparams, j_cfg, jnp.asarray(prompt),
                                     chunk=8)
    assert t_logits.shape == (B, 1, t_cfg.vocab_padded)
    _close(t_logits, j_logits, LOGITS)
    _close(t_cache["k"], j_cache["k"], CACHE)
    _close(t_cache["v"], j_cache["v"], CACHE)
    assert t_cache["len"] == int(j_cache["len"]) == S


def test_decode_steps_logits_and_caches(pair):
    j_cfg, t_cfg, jparams, model, tokens = pair
    _, t_pre = t_tf.prefill(model, t_cfg, torch.from_numpy(tokens[:, :S]),
                            chunk=8)
    t_cache = t_tf.init_kv_cache(t_cfg, B, MAX_SEQ, device="cpu")
    t_cache["k"][:, :, :S] = t_pre["k"]
    t_cache["v"][:, :, :S] = t_pre["v"]
    t_cache["len"] = S
    j_cache = j_tf.init_kv_cache(j_cfg, B, MAX_SEQ)
    j_cache["k"] = j_cache["k"].at[:, :, :S].set(
        jnp.asarray(t_pre["k"].numpy()))
    j_cache["v"] = j_cache["v"].at[:, :, :S].set(
        jnp.asarray(t_pre["v"].numpy()))
    j_cache["len"] = jnp.asarray(S, jnp.int32)
    j_step = jax.jit(lambda p, t, c: j_tf.decode_step(p, j_cfg, t, c))
    for step in range(STEPS):
        tok = tokens[:, S + step:S + step + 1]
        before = t_cache
        t_logits, t_cache = t_tf.decode_step(model, t_cfg,
                                             torch.from_numpy(tok), t_cache)
        j_logits, j_cache = j_step(jparams, jnp.asarray(tok), j_cache)
        assert before["len"] == S + step        # the dict passed in is kept
        assert t_cache["k"] is before["k"]      # the cache moved in place
        assert t_cache["len"] == int(j_cache["len"]) == S + step + 1
        _close(t_logits, j_logits, LOGITS)
        _close(t_cache["k"], j_cache["k"], CACHE)
        _close(t_cache["v"], j_cache["v"], CACHE)


def test_prefill_then_decode_matches_full_forward(pair):
    j_cfg, t_cfg, jparams, model, tokens = pair
    full, _ = j_tf.forward_train(jparams, j_cfg, jnp.asarray(tokens))
    logits, pre = t_tf.prefill(model, t_cfg, torch.from_numpy(tokens[:, :S]),
                               chunk=S)
    _close(logits[:, 0], full[:, S - 1], LOGITS)
    cache = t_tf.init_kv_cache(t_cfg, B, MAX_SEQ, device="cpu")
    cache["k"][:, :, :S], cache["v"][:, :, :S] = pre["k"], pre["v"]
    cache["len"] = S
    for step in range(STEPS):
        logits, cache = t_tf.decode_step(
            model, t_cfg, torch.from_numpy(tokens[:, S + step:S + step + 1]),
            cache)
        _close(logits[:, 0], full[:, S + step], LOGITS)
