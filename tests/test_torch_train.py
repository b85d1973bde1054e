"""The port's training runtime held against `repro.train` and
`repro.data.pipeline` on the CPU: the training half of
tests/test_runtime.py (AdamW converges, microbatches equal the full
batch, clipping, the cosine schedule, error feedback and int8's
quantization error) on the same parameters and batches, one AdamW and
one SGD update from a non-zero state on an LM's parameters, and the
token pipeline bit for bit.

Tolerances, float32: a schedule value rtol 1e-6 (the same operations
in the same order; a few ulps where the two libraries round a power or
a cosine differently); a single update of an LM's weights and moments
rtol 1e-6 with atol 1e-6 of each tensor's largest entry (XLA contracts
b * m + (1 - b) * g into a fused multiply-add, one rounding fewer, so a
moment that cancels to near zero differs by an ulp of its tensor's
scale); trajectories of the toy
problem rtol 1e-5 over their first 20 steps (sums of 64 products in
another order), the convergence thresholds of the reference's own
tests after that; compression of the same float32 values bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.configs import granite_moe_3b_a800m as j_granite
from repro.data.pipeline import LMBatchPipeline as JPipeline
from repro.models import transformer as j_tf
from repro.train import optimizer as j_opt
from repro.train.compression import Compressor as JCompressor
from repro.train.trainer import TrainStep as JTrainStep
from repro_torch import interop
from repro_torch.configs import granite_moe_3b_a800m as t_granite
from repro_torch.data.pipeline import LMBatchPipeline
from repro_torch.train.compression import Compressor
from repro_torch.train.optimizer import (SGD, AdamW, SGDState,
                                         clip_by_global_norm,
                                         cosine_schedule)
from repro_torch.train.trainer import TrainStep
from test_torch_moe import _numpy_weights

TRAJECTORY = 20


def _toy():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 1)).astype(np.float32)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    return {"x": x, "y": x @ w}


def _loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def _j_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2)


def _both(w_fill):
    t = nn.ParameterDict({"w": torch.full((8, 1), w_fill),
                          "b": torch.zeros(1)})
    j = {"w": jnp.full((8, 1), w_fill), "b": jnp.zeros((1,))}
    return t, j


def _run(step, j_step, params, j_params, steps):
    """``steps`` steps of both; returns (port losses, reference losses,
    the port's state)."""
    batch = {k: torch.from_numpy(v) for k, v in _toy().items()}
    j_batch = {k: jnp.asarray(v) for k, v in _toy().items()}
    state, j_state = step.init_state(params), j_step.init_state(j_params)
    jitted = jax.jit(j_step)
    losses, j_losses = [], []
    for _ in range(steps):
        params, state, loss = step(params, state, batch)
        j_params, j_state, j_l = jitted(j_params, j_state, j_batch)
        losses.append(float(loss))
        j_losses.append(float(j_l))
    return np.array(losses), np.array(j_losses), state


def test_adamw_converges():
    params, j_params = _both(0.0)
    step = TrainStep(loss_fn=_loss, optimizer=AdamW(lr=3e-2))
    j_step = JTrainStep(loss_fn=_j_loss, optimizer=j_opt.AdamW(lr=3e-2))
    losses, j_losses, state = _run(step, j_step, params, j_params, 200)
    np.testing.assert_allclose(losses[:TRAJECTORY], j_losses[:TRAJECTORY],
                               rtol=1e-5)
    assert losses[-1] < losses[0] * 1e-3
    assert state["opt"].step.dtype == torch.int32
    assert int(state["opt"].step) == 200
    assert all(m.dtype == torch.float32 for m in state["opt"].m.values())


def test_microbatch_equals_full_batch():
    """Gradient accumulation is exact for mean losses over equal splits,
    and the port's microbatched step is the reference's."""
    out = {}
    for n in (1, 4):
        params, j_params = _both(1.0)
        opt = SGD(lr=0.1, momentum=0.0, clip_norm=0.0)
        j_o = j_opt.SGD(lr=0.1, momentum=0.0, clip_norm=0.0)
        step = TrainStep(loss_fn=_loss, optimizer=opt, microbatches=n)
        j_step = JTrainStep(loss_fn=_j_loss, optimizer=j_o, microbatches=n)
        losses, j_losses, _ = _run(step, j_step, params, j_params, 1)
        np.testing.assert_allclose(losses, j_losses, rtol=1e-6)
        out[n] = (params["w"].detach().clone(), losses[0])
    torch.testing.assert_close(out[4][0], out[1][0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(out[4][1], out[1][1], rtol=1e-5)
    params, _ = _both(1.0)
    step3 = TrainStep(loss_fn=_loss, microbatches=3)    # 64 rows
    with pytest.raises(ValueError, match="microbatches"):
        step3(params, step3.init_state(params),
              {k: torch.from_numpy(v) for k, v in _toy().items()})


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0),
         "c": torch.full((4,), 2.0, dtype=torch.bfloat16)}
    clipped = clip_by_global_norm(g, 1.0)
    norm = float(torch.sqrt(sum(x.float().square().sum()
                                for x in clipped.values())))
    assert np.isclose(norm, 1.0, rtol=1e-2)      # c rounds to bfloat16
    assert clipped["c"].dtype == torch.bfloat16
    ref = j_opt.clip_by_global_norm(
        {k: jnp.asarray(v.float().numpy()).astype(
            jnp.bfloat16 if k == "c" else jnp.float32)
         for k, v in g.items()}, 1.0)
    for k in g:
        np.testing.assert_allclose(clipped[k].float().numpy(),
                                   np.asarray(ref[k], np.float32),
                                   rtol=1e-6)
    assert clip_by_global_norm(g, 0.0)["a"] is g["a"]     # off
    small = {"a": torch.full((4,), 0.1)}
    assert torch.equal(clip_by_global_norm(small, 1.0)["a"], small["a"])


def test_cosine_schedule_shape():
    lr = cosine_schedule(1e-3, warmup=10, total=100)
    j_lr = j_opt.cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(torch.tensor(0, dtype=torch.int32))) < 1e-4
    assert np.isclose(float(lr(torch.tensor(10))), 1e-3, rtol=1e-5)
    assert float(lr(torch.tensor(100))) < 2e-4
    steps = np.arange(0, 121, dtype=np.int32)
    port = lr(torch.from_numpy(steps))
    assert port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), np.asarray(
        j_lr(jnp.asarray(steps))), rtol=1e-6)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compression_error_feedback(mode):
    """Residual stays bounded and compressed training still converges;
    the first 20 steps are the reference's."""
    params, j_params = _both(0.0)
    step = TrainStep(loss_fn=_loss, optimizer=AdamW(lr=3e-2),
                     compressor=Compressor(mode))
    j_step = JTrainStep(loss_fn=_j_loss, optimizer=j_opt.AdamW(lr=3e-2),
                        compressor=JCompressor(mode))
    losses, j_losses, state = _run(step, j_step, params, j_params, 150)
    np.testing.assert_allclose(losses[:TRAJECTORY], j_losses[:TRAJECTORY],
                               rtol=1e-5)
    assert losses[-1] < 1e-3
    res_norm = max(float(r.abs().max()) for r in state["residual"].values())
    assert res_norm < 1.0  # error feedback keeps residual bounded


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_compress_equals_reference(mode):
    """One compression of the same float32 gradients and residual: the
    values on the wire and the new residual bitwise the reference's."""
    rng = np.random.default_rng(3)
    g = {"w": rng.normal(size=(64, 8)).astype(np.float32),
         "b": (rng.normal(size=(8,)) * 1e-3).astype(np.float32)}
    r = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
         for k, v in g.items()}
    comp = Compressor(mode)
    q, res = comp.compress({k: torch.from_numpy(v) for k, v in g.items()},
                           {k: torch.from_numpy(v) for k, v in r.items()})
    j_q, j_res = JCompressor(mode).compress(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in r.items()})
    for k in g:
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(j_q[k]))
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(j_res[k]))
    assert comp.wire_bytes_per_element() == \
        JCompressor(mode).wire_bytes_per_element()
    assert (comp.init(q) == ()) == (mode == "none")


def test_compression_int8_quantization_error():
    comp = Compressor("int8")
    g = {"w": torch.linspace(-1, 1, 100)}
    q, _ = comp.compress(g, comp.init(g))
    err = float((q["w"] - g["w"]).abs().max())
    assert err <= 1.0 / 127.0 + 1e-6


@pytest.mark.parametrize("kw", [
    dict(seed=0, step=0), dict(seed=0, step=17),
    dict(seed=3, step=5, shard=1, n_shards=2),
    dict(seed=1, step=2, shard=3, n_shards=4, vocab=151936)])
def test_lm_batch_pipeline_bitwise(kw):
    kw = dict(kw)
    vocab = kw.pop("vocab", 8192)
    seed = kw.pop("seed")
    args = dict(vocab_size=vocab, seq_len=64, global_batch=8,
                coherence=0.7, seed=seed)
    port = LMBatchPipeline(**args).batch(**kw)
    ref = JPipeline(**args).batch(**kw)
    for p, r in zip(port, ref):
        assert p.dtype == r.dtype == np.int32
        np.testing.assert_array_equal(p, r)
    with pytest.raises(ValueError, match="shards"):
        LMBatchPipeline(**args).batch(0, n_shards=3)


# ----------------------------------------------- one update on an LM's weights

def _lm_update_inputs():
    """granite-moe-smoke's weights, gradients and a non-zero optimizer
    state in the reference's layout (numpy), and the port's model."""
    cfg = j_granite.SMOKE
    shapes = jax.eval_shape(lambda: j_tf.init_params(jax.random.PRNGKey(0),
                                                     cfg))
    tree = _numpy_weights(shapes, 0)
    grads = _numpy_weights(shapes, 1)
    m = jax.tree.map(lambda g: g * 0.1, _numpy_weights(shapes, 2))
    v = jax.tree.map(lambda g: np.square(g) * 0.01 + 1e-6,
                     _numpy_weights(shapes, 3))
    model = interop.lm_params_from_numpy(tree, t_granite.SMOKE, device="cpu")
    return tree, grads, m, v, model


def _port_named(tree):
    """name -> float32 tensor, in the port's layout, of a tree in the
    reference's layout (through a `Transformer` of those values)."""
    return {k: p.detach().float() for k, p in interop.lm_params_from_numpy(
        tree, t_granite.SMOKE, device="cpu").named_parameters()}


def _check_lm(port, ref, what):
    """A port tensor map (by parameter name) against the reference's
    tree of the same values."""
    def walk(p, r, path):
        if isinstance(r, dict):
            assert set(p) == set(r), path
            for k in r:
                walk(p[k], r[k], f"{path}/{k}")
        else:
            r = np.asarray(r)
            np.testing.assert_allclose(
                p, r, rtol=1e-6, atol=1e-6 * float(np.abs(r).max()),
                err_msg=f"{what}{path}")
    walk(interop.lm_params_to_numpy(port, t_granite.SMOKE), ref, "")


def test_adamw_update_from_a_nonzero_state():
    tree, grads, m, v, model = _lm_update_inputs()
    lr = cosine_schedule(1e-2, warmup=3, total=50)
    opt = AdamW(lr=lr, weight_decay=0.05, clip_norm=0.5)
    j_o = j_opt.AdamW(lr=j_opt.cosine_schedule(1e-2, warmup=3, total=50),
                      weight_decay=0.05, clip_norm=0.5)
    j_state = j_opt.AdamWState(step=jnp.asarray(7, jnp.int32), m=m, v=v)
    new_params, j_new = jax.jit(j_o.update)(grads, j_state, tree)
    state = interop.adamw_state_from_numpy(
        (np.int32(7), m, v), model)
    _, new = opt.update(_port_named(grads), state, model)
    assert int(new.step) == int(j_new.step) == 8
    _check_lm(model, new_params, "params")
    _check_lm(new.m, j_new.m, "m")
    _check_lm(new.v, j_new.v, "v")


def test_sgd_update_from_a_nonzero_state():
    tree, grads, mom, _, model = _lm_update_inputs()
    opt = SGD(lr=0.05, momentum=0.9, clip_norm=2.0)
    j_o = j_opt.SGD(lr=0.05, momentum=0.9, clip_norm=2.0)
    j_state = j_opt.SGDState(step=jnp.asarray(4, jnp.int32), momentum=mom)
    new_params, j_new = jax.jit(j_o.update)(grads, j_state, tree)
    state = SGDState(step=torch.tensor(4, dtype=torch.int32),
                     momentum=_port_named(mom))
    _, new = opt.update(_port_named(grads), state, model)
    assert int(new.step) == int(j_new.step) == 5
    _check_lm(model, new_params, "params")
    _check_lm(new.momentum, j_new.momentum, "momentum")
