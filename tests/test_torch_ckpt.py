"""The port's checkpoints held against `repro.ckpt.checkpoint`: the
checkpoint half of tests/test_runtime.py (roundtrip and garbage
collection, async and the manager, no ``.tmp`` left behind), the
reference's layout in both directions (a checkpoint either package
writes, the other restores), a bfloat16 leaf restored bit for bit, and
a model with its `TrainStep` state restored exactly.  Everything a
restore gives back is compared bitwise: a checkpoint rounds nothing.
"""

import dataclasses
import json
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as JCK
from repro_torch.ckpt import checkpoint as CK
from repro_torch.configs import granite_moe_3b_a800m as t_granite
from repro_torch.models import transformer as t_tf
from repro_torch.train.compression import Compressor
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import TrainStep


def test_checkpoint_roundtrip_and_gc():
    with tempfile.TemporaryDirectory() as d:
        tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 3))}}
        for s in (10, 20, 30, 40):
            CK.save(d, s, tree, keep_last=2)
        assert CK.latest_step(d) == 40
        kept = sorted(os.listdir(d))
        assert kept == ["step_00000030", "step_00000040"]
        restored = CK.restore(d, 40, tree)
        assert torch.equal(restored["a"], torch.arange(10.0))
        assert torch.equal(restored["b"]["c"], torch.ones((3, 3)))
        assert restored["a"] is not tree["a"]
        with pytest.raises(ValueError, match="shape"):
            CK.restore(d, 40, {"a": torch.zeros(9),
                               "b": {"c": torch.ones((3, 3))}})


def test_checkpoint_async_and_manager():
    with tempfile.TemporaryDirectory() as d:
        mgr = CK.CheckpointManager(d, every=5, keep_last=2)
        w = torch.ones((4,))
        for s in range(1, 16):
            w.add_(1.0)              # in place after the save: not saved
            mgr.maybe_save(s, {"w": w})
        mgr.wait()
        assert CK.latest_step(d) == 15
        step, restored = mgr.restore_latest({"w": torch.zeros(4)})
        assert step == 15
        assert torch.equal(restored["w"], torch.full((4,), 16.0))
        assert CK.CheckpointManager(os.path.join(d, "none")
                                    ).restore_latest({}) == (None, None)


def test_checkpoint_atomicity_no_tmp_left():
    with tempfile.TemporaryDirectory() as d:
        CK.save(d, 1, {"w": torch.ones((2,))})
        CK.save_async(d, 2, {"w": torch.ones((2,))}).join(timeout=60)
        assert not any(f.endswith(".tmp") for f in os.listdir(d))
        assert sorted(os.listdir(d)) == ["step_00000001", "step_00000002"]


def test_layout_is_the_reference_s():
    """The port's checkpoint of a dict of float32 arrays is the
    reference's (the same files, keys, shapes and dtypes), and each
    package restores the other's."""
    rng = np.random.default_rng(0)
    arrays = {"a": rng.normal(size=(5,)).astype(np.float32),
              "b": {"c": rng.normal(size=(2, 3)).astype(np.float32),
                    "n": np.arange(4, dtype=np.int32)}}
    port_tree = {"a": torch.from_numpy(arrays["a"]),
                 "b": {k: torch.from_numpy(v)
                       for k, v in arrays["b"].items()}}
    ref_tree = {"a": jnp.asarray(arrays["a"]),
                "b": {k: jnp.asarray(v) for k, v in arrays["b"].items()}}
    with tempfile.TemporaryDirectory() as d:
        CK.save(os.path.join(d, "port"), 3, port_tree)
        JCK.save(os.path.join(d, "ref"), 3, ref_tree)
        manifests = [json.load(open(os.path.join(d, w, "step_00000003",
                                                 "manifest.json")))
                     for w in ("port", "ref")]
        assert manifests[0] == manifests[1]
        assert sorted(os.listdir(os.path.join(d, "port", "step_00000003"))
                      ) == ["arrays.npz", "manifest.json"]
        from_ref = CK.restore(os.path.join(d, "ref"), 3, port_tree)
        from_port = JCK.restore(os.path.join(d, "port"), 3, ref_tree)
    for got in (from_ref["a"].numpy(), np.asarray(from_port["a"])):
        np.testing.assert_array_equal(got, arrays["a"])
    for k, v in arrays["b"].items():
        np.testing.assert_array_equal(from_ref["b"][k].numpy(), v)
        np.testing.assert_array_equal(np.asarray(from_port["b"][k]), v)


def test_bfloat16_leaf_restored_bit_for_bit():
    bits = np.array([0x0000, 0x8000, 0x0001, 0x807F, 0x3F80, 0x7F7F,
                     0x7F80, 0xFF80, 0x7FC1, 0x4049, 0xC2F7],
                    dtype=np.uint16)            # zeros, subnormals, inf, nan
    rand = np.random.default_rng(1).integers(0, 2**16, 4096,
                                             dtype=np.uint16)
    bits = np.concatenate([bits, rand])
    leaf = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    with tempfile.TemporaryDirectory() as d:
        CK.save(d, 5, {"x": leaf})
        manifest = json.load(open(os.path.join(d, "step_00000005",
                                               "manifest.json")))
        assert manifest["keys"]["x"] == {"shape": [bits.size],
                                         "dtype": "bfloat16"}
        with np.load(os.path.join(d, "step_00000005", "arrays.npz")) as z:
            np.testing.assert_array_equal(z["x"], bits)   # the raw bits
        out = CK.restore(d, 5, {"x": torch.zeros(bits.size,
                                                 dtype=torch.bfloat16)})["x"]
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.view(torch.int16).numpy()
                                  .view(np.uint16), bits)


def test_model_and_train_state_restored_exactly():
    """A bfloat16 model and its TrainStep state (AdamW moments, step, the
    compressor's residual) after one step, saved, then restored into a
    fresh model and state: every tensor bitwise, the module loaded in
    place."""
    cfg = dataclasses.replace(t_granite.SMOKE, dtype="bfloat16")
    model = t_tf.init_params(0, cfg, device="cpu")

    def loss_fn(p, batch):
        return t_tf.train_step_loss(p, cfg, batch["tokens"],
                                    batch["labels"])
    step = TrainStep(loss_fn, AdamW(lr=1e-3), compressor=Compressor("int8"))
    state = step.init_state(model)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int64))
    model, state, _ = step(model, state, {"tokens": tokens,
                                          "labels": tokens.roll(-1, 1)})
    fresh = t_tf.init_params(1, cfg, device="cpu")
    fresh_state = step.init_state(fresh)
    with tempfile.TemporaryDirectory() as d:
        CK.save(d, 1, {"params": model, "state": state})
        out = CK.restore(d, 1, {"params": fresh, "state": fresh_state})
    assert out["params"] is fresh
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              fresh.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    opt, got = state["opt"], out["state"]["opt"]
    assert type(got) is type(opt) and int(got.step) == 1
    assert got.step.dtype == torch.int32
    for name in opt.m:
        assert torch.equal(got.m[name], opt.m[name])
        assert torch.equal(got.v[name], opt.v[name])
        assert torch.equal(out["state"]["residual"][name],
                           state["residual"][name])
