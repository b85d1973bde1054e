"""The port's recommender training held against `repro.models.recsys`.

The reference's ``train_batch`` losses (`repro.launch.specs`): the CTR
loss of DeepFM, xDeepFM and AutoInt, and MIND's sampled softmax with
in-batch and with shared negatives, at the SMOKE configs in float32.
The reference's weights cross with `interop.recsys_params_from_numpy`;
the port's gradients go back through `interop.recsys_params_to_numpy`
and are held against `jax.value_and_grad`: the loss to rtol 1e-5, each
gradient tensor to 1e-4 of its largest entry (sums over a batch in
another order), with a floor of 1e-6 of the model's largest gradient
entry: MIND's last bias gradient is a sum that cancels to ~4e-5 of its
terms (out_mlp/0/b's size), so float32 leaves ~1 % of it noise in both
packages (against the float64 gradient: the reference 4.3e-10, the port
8.2e-10, of 9.0e-8).  One `TrainStep` (AdamW; xDeepFM in two
microbatches, MIND with shared negatives in one) against the
reference's, by relative L2 a tensor (Adam's first step is g / |g|: an
element whose gradient is within rounding of 0 may step either way).
Here the bag and the CIN run their plain versions inside the port's
`torch.autograd.Function`s, whose hand-written backward `gradcheck`
holds in float64; a masked id gets no gradient; a recommender's
parameter dict round-trips through a checkpoint bit for bit.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import recsys as j_recsys
from repro.train.optimizer import AdamW as JAdamW
from repro.train.optimizer import AdamWState as JAdamWState
from repro.train.trainer import TrainStep as JTrainStep
from repro_torch import interop
from repro_torch._segment import gather_rows, segment_sum
from repro_torch.ckpt import checkpoint as CK
from repro_torch.configs import registry as t_registry
from repro_torch.data import recsys_data as t_data
from repro_torch.kernels.cin_fuse import ref as cin_ref
from repro_torch.kernels.cin_fuse.autograd import CinFunction
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag import ref as bag_ref
from repro_torch.kernels.embedding_bag.autograd import BagFunction
from repro_torch.models import recsys as t_recsys
from repro_torch.train.optimizer import AdamW, named_tensors
from repro_torch.train.trainer import TrainStep

LOSS_RTOL, GRAD_RTOL, STEP_RL2 = 1e-5, 1e-4, 1e-3
NOISE_FLOOR = 1e-6     # of the model's largest gradient entry (float32)
B = 32
N_NEG = 48
CTR = ("deepfm", "xdeepfm", "autoint")
LOGITS = {"deepfm": "deepfm_logits", "xdeepfm": "xdeepfm_logits",
          "autoint": "autoint_logits"}


def _flat(tree):
    """path -> numpy array of a nested tree of dicts and lists."""
    return {k: np.asarray(v) for k, v in named_tensors(tree).items()}


def _rel_l2(x, y) -> float:
    return float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30))


class Case:
    """One model and batch: the reference's tree, the port's params and
    the inputs of both."""

    def __init__(self, arch, negs):
        self.arch = arch
        self.j_cfg = j_registry.get_arch(arch).smoke_config
        self.cfg = t_registry.get_arch(arch).smoke_config
        init = getattr(j_recsys, "init_mind" if arch == "mind"
                       else f"init_{arch}")
        self.tree = jax.tree_util.tree_map(
            np.asarray, init(jax.random.key(0), self.j_cfg))
        if arch == "mind":
            hist, mask, target = t_data.mind_batch(self.cfg, B, step=2,
                                                   seed=1)
            self.batch = {"hist": hist, "mask": mask, "target": target}
            if negs:
                self.batch["negs"] = t_recsys.mind_negatives(
                    3, self.cfg, N_NEG, device="cpu").numpy()
            self.loss_fn = t_recsys.mind_train_loss(self.cfg)
        else:
            ids, mask, labels = t_data.ctr_batch(self.cfg, B, step=2,
                                                 seed=1)
            self.batch = {"ids": ids, "mask": mask, "labels": labels}
            self.loss_fn = t_recsys.ctr_train_loss(self.cfg)
        self.j_value_and_grad = jax.jit(jax.value_and_grad(self.j_loss))

    def params(self):
        p = interop.recsys_params_from_numpy(self.tree, self.cfg,
                                             device="cpu")
        for t in named_tensors(p).values():
            t.requires_grad_(True)
        return p

    def torch_batch(self):
        return {k: torch.from_numpy(np.asarray(v))
                for k, v in self.batch.items()}

    def j_loss(self, params, batch):
        cfg = self.j_cfg
        if self.arch == "mind":
            negs = batch.get("negs")
            lg = j_recsys.mind_train_logits(
                params, cfg, batch["hist"], batch["mask"], batch["target"],
                negs)
            return j_recsys.sampled_softmax_loss(lg, inbatch=negs is None)
        lg = getattr(j_recsys, LOGITS[self.arch])(params, cfg, batch["ids"],
                                                  batch["mask"])
        return j_recsys.ctr_loss(lg, batch["labels"])

    def j_batch(self):
        out = {k: jnp.asarray(v) for k, v in self.batch.items()}
        for k in ("ids", "hist", "target", "negs"):
            if k in out:
                out[k] = out[k].astype(jnp.int32)
        return out


CASES = [(a, False) for a in CTR] + [("mind", False), ("mind", True)]
IDS = list(CTR) + ["mind-inbatch", "mind-shared-negatives"]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    return Case(*request.param)


def test_loss_and_gradients_match_reference(case):
    j_loss, j_grads = case.j_value_and_grad(case.tree, case.j_batch())
    params = case.params()
    named = named_tensors(params)
    loss = case.loss_fn(params, case.torch_batch())
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=LOSS_RTOL)
    port = _flat(interop.recsys_params_to_numpy(dict(zip(named, grads))))
    ref = _flat(j_grads)
    assert port.keys() == ref.keys() == set(named)
    floor = NOISE_FLOOR * max(float(np.abs(g).max()) for g in ref.values())
    for k, g in ref.items():
        atol = max(GRAD_RTOL * float(np.abs(g).max()), floor)
        np.testing.assert_allclose(port[k], g, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("arch,negs,micro", [("xdeepfm", False, 2),
                                             ("mind", True, 1)],
                         ids=["xdeepfm", "mind-shared-negatives"])
def test_adamw_step_matches_reference(arch, negs, micro):
    """xDeepFM in two microbatches; MIND's shared negatives in one, as
    the reference's train_batch cell steps (both TrainSteps split every
    batch entry, the negatives too)."""
    case = Case(arch, negs)
    j_step = JTrainStep(case.j_loss, JAdamW(lr=1e-2), microbatches=micro)
    j_params, _, j_l = jax.jit(j_step)(
        case.tree, j_step.init_state(case.tree), case.j_batch())
    step = TrainStep(case.loss_fn, AdamW(lr=1e-2), microbatches=micro)
    params = case.params()
    state = step.init_state(params)
    params, state, loss = step(params, state, case.torch_batch())
    np.testing.assert_allclose(float(loss), float(j_l), rtol=LOSS_RTOL)
    port = _flat(interop.recsys_params_to_numpy(params))
    for k, w in _flat(j_params).items():
        assert _rel_l2(port[k], w) <= STEP_RL2, k
    assert int(state["opt"].step) == 1


@pytest.mark.parametrize("arch", ["xdeepfm", "mind"])
def test_adamw_update_from_a_reference_state(arch):
    """One AdamW update of a recommender's dict from a non-zero state in
    the reference's layout (`interop.adamw_state_from_numpy`): weights
    and both moments against the reference's update, to float32
    rounding."""
    case = Case(arch, False)
    rng = np.random.default_rng(8)
    tree = case.tree
    grads, m, v = (jax.tree.map(lambda a, s=s: (s * rng.standard_normal(
        a.shape)).astype(np.float32), tree) for s in (1e-2, 1e-2, 1e-4))
    v = jax.tree.map(np.abs, v)
    j_opt = JAdamW(lr=1e-2, weight_decay=0.05)
    j_params, j_state = jax.jit(j_opt.update)(
        grads, JAdamWState(step=jnp.asarray(5, jnp.int32), m=m, v=v), tree)
    params = case.params()
    state = interop.adamw_state_from_numpy((np.int32(5), m, v), params)
    grads_t = {k: torch.from_numpy(np.asarray(g))
               for k, g in _flat(grads).items()}
    _, new = AdamW(lr=1e-2, weight_decay=0.05).update(grads_t, state, params)
    assert int(new.step) == int(j_state.step) == 6
    for port, ref in ((interop.recsys_params_to_numpy(params), j_params),
                      (interop.recsys_params_to_numpy(new.m), j_state.m),
                      (interop.recsys_params_to_numpy(new.v), j_state.v)):
        port = _flat(port)
        for k, want in _flat(ref).items():
            np.testing.assert_allclose(port[k], want, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_function_backwards_gradcheck():
    """Both Functions' hand-written backward in float64, with the plain
    forward standing in for the kernel; the segment sum and the row
    gather beside them."""
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(20, 3, dtype=torch.float64, generator=gen,
                        requires_grad=True)
    ids = torch.randint(0, 20, (4, 5, 3), generator=gen)
    mask = torch.rand(4, 5, 3, generator=gen) < 0.6
    mask[0, 0] = False                              # an empty bag
    ids = torch.where(mask, ids, 10_000)            # masked ids past the end
    assert torch.autograd.gradcheck(
        lambda t: BagFunction.apply(t, ids, mask,
                                    bag_ref.embedding_bag_masked),
        (table,))
    xk, x0, w = (torch.randn(s, dtype=torch.float64, generator=gen,
                             requires_grad=True)
                 for s in ((3, 4, 5), (3, 2, 5), (8, 6)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: CinFunction.apply(a, b, c, cin_ref.cin_layer_ref),
        (xk, x0, w))
    data = torch.randn(40, 3, dtype=torch.float64, generator=gen,
                       requires_grad=True)
    seg = torch.randint(-1, 9, (40,), generator=gen)  # -1 and 8: dropped
    assert torch.autograd.gradcheck(lambda d: segment_sum(d, seg, 8), (data,))
    assert torch.autograd.gradcheck(
        lambda t: gather_rows(t, ids[..., 0] % 20), (table,))


def test_segment_sum_long_runs_and_dropped_ids():
    """Runs of 1 to 5,000 equal ids summed in float32 to float32 rounding
    of the float64 sum; ids outside [0, n) dropped."""
    gen = torch.Generator().manual_seed(1)
    ids = torch.cat([torch.full((5000,), 2), torch.arange(7), torch.full(
        (300,), 9), torch.full((50,), -3)])[torch.randperm(5357,
                                                           generator=gen)]
    data = torch.randn(5357, 4, generator=gen)
    got = segment_sum(data, ids, 7)
    kept = (ids >= 0) & (ids < 7)
    expect = torch.zeros(7, 4, dtype=torch.float64).index_add_(
        0, ids[kept], data[kept].double())
    torch.testing.assert_close(got.double(), expect, rtol=1e-5, atol=1e-5)


def test_masked_id_gets_no_gradient():
    """A row read only under a masked entry gets exactly zero; a bag with
    no ids adds nothing; the ids and the mask get no gradient."""
    table = torch.randn(12, 4, requires_grad=True)
    ids = torch.tensor([[[1, 5, 7], [3, 3, 7]]])
    mask = torch.tensor([[[True, False, True], [False, False, False]]])
    out = bag_ops.embedding_bag(table, ids, mask)
    (g,) = torch.autograd.grad((out * torch.arange(8.0).reshape(1, 2, 4))
                               .sum(), table)
    read = torch.zeros(12, dtype=torch.bool)
    read[[1, 7]] = True
    assert torch.equal(g[~read], torch.zeros_like(g[~read]))
    torch.testing.assert_close(g[1], torch.arange(4.0) / 2)
    torch.testing.assert_close(g[7], torch.arange(4.0) / 2)


def test_checkpoint_round_trip_of_recommender_dict():
    """A recommender's nested dict (dicts and lists) and its AdamW state
    save and restore through the port's checkpoint bit for bit."""
    cfg = t_registry.get_arch("xdeepfm").smoke_config
    params = t_recsys.init_xdeepfm(5, cfg, device="cpu")
    state = AdamW().init(params)
    with tempfile.TemporaryDirectory() as d:
        CK.save(d, 3, {"params": params, "opt": state})
        like = {"params": t_recsys.init_xdeepfm(6, cfg, device="cpu"),
                "opt": AdamW().init(params)}
        back = CK.restore(d, 3, like)
    assert isinstance(back["params"]["mlp"], list)
    for k, t in named_tensors(params).items():
        assert torch.equal(named_tensors(back["params"])[k], t), k
    assert back["opt"].m.keys() == state.m.keys()
