"""The port's serving layer held against `repro.serving`.

`ContinuousBatcher` is pure Python in both packages: on the streams of
tests/test_serving.py its decisions and clocks are bit-equal.  `LMServer`
mirrors test_lm_server_generates and is held to the reference server's
token streams on the same weights (float32, CPU): every prefill's and
decode step's logits agree to rtol 1e-5 / atol 1e-5 while the histories
agree, and where a greedy choice differs the test shows from the logits
that the two candidates were tied within that tolerance.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.base import LMConfig as JLMConfig
from repro.launch import elastic as j_elastic
from repro.models import transformer as j_tf
from repro.serving import engine as j_engine
from repro.serving import scheduler as j_sched
from repro.workloadgen import loadgen
from repro_torch import interop
from repro_torch.configs.base import LMConfig as TLMConfig
from repro_torch.launch import elastic as t_elastic
from repro_torch.models import transformer as t_tf
from repro_torch.serving import engine as t_engine
from repro_torch.serving import scheduler as t_sched

LOGITS = dict(rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- batcher
def _steady(mod):
    s = mod.ContinuousBatcher(max_batch=8, step_time_fn=lambda b: 0.01
                              + 0.001 * b, p_shards=8)
    for i, t in enumerate(loadgen.poisson_arrivals(200.0, 1.0, seed=0)):
        s.submit(mod.Request(req_id=i, arrival=float(t)))
    return s, [s.run_until(10.0)]


def _overload(mod, hedge):
    s = mod.ContinuousBatcher(max_batch=4, step_time_fn=lambda b: 0.05,
                              p_shards=64, hedge=hedge)
    for i, t in enumerate(loadgen.poisson_arrivals(300.0, 0.5, seed=1)):
        s.submit(mod.Request(req_id=i, arrival=float(t)))
    return s, [s.run_until(60.0)]


def _clamp(mod):
    s = mod.ContinuousBatcher(max_batch=4, step_time_fn=lambda b: 0.01)
    s.submit(mod.Request(req_id=0, arrival=5.0))
    t = s.run_until(2.0)
    return s, [t, s.run_until(10.0, now=t)]


def _gate(mod):
    s = mod.ContinuousBatcher(max_batch=4, step_time_fn=lambda b: 0.01,
                              hedge=False)
    s.submit(mod.Request(req_id=0, arrival=1.0))
    s.submit(mod.Request(req_id=1, arrival=50.0))
    return s, [s.run_until(10.0)]


def _overrun(mod):
    s = mod.ContinuousBatcher(max_batch=1, step_time_fn=lambda b: 5.0,
                              hedge=False)
    s.submit(mod.Request(req_id=0, arrival=0.0))
    return s, [s.run_until(1.0)]


STREAMS = {"steady": _steady, "hedged": lambda m: _overload(m, True),
           "unhedged": lambda m: _overload(m, False), "clamp": _clamp,
           "gate": _gate, "overrun": _overrun}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_batcher_bit_equal_to_reference(stream):
    (port, t_clock), (ref, j_clock) = (STREAMS[stream](m)
                                       for m in (t_sched, j_sched))
    assert t_clock == j_clock
    assert port.hedge_threshold == ref.hedge_threshold
    assert port.hedges_fired == ref.hedges_fired
    assert ([dataclasses.astuple(r) for r in port.done]
            == [dataclasses.astuple(r) for r in ref.done])
    assert ([dataclasses.astuple(r) for r in port.queue]
            == [dataclasses.astuple(r) for r in ref.queue])
    assert ([dataclasses.astuple(s) for s in port.stats]
            == [dataclasses.astuple(s) for s in ref.stats])
    assert port.latencies() == ref.latencies()
    if stream == "steady":
        assert len(port.done) > 100


@pytest.mark.parametrize("mean,p,cost", [(0.01, 1, 1.0), (0.01, 2, 1.0),
                                         (0.2, 64, 1.0), (3e-3, 100, 0.25)])
def test_hedge_threshold_equals_reference(mean, p, cost):
    assert (t_elastic.hedge_threshold(mean, p, duplicate_cost_fraction=cost)
            == j_elastic.hedge_threshold(mean, p,
                                         duplicate_cost_fraction=cost))


# ------------------------------------------------------------------ server
CFG = dict(name="srv", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
           d_ff=64, vocab_size=128, d_head=8, dtype="float32",
           vocab_pad_multiple=64)


class _Recorder:
    """Logits of every prefill and decode call, in call order, with the
    rows whose greedy choice the server keeps."""

    def __init__(self):
        self.calls = []

    def prefill(self, fn):
        def wrapped(*args, **kwargs):
            logits, cache = fn(*args, **kwargs)
            self.calls.append((np.asarray(logits[:, -1], np.float32), [0]))
            return logits, cache
        return wrapped

    def decode(self, fn, srv):
        def wrapped(*args, **kwargs):
            active = [i for i, s in enumerate(srv.slots) if s.remaining > 0]
            logits, cache = fn(*args, **kwargs)
            self.calls.append((np.asarray(logits[:, 0], np.float32), active))
            return logits, cache
        return wrapped


def _drive(srv):
    """Two slots, four requests: admissions as slots free up, so a later
    request reuses a slot (and its stale cache lines) mid-stream."""
    rng = np.random.default_rng(0)
    queue = [(0, rng.integers(0, 128, 4).astype(np.int32), 5),
             (1, rng.integers(0, 128, 4).astype(np.int32), 3),
             (2, rng.integers(0, 128, 8).astype(np.int32), 4),
             (3, rng.integers(0, 128, 16).astype(np.int32), 2)]
    admitted = []
    for _ in range(40):
        while queue and srv.admit(*queue[0]):
            admitted.append(queue.pop(0)[0])
        if not srv.step() and not queue:
            break
    return admitted


def test_lm_server_matches_reference_streams(monkeypatch):
    j_cfg, t_cfg = JLMConfig(**CFG), TLMConfig(**CFG)
    jparams = j_tf.init_params(jax.random.PRNGKey(0), j_cfg)
    model = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         t_cfg, device="cpu")
    j_rec, t_rec = _Recorder(), _Recorder()
    monkeypatch.setattr(j_tf, "prefill", j_rec.prefill(j_tf.prefill))
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
    done_t = {c["req_id"]: [int(x) for x in c["tokens"]]
              for c in t_srv.completed}
    done_j = {c["req_id"]: [int(x) for x in c["tokens"]]
              for c in j_srv.completed}
    assert done_t == done_j
    lengths = {0: 4 + 1 + 5, 1: 4 + 1 + 3, 2: 8 + 1 + 4, 3: 16 + 1 + 2}
    assert {r: len(t) for r, t in done_t.items()} == lengths
    assert all(0 <= t < t_cfg.vocab_padded for t in sum(done_t.values(), []))


def test_lm_server_refuses_weights_on_another_device():
    cfg = TLMConfig(**CFG)
    with pytest.raises(ValueError, match="weights are on cpu"):
        t_engine.LMServer(cfg, t_tf.init_params(0, cfg, device="cpu"),
                          device="meta")
