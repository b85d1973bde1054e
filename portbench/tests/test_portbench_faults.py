"""The check against faults: a run whose timed path is broken underneath
must come out not correct.  Each case drives the rest of a run on the CPU
at a tiny size (the look for a card skipped) with one fault planted in
the program, or the control (the reference in bfloat16) in its place; a
faulted cell also with its fault path broken, one channel at a time."""

from __future__ import annotations

import dataclasses
import math
import types

import pytest
import torch

from portbench import run
from portbench.bench import cells
from portbench.reference import forkjoin, rng_plan

CELLS = ["t6-r1-whatif", "t6-r4-jsq-whatif", "t6-r1-shard4",
         "t6-r4-jsq-faulted"]
FAULT_ROWS = ("degraded_count", "spill_count", "unavail_count")


def _run(root, name, seed=2**32 + 17):
    cell = cells.load_cell(name, root)
    return run.run_cell(cell, seed=seed, seconds=0.1, trace=False,
                        device="cpu", setup_clock=lambda: 1.0, root=root)


def _drop_carries(monkeypatch):
    """A step that returns its state unchanged: every chunk starts from
    empty queues, as if the carries were never written."""
    from repro_torch.core import simulator
    plain, segmented = (simulator.fcfs_completion_times,
                        simulator._fcfs_segmented)

    def fcfs(arrivals, services, impl="auto", carry=None):
        return plain(arrivals, services, impl=impl)

    def seg(arrivals, services, flags, heads, carry, impl):
        return segmented(arrivals, services, flags, heads,
                         torch.full_like(carry, -math.inf), impl)

    monkeypatch.setattr(simulator, "fcfs_completion_times", fcfs)
    monkeypatch.setattr(simulator, "_fcfs_segmented", seg)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: the
    queries of the second half are never simulated, and the count says
    they were."""
    from repro_torch.core import simulator
    plain = simulator.simulate_fork_join_batch

    def half(seed, lam, params, n_queries, **kw):
        res = plain(seed, lam, params, n_queries // 2, **kw)
        full = n_queries - int(n_queries * kw["warmup_fraction"])
        return dataclasses.replace(
            res, count=torch.full_like(res.count, float(full)),
            sum_response=res.sum_response * full / res.count)

    monkeypatch.setattr(simulator, "simulate_fork_join_batch", half)


def _altered_answer(monkeypatch):
    """One answer altered where it is produced: scenario 0's response sum
    off by one part in a thousand."""
    from repro_torch.core import simulator
    plain = simulator.simulate_fork_join_batch

    def altered(*args, **kw):
        res = plain(*args, **kw)
        res.sum_response[0] *= 1.001
        return res

    monkeypatch.setattr(simulator, "simulate_fork_join_batch", altered)


def _control(monkeypatch):
    """The control: the reference in bfloat16 in the program's place (the
    batch entry a slab runs, and the sweep a grid runs, shard by shard)."""
    from repro_torch.core import simulator, sweep

    class Out:
        def __init__(self, ref):
            self.mean_response = ref["mean"].float()
            self.q = ref["quantile"].float()
            self.count = ref["count"].float()
            for k in FAULT_ROWS:
                setattr(self, k, ref[k].float() if k in ref else None)

        def quantile(self, q):
            return self.q

    def control(seed, lam, params, n_queries, *, p, mode, warmup_fraction,
                chunk_size, hist_bins, cluster, device, dtype):
        fields = {f: getattr(params, f) for f in
                  ("s_broker", "s_hit", "s_miss", "s_disk", "hit")}
        kw = {}
        if cluster.fault is not None:
            f = cluster.fault
            kw["fault"] = {
                "outages": f.outages, "mtbf_seconds": f.mtbf_seconds,
                "mttr_seconds": f.mttr_seconds, "degraded": f.degraded,
                "broker_timeout_seconds": f.broker_timeout_seconds,
                "quorum_k": f.quorum_k}
        return Out(forkjoin.simulate(
            seed, lam, fields, p=p, n_queries=n_queries, chunk=chunk_size,
            warmup_fraction=warmup_fraction, hist_bins=hist_bins,
            quantile=0.95, mode=mode, r=cluster.r, routing=cluster.routing,
            result_cache=cluster.result_cache, dtype=torch.bfloat16,
            route_dtype=torch.bfloat16, **kw))

    def control_sweep(grid, seed, *, n_queries, mode, warmup_fraction,
                      chunk_size, hist_bins, cluster, mesh, dtype):
        from repro_torch.core.cluster import ClusterSpec
        lam, params = grid.broadcast_full()
        lam = lam.reshape(-1)
        spec = ClusterSpec(r=int(grid.r[0]), routing=cluster.routing,
                           result_cache=cluster.result_cache)
        rows = []
        for s, idx in zip(rng_plan.shard_seeds(seed, mesh.size),
                          rng_plan.shard_rows(lam.shape[0], mesh.size)):
            shard = types.SimpleNamespace(**{
                f: getattr(params, f).reshape(-1)[idx] for f in
                ("s_broker", "s_hit", "s_miss", "s_disk", "hit")})
            ref = control(s, lam[idx], shard, n_queries, p=int(grid.p[0]),
                          mode=mode, warmup_fraction=warmup_fraction,
                          chunk_size=chunk_size, hist_bins=hist_bins,
                          cluster=spec, device=None, dtype=dtype)
            rows.append(torch.stack([ref.mean_response, ref.q, ref.count]))
        out = torch.cat(rows, dim=1)[:, :lam.shape[0]].reshape(
            (3,) + grid.shape)
        return types.SimpleNamespace(
            mean=out[0], quantile=lambda q: out[1],
            stats=types.SimpleNamespace(count=out[2]))

    monkeypatch.setattr(simulator, "simulate_fork_join_batch", control)
    monkeypatch.setattr(sweep, "sweep_simulated", control_sweep)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_root, name):
    assert _run(tiny_root, name)["correct"] is True


@pytest.mark.parametrize("fault", [_drop_carries, _half_batch,
                                   _altered_answer, _control],
                         ids=["state_unchanged", "half_batch",
                              "altered_answer", "control_bf16"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(tiny_root, monkeypatch, name, fault):
    fault(monkeypatch)
    line = _run(tiny_root, name)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def _with_fault(monkeypatch, **change):
    """The program run with its `FaultSpec` changed (``fault=None``: no
    fault at all)."""
    from repro_torch.core import simulator
    plain = simulator.simulate_fork_join_batch

    def changed(*args, cluster, **kw):
        fault = change["fault"] if "fault" in change else \
            dataclasses.replace(cluster.fault, **change)
        return plain(*args, cluster=dataclasses.replace(cluster, fault=fault),
                     **kw)

    monkeypatch.setattr(simulator, "simulate_fork_join_batch", changed)


def _mask_dropped(monkeypatch):
    """The router routes as if every replica were up: the up mask it is
    handed is ignored, so no query spills and none is unavailable."""
    from repro_torch.kernels.jsq_route import ops
    plain = ops.jsq_route

    def unmasked(w, gaps, services, live, *, n_act=None, up=None,
                 impl="auto"):
        return plain(w, gaps, services, live, n_act=n_act,
                     up=None if up is None else torch.ones_like(up),
                     impl=impl)

    monkeypatch.setattr(ops, "jsq_route", unmasked)


def _wrong_salt(monkeypatch):
    """The MTBF/MTTR chain drawn from a stream on another salt."""
    from repro_torch.core import simulator
    monkeypatch.setattr(simulator, "_FAULT_SALT", rng_plan.FAULT_SALT + 1)


# broken fault path -> (the change, the checks it must fail besides the
# mean's or the quantile's, which any of them may also fail)
BROKEN = {
    "fault_none": (lambda mp: _with_fault(mp, fault=None),
                   ("degraded_frac_gap", "spill_frac_gap", "unavail_diff")),
    "timeout_ignored": (lambda mp: _with_fault(
        mp, broker_timeout_seconds=None), ("degraded_frac_gap",)),
    "k_equals_p": (lambda mp: _with_fault(mp, quorum_k=10**6),
                   ("degraded_frac_gap",)),
    "mask_dropped": (_mask_dropped, ("spill_frac_gap", "unavail_diff")),
    "slowdown_dropped": (lambda mp: _with_fault(mp, degraded=()),
                         ("degraded_frac_gap",)),
    "wrong_salt": (_wrong_salt, ("unavail_diff",)),
}


@pytest.mark.parametrize("broken", sorted(BROKEN))
def test_broken_fault_path_is_not_correct(tiny_root, monkeypatch, broken):
    plant, counts = BROKEN[broken]
    plant(monkeypatch)
    line = _run(tiny_root, "t6-r4-jsq-faulted")
    assert line["correct"] is False
    over = {k for k, c in line["checks"].items() if c["value"] > c["limit"]}
    assert set(counts) <= over, over
