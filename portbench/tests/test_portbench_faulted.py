"""The reference under faults (`reference/forkjoin.py` with
`reference/faulted.py`'s channels) against the program's
faulted path, on the same variates, at a tiny slab on the CPU: each fault
channel alone and all together; and the loading of a configuration's
``fault``."""

from __future__ import annotations

import json

import pytest
import torch

from portbench.bench import cells, system
from portbench.inputs import table6
from portbench.reference import faulted, forkjoin

P, N, CHUNK = 8, 1024, 256
SLAB = {"memory": [1, 4], "cpu": [1, 4], "disk": [1], "rho": [0.3, 0.85]}
CACHE = (0.2, 2e-3)
# float32 program against a float64 reference (`test_portbench_reference`)
RTOL = 1e-5
CELL = "t6-r4-jsq-faulted"
CONFIG = "table6-p100-r4-jsq-cache-faulted"

# Each channel alone: the others at values that never act (no window, a
# chain that never fails, no slowed server, a timeout no answer reaches).
NONE = {"outages": [], "mtbf_seconds": 1e30, "mttr_seconds": 1.0,
        "degraded": [], "broker_timeout_seconds": 1e9, "quorum_k": P}
WINDOWS = {"outages": [[0, 2.0, 30.0], [2, 10.0, 40.0], [5, 0.0, 8.0]]}
CHAIN = {"mtbf_seconds": 10.0, "mttr_seconds": 5.0}
SLOW = {"degraded": [[7, 1.5], [2, 1.2], [10, 1.1]]}
QUORUM = {"broker_timeout_seconds": 0.25, "quorum_k": P - 2}
CASES = {"windows": WINDOWS, "chain": CHAIN, "slow": SLOW, "quorum": QUORUM,
         "all": {**WINDOWS, **CHAIN, **SLOW, **QUORUM},
         "n_plus_1": {"outages": [[0, 0.0, 11000.0]], **CHAIN,
                      "degraded": [[7, 1.5]], "broker_timeout_seconds": 0.25,
                      "quorum_k": P - 1}}
ROWS = ("degraded_count", "spill_count", "unavail_count")


def _inputs(device="cpu"):
    rates, cols = table6.what_if_slab(SLAB, p=P, load_scale=4)
    return (torch.tensor(rates, dtype=torch.float32).to(device),
            {k: torch.tensor(v, dtype=torch.float32).to(device)
             for k, v in cols.items()})


def _port(seed, fault, device="cpu"):
    """The program's faulted path: its plain versions on the CPU, its
    kernels on the card."""
    from repro_torch.core import simulator
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.queueing import ServerParams
    lam, fields = _inputs(device)
    return simulator.simulate_fork_join_batch(
        seed, lam, ServerParams(p=P, **fields), N, p=P, mode="cache",
        chunk_size=CHUNK, impl="torch" if device == "cpu" else "auto",
        device=device, cluster=ClusterSpec(
            r=4, routing="jsq", result_cache=CACHE,
            fault=system.fault_spec(fault)))


def _reference(seed, fault, device="cpu", **precision):
    lam, fields = _inputs(device)
    return forkjoin.simulate(seed, lam, fields, p=P, n_queries=N,
                             chunk=CHUNK, warmup_fraction=0.1, hist_bins=256,
                             quantile=0.95, mode="cache", r=4, routing="jsq",
                             result_cache=CACHE, fault=fault, **precision)


def check_case(seed, case, device="cpu"):
    fault = {**NONE, **CASES[case]}
    res, ref = _port(seed, fault, device), _reference(seed, fault, device)
    torch.testing.assert_close(res.mean_response.double(), ref["mean"],
                               rtol=RTOL, atol=0.0)
    torch.testing.assert_close(res.quantile(0.95).double(), ref["quantile"],
                               rtol=RTOL, atol=0.0)
    assert torch.equal(res.count.long(), ref["count"])
    for row in ROWS:
        assert torch.equal(getattr(res, row).long(), ref[row]), row
    acting = {"windows": "spill_count", "chain": "spill_count",
              "quorum": "degraded_count", "n_plus_1": "unavail_count"}
    if case in acting:          # the channel's count reads something
        assert int(ref[acting[case]].sum()) > 0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [7, 2**41 + 5])
def test_reference_matches_faulted_path(seed, case):
    check_case(seed, case)


def test_slowed_server_moves_the_answer():
    plain = _reference(7, NONE)
    slow = _reference(7, {**NONE, **SLOW})
    assert bool((slow["mean"] > plain["mean"]).all())


def test_bfloat16_control_is_far_off():
    fault = {**NONE, **CASES["all"]}
    ref = _reference(5, fault)
    ctl = _reference(5, fault, dtype=torch.bfloat16,
                     route_dtype=torch.bfloat16)
    err = ((ctl["mean"].double() - ref["mean"]) / ref["mean"]).abs().max()
    assert float(err) > 1e-2


def test_quorum_join_by_hand():
    done = torch.tensor([[[1.0, 5.0], [2.0, 0.5], [9.0, 1.0]]])  # (1, 3, 2)
    fork = torch.tensor([[0.0, 0.0]])
    join, late = faulted.quorum_join(done, fork, k=2, timeout=3.0)
    # query 0: 9 > 3, the 2nd answer at 2, so the deadline 3; query 1: all
    # by 5 > 3, the 2nd at 1, so the deadline 3
    assert join.tolist() == [[3.0, 3.0]] and late.tolist() == [[True, True]]
    join, late = faulted.quorum_join(done, fork, k=2, timeout=10.0)
    assert join.tolist() == [[9.0, 5.0]] and not bool(late.any())
    join, late = faulted.quorum_join(done, fork, k=3, timeout=3.0)
    assert join.tolist() == [[9.0, 5.0]] and not bool(late.any())


def test_faulted_config_loads():
    cell = cells.load_cell(CELL)
    assert cell.fault == {"outages": [[0, 0.0, 11000.0]],
                          "mtbf_seconds": 2000.0, "mttr_seconds": 200.0,
                          "degraded": [[7, 1.5]],
                          "broker_timeout_seconds": 0.25, "quorum_k": 99}
    kw = system.run_kwargs(cell)
    assert kw["fault"] == cell.fault and (kw["r"], kw["routing"]) == (4, "jsq")
    spec = system.fault_spec(cell.fault)
    assert spec.outages == ((0, 0.0, 11000.0),) and spec.quorum(100) == 99
    assert spec.hedge_after_seconds is None
    # every key but the fault's is the unfaulted configuration's
    base = cells.load_cell("t6-r4-jsq-whatif")
    assert {k: v for k, v in kw.items() if k != "fault"} == \
        system.run_kwargs(base)


def _edit(root, change, *, fault=None):
    path = root / "configs" / f"{CONFIG}.json"
    data = json.loads(path.read_text())
    data.update(change)
    if fault is not None:
        data["fault"].update(fault)
    path.write_text(json.dumps(data))


@pytest.mark.parametrize("change,fault,match", [
    ({"hedge_after_seconds": 0.05}, None, "hedge_after_seconds"),
    ({"autoscale": {"min_r": 1, "max_r": 4}}, None, "autoscale"),
    ({}, {"hedge_after_seconds": 0.05}, "hedge_after_seconds"),
    ({}, {"hedge_attempts": 2}, "hedge_attempts"),
    ({}, {"spare": 1}, "spare"),
    ({}, {"quorum_k": 0}, "quorum_k"),
    ({}, {"quorum_k": 2.5}, "quorum_k"),
    ({}, {"outages": [[0, 5.0, 5.0]]}, "outages"),
    ({}, {"outages": [[0, 9.0, 5.0]]}, "outages"),
    ({}, {"outages": [[-1, 0.0, 5.0]]}, "outages"),
    ({}, {"outages": [[4, 0.0, 5.0]]}, "outages"),       # r = 4
    ({}, {"degraded": [[7, 0.0]]}, "degraded"),
    ({}, {"degraded": [[8, 1.5]]}, "degraded"),          # p = 8 here
    ({}, {"mtbf_seconds": 0}, "mtbf_seconds"),
    ({}, {"broker_timeout_seconds": None}, "broker_timeout_seconds"),
    ({"routing": "round_robin"}, None, "jsq"),
])
def test_bad_fault_is_refused(tiny_root, change, fault, match):
    _edit(tiny_root, change, fault=fault)
    with pytest.raises(ValueError, match=match):
        cells.load_cell(CELL, tiny_root)


def test_fault_lacking_a_key_is_refused(tiny_root):
    path = tiny_root / "configs" / f"{CONFIG}.json"
    data = json.loads(path.read_text())
    del data["fault"]["mttr_seconds"]
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError, match="mttr_seconds"):
        cells.load_cell(CELL, tiny_root)


def test_fault_on_a_grid_is_refused(tiny_root):
    path = tiny_root / "workloads" / "t6-r1-shard4.json"
    data = json.loads(path.read_text())
    data["config"] = CONFIG
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError, match="slab"):
        cells.load_cell("t6-r1-shard4", tiny_root)


@pytest.mark.parametrize("name", ["t6-r1-whatif", "t6-r4-jsq-whatif"])
def test_unfaulted_dispatch_is_as_before(tiny_root, name):
    """A configuration without ``fault``: the same keyword arguments as
    before faults were known, and the same three rows as the program's
    batch entry called as before, bit for bit."""
    from repro_torch.core import simulator
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.queueing import ServerParams
    cell = cells.load_cell(name, tiny_root)
    kw = system.run_kwargs(cell)
    assert sorted(kw) == ["chunk", "hist_bins", "mode", "n_queries", "p",
                          "quantile", "r", "result_cache", "routing",
                          "warmup_fraction"]
    inputs = system.make_inputs(cell, "cpu")
    got = system.make_dispatch(cell, inputs, "cpu")(2**33 + 1)
    res = simulator.simulate_fork_join_batch(
        2**33 + 1, inputs.lam, ServerParams(p=kw["p"], **inputs.fields),
        kw["n_queries"], p=kw["p"], mode=kw["mode"],
        warmup_fraction=kw["warmup_fraction"], chunk_size=kw["chunk"],
        hist_bins=kw["hist_bins"], device="cpu",
        cluster=ClusterSpec(r=kw["r"], routing=kw["routing"],
                            result_cache=kw["result_cache"]))
    want = torch.stack([res.mean_response, res.quantile(kw["quantile"]),
                        res.count]).double()
    assert got.shape == (3, inputs.n_scen) and torch.equal(got, want)


def test_faulted_dispatch_rows(tiny_root):
    cell = cells.load_cell(CELL, tiny_root)
    inputs = system.make_inputs(cell, "cpu")
    got = system.make_dispatch(cell, inputs, "cpu")(2**33 + 1)
    assert got.shape == (6, inputs.n_scen)
    assert bool((got[2] == got[2][0]).all())
    # nearly every query spills: replica 0, always down, is the fault-free
    # choice while it is idle (it takes work only when no replica is up)
    assert bool((got[4] + got[5] <= got[2]).all())
    assert bool((got[4] > 0.9 * got[2]).all())
    assert bool((got[3] > 0).any()) and bool((got[5] > 0).any())
