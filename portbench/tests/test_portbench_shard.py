"""A grid cell: its traffic file, the program's sharded sweep against the
reference shard by shard, the faults of a shard plan that the check has
to catch, and the readers' per-card meaning on synthetic traces."""

from __future__ import annotations

import dataclasses
import json
import types

import pytest
import torch

from portbench import layers as layers_cli
from portbench import run
from portbench.bench import cells, check, system
from portbench.bench import trace as tr
from portbench.reference import rng_plan
from portbench.tests.conftest import shrink

CELL = "t6-r1-shard4"
GRID = "table6-grid-1024"


def _set_grid(root, **grid):
    path = root / "traffic" / f"{GRID}.json"
    data = json.loads(path.read_text())
    data["grid"].update(grid)
    path.write_text(json.dumps(data))


def test_grid_traffic_loads(tiny_root):
    cell = cells.load_cell(CELL, tiny_root)
    assert cell.chips == 4
    rates, cols = system.table6.what_if_grid(cell.grid, p=8)
    assert len(rates) == 8 and rates[:4] == [2.0] * 4
    full = cells.load_cell(CELL)
    assert system.make_inputs(full, "cpu").n_scen == 1024


@pytest.mark.parametrize("change,match", [
    ({"slab": {"memory": [1], "cpu": [1], "disk": [1], "rho": [0.5]}},
     "slab or a grid"),
    ({"grid": {"memory": 5, "lam": [1.0], "cpu": [1.0], "disk": [1.0]}},
     "memory"),
    ({"grid": {"memory": 1, "lam": [1.0], "cpu": [1.0]}}, "disk"),
    ({"grid": {"memory": 1, "lam": [1.0], "cpu": [1.0], "disk": [1.0],
               "hit": [0.5]}}, "hit"),
])
def test_bad_grid_is_refused(tiny_root, change, match):
    path = tiny_root / "traffic" / f"{GRID}.json"
    data = json.loads(path.read_text())
    data.update(change)
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError, match=match):
        cells.load_cell(CELL, tiny_root)


def test_slab_on_four_cards_is_refused(tiny_root):
    path = tiny_root / "workloads" / "t6-r1-whatif.json"
    data = json.loads(path.read_text())
    data["chips"] = 4
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError, match="one card"):
        cells.load_cell("t6-r1-whatif", tiny_root)


def test_shard_plan():
    assert rng_plan.shard_rows(8, 4) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert rng_plan.shard_rows(6, 4) == [[0, 1], [2, 3], [4, 5], [5, 5]]
    from repro_torch.core import simulator
    seed = 2**40 + 7
    assert rng_plan.shard_seeds(seed, 3) == [
        simulator._mix(simulator._mix(seed, 0), d) for d in range(3)]


@pytest.mark.parametrize("lam", [[2.0, 8.5], [2.0, 5.0, 8.5]],
                         ids=["8_scenarios", "12_scenarios"])
@pytest.mark.parametrize("cards", [4, 5], ids=["4_cards", "5_cards"])
def test_reference_matches_gathered_sweep(tiny_root, lam, cards):
    """8 or 12 scenarios, p = 4, 2 chunks of 64, on a mesh of four (or
    five: edge padding) repeated CPU devices."""
    shrink(tiny_root, p=4, queries=128, chunk=64)
    _set_grid(tiny_root, lam=lam)
    cell = cells.load_cell(CELL, tiny_root)
    cell = dataclasses.replace(cell, workload={**cell.workload,
                                               "chips": cards})
    inputs = system.make_inputs(cell, "cpu")
    dispatch = system.make_dispatch(cell, inputs, "cpu")
    seed = system.dispatch_seed(2**33 + 5, 0)
    got = dispatch(seed)
    want = check.reference(cell, inputs, seed)
    assert got.shape == want.shape == (3, inputs.n_scen)
    err = check.errors(cell, got, want)
    assert err["count_diff"] == 0
    # float32 program against the float64 reference (as the plain path's
    # test holds them)
    assert err["mean_rel_err"] < 1e-5 and err["p95_rel_err"] < 1e-5


def _shard_fault(monkeypatch, seed_of=None, order=None):
    """Plant a fault in the sweep's shard plan: shard d run from
    ``seed_of(dispatch seed, d)``, or the shards' rows gathered in
    ``order``."""
    from repro_torch.core import sweep
    plain = sweep._sharded_batch

    def faulty(run_fn, mesh, seed, *args):
        shard = iter(range(mesh.size))

        def run_d(s, *a, **kw):
            d = next(shard)
            return run_fn(s if seed_of is None else seed_of(seed, d), *a, **kw)

        res = plain(run_d, mesh, seed, *args)
        if order is not None:
            res = res.map(lambda x: x.reshape(
                (mesh.size, x.shape[0] // mesh.size) + x.shape[1:])
                [order].reshape(x.shape))
        return res

    monkeypatch.setattr(sweep, "_sharded_batch", faulty)


def _mix(*words):
    from repro_torch.core import simulator
    return simulator._mix(*words)


FAULTS = {
    "seeds_swapped": dict(seed_of=lambda s, d: _mix(s, (1, 0, 2, 3)[d])),
    "gathered_out_of_order": dict(order=[1, 0, 2, 3]),
    "gather_left_out": dict(order=[0, 0, 0, 0]),    # card 0's rows only
    "unsharded_seed": dict(seed_of=lambda s, d: s),
}


def _run(root, seed=2**32 + 41):
    return run.run_cell(cells.load_cell(CELL, root), seed=seed, seconds=0.1,
                        trace=False, device="cpu", setup_clock=lambda: 1.0,
                        root=root)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_shard_fault_is_not_correct(tiny_root, monkeypatch, fault):
    assert _run(tiny_root)["correct"] is True
    _shard_fault(monkeypatch, **FAULTS[fault])
    line = _run(tiny_root)
    assert line["correct"] is False
    assert line["checks"]["mean_rel_err"]["value"] > \
        line["checks"]["mean_rel_err"]["limit"]


# -- the readers on synthetic views -------------------------------------------

PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}
SHAPE = dict(n_scen=4, p=8, r=1, chunk=256, itemsize=4, result_cache=False)


def _op(start, end, device=0, dispatch=None, name="maxplus_scan_kernel"):
    return tr.DeviceOp(name=name, start_us=float(start), end_us=float(end),
                       kind="kernel", span=None, aten=None, device=device,
                       dispatch=dispatch)


def _view(ops, cards, chunks=2, window_us=1000.0):
    return tr.TraceView(ops=tuple(ops), window_s=window_us * 1e-6,
                        dispatches=2, chunks=chunks, shape=SHAPE, peaks=PEAKS,
                        spans_seen=frozenset(), cards=cards)


def _read(name, view):
    return cells.load_metric(name).read(view)


def test_one_card_readings_are_as_before():
    """On one card: busy is the union of every operation (whatever card
    index the trace gives it), idle and launches a chunk as before."""
    ops = [_op(0, 100), _op(50, 200, device=3), _op(400, 500)]
    v = _view(ops, cards=1)
    assert v.busy_s() == pytest.approx(300e-6)
    assert _read("device_idle_pct", v) == pytest.approx(70.0)
    assert _read("launches_per_chunk", v) == 3 / 2
    assert [round(s * 1e6) for _, s in v.idle_gaps()] == [200]


def test_idle_is_each_cards_own():
    """Two cards, one busy 300 us and one 100 us of a 1,000 us window:
    70 % and 90 % idle, 80 % the cell's; a card's gaps are its own."""
    ops = [_op(0, 200), _op(100, 300), _op(250, 350, device=1)]
    v = _view(ops, cards=2)
    assert v.busy_s() == pytest.approx(200e-6)
    assert _read("device_idle_pct", v) == pytest.approx(80.0)
    assert v.idle_gaps() == []
    v2 = _view(ops + [_op(600, 700, device=1)], cards=2)
    assert [(n.split()[0], round(s * 1e6)) for n, s in v2.idle_gaps()] == [
        ("cuda:1", 250)]


def test_shard_start_lag_reads_a_known_lag():
    """Dispatch 0: card 0 starts at 10 us, card 1 at 1,010; dispatch 1:
    at 2,000 and 5,000: (1,000 + 3,000) / 2 us = 2 ms."""
    ops = [_op(10, 20, 0, 0), _op(30, 900, 0, 0), _op(1010, 1100, 1, 0),
           _op(1500, 1600, 1, 0),
           _op(2000, 2100, 0, 1), _op(5000, 5100, 1, 1),
           _op(9000, 9100, 1, None)]
    v = _view(ops, cards=2)
    assert _read("shard_start_lag_ms", v) == pytest.approx(2.0)
    assert _read("shard_start_lag_ms", _view(ops[:2], cards=2)) is None


def _ev(name, start, end, *, device=False, id=0, index=0):
    return types.SimpleNamespace(
        name=name, id=id, device_index=index,
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU),
        time_range=types.SimpleNamespace(start=float(start), end=float(end)))


def test_view_ties_operations_to_card_and_dispatch():
    events = [_ev(tr.DISPATCH, 0, 100), _ev(tr.DISPATCH, 200, 300),
              _ev(tr.DISPATCH, 10, 20, device=True),    # the span's copy
              _ev("cudaLaunchKernel", 5, 6, id=1),
              _ev("cudaLaunchKernel", 50, 51, id=2),
              _ev("cudaLaunchKernel", 210, 211, id=3),
              _ev("cudaLaunchKernel", 150, 151, id=4),
              _ev("k", 10, 20, device=True, id=1, index=0),
              _ev("k", 60, 70, device=True, id=2, index=2),
              _ev("k", 220, 230, device=True, id=3, index=1),
              _ev("k", 160, 170, device=True, id=4, index=1)]
    v = tr.view_from_events(events, window_s=1e-3, dispatches=2, chunks=2,
                            shape=SHAPE, peaks=PEAKS, cards=3)
    assert [(op.device, op.dispatch) for op in v.ops] == [
        (0, 0), (2, 0), (1, 1), (1, None)]
    assert _read("shard_start_lag_ms", v) == pytest.approx(50e-3)


@pytest.mark.parametrize("name", ["t6-r1-whatif", CELL])
def test_traced_window_counts_every_shards_chunks(tiny_root, monkeypatch,
                                                  name):
    monkeypatch.setattr(run, "TRACE_DISPATCHES", 2)
    cell = cells.load_cell(name, tiny_root)
    rec = layers_cli.read_window(cell, seed=2**31 + 9, device="cpu")
    assert rec["correct"] is True
    assert rec["chunks"] == 2 * cell.n_chunks * cell.chips
