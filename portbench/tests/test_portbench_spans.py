"""The program's layer spans in a trace (`bench/layers.py`), on synthetic
profiler events: the benchmark's readers read the same with them, each
new reading's arithmetic, and a tiny traced window on the CPU."""

from __future__ import annotations

import dataclasses
import types

import pytest
import torch

from portbench import layers as layers_cli
from portbench.bench import cells
from portbench.bench import layers as ly
from portbench.bench import trace as tr

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}
SHAPE = dict(n_scen=4, p=8, r=4, chunk=256, itemsize=4, result_cache=True)
SIM = ly.SIM


def _ev(name, start, end, *, device=CPU, id=0, user=False):
    return types.SimpleNamespace(
        name=name, device_type=device, device_index=0, id=id,
        is_user_annotation=user,
        time_range=types.SimpleNamespace(start=float(start),
                                         end=float(end)))


class Trace:
    """Host events and the kernels they launch, in microseconds."""

    def __init__(self):
        self.host, self.device, self.copies, self.program = [], [], [], []
        self.n = 0

    def launch(self, at, kernel, start, end, aten="aten::mul"):
        self.n += 1
        self.host.append(_ev(aten, at, at + 2))
        self.host.append(_ev("cudaLaunchKernel", at, at + 1, id=self.n))
        self.device.append(_ev(kernel, start, end, device=CUDA, id=self.n))

    def span(self, name, start, end, *, bench=False):
        """A host span and, like a user annotation, its device copy."""
        ev = _ev(name, start, end)
        (self.host if bench else self.program).append(ev)
        self.copies.append(_ev(name, start + 1, end + 1, device=CUDA,
                               user=True))

    def events(self, program=True, copies=False):
        return (self.host + self.device + (self.program if program else [])
                + (self.copies if copies else []))


def synthetic() -> Trace:
    """One dispatch of two chunks: setup [0, 100), chunks [100, 500) and
    [500, 900).  Each kernel starts after its launch; the device idles
    from 80 to 150, across setup's end."""
    t = Trace()
    t.span(SIM + "dispatch", 0, 1000)
    t.span(SIM + "setup", 0, 100)
    t.launch(10, "elementwise_kernel", 20, 80)
    for c, b in enumerate((100, 500)):
        t.span(SIM + "chunk", b, b + 400)
        t.span(SIM + "draws", b, b + 100)
        t.span(tr.PREFIX + "sampling", b + 5, b + 95, bench=True)
        t.launch(b + 10, "philox_kernel", b + 50, b + 120)
        t.span(SIM + "compact", b + 100, b + 200)
        t.span(tr.PREFIX + "route", b + 105, b + 150, bench=True)
        t.launch(b + 110, "radixSort_kernel", b + 120, b + 150)
        t.launch(b + 160, "gather_kernel", b + 160, b + 170,
                 aten="aten::gather")
        t.span(SIM + "fcfs.broker", b + 200, b + 300)
        t.span(tr.PREFIX + "fcfs", b + 205, b + 295, bench=True)
        t.launch(b + 210, "maxplus_segment_scan_kernel", b + 210, b + 240)
        t.span(SIM + "route", b + 300, b + 320)
        t.span(tr.PREFIX + "jsq", b + 301, b + 319, bench=True)
        t.launch(b + 305, "jsq_route_kernel", b + 305, b + 365)
        t.span(SIM + "stats", b + 320, b + 390)
        t.launch(b + 330, "reduce_kernel", b + 365, b + 375)
        if c == 1:      # launched in the chunk, under no leaf
            t.launch(b + 395, "stray_kernel", b + 400, b + 402)
    return t


def _readers(view):
    return {name: cells.load_metric(name).read(view)
            for name in cells.names("metrics")}


def _trace_view(events):
    return tr.view_from_events(events, window_s=1e-3, dispatches=1,
                               chunks=2, shape=SHAPE, peaks=PEAKS)


def test_existing_readers_read_the_same_with_program_spans():
    t = synthetic()
    base = _trace_view(t.events(program=False))
    spanned = _trace_view(t.events(program=True))
    # the program's spans give each operation its layer, and nothing else
    assert {op.layer for op in base.ops} == {None}
    assert {op.layer for op in spanned.ops} >= {"draws", "route", "stats"}
    assert base == dataclasses.replace(spanned, ops=tuple(
        dataclasses.replace(op, layer=None) for op in spanned.ops))
    got = _readers(spanned)
    assert got == _readers(base)
    # every reader reads, but the lag between cards (on this one card), the
    # fleet layer's (no fault here) and the join's (no join span here)
    for name in ("shard_start_lag_ms", "fleet_ms_per_chunk",
                 "join_ms_per_chunk"):
        assert got.pop(name) is None, name
    assert all(v is not None for v in got.values()), got
    assert got["launches_per_chunk"] == 14 / 2


MASKED = "void (anonymous namespace)::jsq_reg_kernel<float, 4, 4, true>(...)"
UNMASKED = MASKED.replace("true", "false")


def faulted_trace(*, fleet=True, join=True, router=MASKED) -> Trace:
    """Two chunks of a faulted cell's loop: the fleet scan under the
    program's ``fleet`` span, the router, and the join's ``amax`` and
    ``kthvalue`` under the program's ``join`` span."""
    t = Trace()
    for b in (0, 400):
        t.span(SIM + "chunk", b, b + 400)
        if fleet:
            t.span(SIM + "fleet", b, b + 50)
        t.launch(b + 10, "fleet_scan_kernel<float>", b + 20, b + 32)
        t.span(SIM + "route", b + 50, b + 150)
        t.span(tr.PREFIX + "jsq", b + 55, b + 145, bench=True)
        t.launch(b + 60, router, b + 60, b + 70)
        if join:
            t.span(SIM + "join", b + 200, b + 300)
        t.launch(b + 210, "reduce_kernel", b + 210, b + 214,
                 aten="aten::amax")
        t.launch(b + 220, "sort_kernel", b + 220, b + 250,
                 aten="aten::kthvalue")
        t.span(SIM + "stats", b + 300, b + 390)
        t.launch(b + 310, "reduce_kernel", b + 310, b + 315)
    return t


def test_fault_readers_read_their_layers():
    got = _readers(_trace_view(faulted_trace().events()))
    # microseconds over two chunks -> ms a chunk
    assert got["fleet_ms_per_chunk"] == pytest.approx(12e-3)
    assert got["join_ms_per_chunk"] == pytest.approx(34e-3)
    assert got["jsq_route_roofline"] is not None


# The router's count by hand at SHAPE (S 4, p 8, r 4, n 256, float32):
# bytes (4 8 256 + 2 4 256 + 2 4 4 8) 4 + 4 256 8 (choices) = 50,176, and
# a MASKED launch's 4 256 (4 (active count) + 4 (one word of up bits) + 2
# (flags)) = 10,240 more; operations 4 256 (3 4 8 + 4 + 2 8) = 118,784,
# and masked 4 256 (2 4 + 2) = 10,240 more.  Bytes bound both.
@pytest.mark.parametrize("router,n_bytes,n_ops", [
    (UNMASKED, 50_176, 118_784),
    (MASKED, 60_416, 129_024),
])
def test_router_roofline_counts_each_instance(router, n_bytes, n_ops):
    mod = cells.load_metric("jsq_route_roofline")
    masked = router == MASKED
    count_b = mod.masked_bytes_per_launch if masked else mod.bytes_per_launch
    count_o = mod.masked_ops_per_launch if masked else mod.ops_per_launch
    assert (count_b(SHAPE), count_o(SHAPE)) == (n_bytes, n_ops)
    view = _trace_view(faulted_trace(router=router).events())
    got = mod.read(view)
    # two 10 us launches
    assert got == pytest.approx(100.0 * 2 * (n_bytes / 3.35e12) / 20e-6)
    if not masked:      # digit for digit the reading before masks counted
        ks = [op for op in view.kernels() if mod.PATTERN.search(op.name)]
        least = max(n_bytes / PEAKS["hbm_bytes_per_s"],
                    n_ops / PEAKS["fp32_flops_per_s"])
        assert got == 100.0 * len(ks) * least / sum(op.seconds for op in ks)


@pytest.mark.parametrize("absent,reader", [
    ({"fleet": False}, "fleet_ms_per_chunk"),
    ({"join": False}, "join_ms_per_chunk"),
])
def test_fault_reader_is_none_without_its_layer(absent, reader):
    t = faulted_trace(**absent)
    got = _readers(_trace_view(t.events()))
    assert got[reader] is None
    # no program span at all: neither reads anything
    bare = _readers(_trace_view(t.events(program=False)))
    assert bare["join_ms_per_chunk"] is None
    assert bare["fleet_ms_per_chunk"] is None


def test_layer_view_drops_every_span_copy():
    t = synthetic()
    plain = ly.view_from_events(t.events(), dispatches=1, chunks=2)
    copied = ly.view_from_events(t.events(copies=True), dispatches=1,
                                 chunks=2)
    assert copied == plain
    assert len(plain.ops) == 14
    assert not any(op.name.startswith(("repro_torch.", "portbench."))
                   for op in plain.ops)


def test_layers_of_the_operations():
    v = ly.view_from_events(synthetic().events(), dispatches=1, chunks=2)
    by = {op.name: op.layer for op in v.ops}
    assert by == {"elementwise_kernel": "setup", "philox_kernel": "draws",
                  "radixSort_kernel": "compact", "gather_kernel": "compact",
                  "maxplus_segment_scan_kernel": "fcfs.broker",
                  "jsq_route_kernel": "route", "reduce_kernel": "stats",
                  "stray_kernel": "chunk"}


def test_readings_arithmetic():
    v = ly.view_from_events(synthetic().events(), dispatches=1, chunks=2)
    read = {k: fn(v) for k, (_, fn) in ly.READERS.items()}
    # microseconds over two chunks -> ms a chunk
    assert read["span_draws_ms_per_chunk"] == pytest.approx(70e-3)
    assert read["span_compact_ms_per_chunk"] == pytest.approx(40e-3)
    assert read["span_fcfs_ms_per_chunk"] == pytest.approx(30e-3)
    assert read["span_join_stats_ms_per_chunk"] == pytest.approx(10e-3)
    assert read["host_ms_per_chunk"] == pytest.approx(400e-3)
    assert v.idle_intervals() == [
        (80.0, 150.0), (250.0, 260.0), (270.0, 310.0), (340.0, 405.0),
        (475.0, 550.0), (650.0, 660.0), (670.0, 710.0), (740.0, 805.0),
        (875.0, 900.0)]
    # 20 us of the first gap under setup, its other 50 in the first
    # chunk; the gap across the chunks' boundary counts in both
    assert read["idle_setup_ms_per_dispatch"] == pytest.approx(20e-3)
    assert read["idle_loop_ms_per_dispatch"] == pytest.approx(380e-3)
    assert 1e3 * v.idle_s() == pytest.approx(400e-3)
    assert v.coverage() == pytest.approx(420 / 422)
    assert v.launch_first_share() == 1.0


def test_launch_after_its_kernel_counts_against_the_clock():
    t = synthetic()
    t.launch(950, "late_kernel", 940, 945)
    v = ly.view_from_events(t.events(), dispatches=1, chunks=2)
    assert v.launch_first_share() == pytest.approx(14 / 15)


def test_readings_are_none_without_their_spans():
    t = synthetic()
    parent = ly.view_from_events(t.events(program=False), dispatches=1,
                                 chunks=2)
    assert all(fn(parent) is None for _, fn in ly.READERS.values())
    no_compact = ly.view_from_events(
        [e for e in t.events() if e.name != SIM + "compact"],
        dispatches=1, chunks=2)
    assert ly.span_compact_ms_per_chunk(no_compact) is None
    assert ly.span_draws_ms_per_chunk(no_compact) is not None
    host_only = ly.view_from_events(t.host + t.program, dispatches=1,
                                    chunks=2)
    assert ly.idle_loop_ms_per_dispatch(host_only) is None
    assert ly.host_ms_per_chunk(host_only) == pytest.approx(400e-3)


def test_idle_overlap_of_interval_lists():
    a = [(0.0, 10.0), (20.0, 30.0), (40.0, 50.0)]
    b = [(5.0, 25.0), (45.0, 60.0)]
    assert ly._overlap_us(a, b) == 5 + 5 + 5
    assert ly._overlap_us(a, []) == 0.0


def test_traced_window_on_the_cpu(tiny_root, monkeypatch):
    from portbench import run
    monkeypatch.setattr(run, "TRACE_DISPATCHES", 2)
    cell = cells.load_cell("t6-r4-jsq-whatif", tiny_root)
    plain = tr.view_from_events
    rec = layers_cli.read_window(cell, seed=2**31 + 3, device="cpu")
    assert tr.view_from_events is plain
    assert rec["correct"] is True
    assert rec["dispatches"] == 2 and rec["chunks"] == 2 * cell.n_chunks
    # the CPU runs no device operation: only the host reading reads
    assert set(rec["metrics"]) == {"host_ms_per_chunk"}
    assert rec["metrics"]["host_ms_per_chunk"] > 0
    assert rec["leaf_coverage"] is None
    per_chunk = 1 + 16              # a chunk span and its leaves
    assert rec["spans_per_dispatch"] == 2 + per_chunk * cell.n_chunks
    assert set(rec["host_ms_per_chunk"]) >= {"setup", "chunk", "draws",
                                             "compact", "route"}


def test_span_cost_reads():
    cost = layers_cli.span_cost_us(n_off=2000, n_on=200)
    assert set(cost) == {"loop_us", "layer_span_off_us", "open_off_us",
                         "layer_span_on_us", "open_on_us",
                         "record_function_on_us"}
    assert all(v > 0 for v in cost.values())
