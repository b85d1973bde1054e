"""The program's own layer spans in a traced window, and seven readings
of them.

The program opens ``repro_torch.sim.*`` spans under any profiler
(`repro_torch.obs.profile.layer_span`): a ``dispatch`` span a batch
call, a ``setup`` span up to its first chunk, a ``chunk`` span a chunk
and leaf spans inside it (``draws``, ``arrivals``, ``route``,
``compact``, ``fcfs.cache`` / ``fcfs.broker`` / ``fcfs.servers``,
``join``, ``stats``, ...).  This view keeps those host spans, ties each
device operation to the innermost one around its launch by correlation
id (as `bench/trace.py` ties it to the benchmark's own spans), and
drops every span's device-side copy, so no span counts as a kernel or
as busy time.  It is built from the same profiler events as
`trace.view_from_events`, which it leaves as it is.

``READERS`` maps each reading to ``(unit, read(view) -> float | None)``,
the form of a reader in ``metrics/``.  On a program that opens no span
every reading is None.  ``portbench/layers.py`` runs a cell's traced
window and prints them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from portbench.bench.trace import PREFIX as BENCH_PREFIX
from portbench.bench.trace import _Intervals, _kind

PREFIX = "repro_torch."                 # the program's spans
SIM = PREFIX + "sim."                   # the simulator's layers


@dataclasses.dataclass(frozen=True)
class LayerOp:
    name: str
    start_us: float
    end_us: float
    kind: str                   # "kernel", "memcpy" or "memset"
    layer: Optional[str]        # innermost program span around its launch
    launch_us: Optional[float]  # host start of the launch

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) * 1e-6


@dataclasses.dataclass(frozen=True)
class LayerView:
    """The window's device operations, each with its layer (the span's
    name after ``repro_torch.sim.``), and the program's host spans as
    (layer, start_us, end_us)."""

    ops: tuple
    spans: tuple
    dispatches: int
    chunks: int

    def seen(self, *layers: str) -> bool:
        """Whether the host opened a span of any of the named layers; a
        name ending in ``.`` takes every layer it begins (``"fcfs."``)."""
        return any(_matches(s[0], layers) for s in self.spans)

    def layer_s(self, *layers: str) -> float:
        """Device seconds launched under the named layers (as ``seen``
        names them)."""
        return sum(op.seconds for op in self.ops
                   if _matches(op.layer, layers))

    def host_intervals(self, layer: str) -> list:
        """(start_us, end_us) of every host span of one layer, in order."""
        return sorted((s, e) for name, s, e in self.spans if name == layer)

    def idle_intervals(self) -> list:
        """(start_us, end_us) of every gap between device operations (the
        gaps `TraceView.idle_gaps` walks)."""
        gaps, end = [], None
        for op in sorted(self.ops, key=lambda o: o.start_us):
            if end is not None and op.start_us > end:
                gaps.append((end, op.start_us))
            end = op.end_us if end is None else max(end, op.end_us)
        return gaps

    def idle_s(self) -> float:
        return sum(e - s for s, e in self.idle_intervals()) * 1e-6

    def idle_under_s(self, layer: str) -> float:
        """Seconds of device idle time while the host was inside a span of
        ``layer`` (spans of one layer never overlap each other)."""
        return _overlap_us(self.idle_intervals(),
                           self.host_intervals(layer)) * 1e-6

    def coverage(self) -> Optional[float]:
        """Share of the device time launched inside chunk spans that a
        leaf span owns (None where no chunk span holds any)."""
        leaf = sum(op.seconds for op in self.ops if op.layer not in
                   (None, "chunk", "setup", "dispatch"))
        bare = sum(op.seconds for op in self.ops if op.layer == "chunk")
        return leaf / (leaf + bare) if leaf + bare > 0 else None

    def launch_first_share(self) -> Optional[float]:
        """Share of the kernels whose host launch starts no later than the
        kernel on the device: the two clocks agree where it is 1."""
        ks = [op for op in self.ops
              if op.kind == "kernel" and op.launch_us is not None]
        if not ks:
            return None
        return sum(op.launch_us <= op.start_us for op in ks) / len(ks)


def _matches(layer: Optional[str], names) -> bool:
    return layer is not None and any(
        layer.startswith(n) if n.endswith(".") else layer == n
        for n in names)


def _overlap_us(a: list, b: list) -> float:
    """Total overlap of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _is_span_copy(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or \
        e.name.startswith((PREFIX, BENCH_PREFIX))


def view_from_events(events, *, dispatches: int, chunks: int) -> LayerView:
    """Build the view from ``torch.profiler`` function events."""
    cuda = torch.autograd.DeviceType.CUDA
    launches, spans, device = {}, [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not _is_span_copy(e):
                device.append(e)
        elif e.name.startswith(SIM):
            spans.append((e.name[len(SIM):], start, end))
        elif e.name.startswith("cuda"):
            launches[e.id] = start
    span_at = _Intervals(spans)
    ops = []
    for e in device:
        t = launches.get(e.id)
        ops.append(LayerOp(
            name=e.name, start_us=e.time_range.start,
            end_us=e.time_range.end, kind=_kind(e.name),
            layer=None if t is None else span_at.at(t), launch_us=t))
    spans.sort(key=lambda s: s[1])
    return LayerView(ops=tuple(ops), spans=tuple(spans),
                     dispatches=dispatches, chunks=chunks)


# -- the readings -----------------------------------------------------------

def _ms_per_chunk(view: LayerView, *layers: str) -> Optional[float]:
    if not view.seen(*layers):
        return None
    t = view.layer_s(*layers)
    return 1e3 * t / view.chunks if t > 0 and view.chunks else None


def span_draws_ms_per_chunk(view):
    """Device time launched under ``draws`` a chunk: the inside twin of
    ``sampling_ms_per_chunk``."""
    return _ms_per_chunk(view, "draws")


def span_compact_ms_per_chunk(view):
    """Device time under ``compact`` a chunk (the inside twin of
    ``compact_ms_per_chunk``); None where nothing is compacted."""
    return _ms_per_chunk(view, "compact")


def span_fcfs_ms_per_chunk(view):
    """Device time under every ``fcfs.*`` level a chunk: each level's
    ``arrivals + services`` add, its head seeding and its scan."""
    return _ms_per_chunk(view, "fcfs.")


def span_join_stats_ms_per_chunk(view):
    """Device time under ``join`` and ``stats`` a chunk."""
    return _ms_per_chunk(view, "join", "stats")


def host_ms_per_chunk(view):
    """Mean host duration of a ``chunk`` span, in ms."""
    iv = view.host_intervals("chunk")
    return 1e-3 * sum(e - s for s, e in iv) / len(iv) if iv else None


def idle_setup_ms_per_dispatch(view):
    """Device idle time while the host is inside ``setup``, a dispatch."""
    if not view.seen("setup") or not view.ops or not view.dispatches:
        return None
    return 1e3 * view.idle_under_s("setup") / view.dispatches


def idle_loop_ms_per_dispatch(view):
    """Device idle time while the host is inside a ``chunk``, a
    dispatch."""
    if not view.seen("chunk") or not view.ops or not view.dispatches:
        return None
    return 1e3 * view.idle_under_s("chunk") / view.dispatches


READERS = {
    "span_draws_ms_per_chunk": ("ms/chunk", span_draws_ms_per_chunk),
    "span_compact_ms_per_chunk": ("ms/chunk", span_compact_ms_per_chunk),
    "span_fcfs_ms_per_chunk": ("ms/chunk", span_fcfs_ms_per_chunk),
    "span_join_stats_ms_per_chunk": ("ms/chunk",
                                     span_join_stats_ms_per_chunk),
    "host_ms_per_chunk": ("ms/chunk", host_ms_per_chunk),
    "idle_setup_ms_per_dispatch": ("ms/dispatch",
                                   idle_setup_ms_per_dispatch),
    "idle_loop_ms_per_dispatch": ("ms/dispatch", idle_loop_ms_per_dispatch),
}
