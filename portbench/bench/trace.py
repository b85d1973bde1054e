"""The traced run: spans around the program's layers, the profiler's
device timeline, and the view of it that the per-layer readers take.

Spans come from the benchmark's side: while the traced window runs, the
program's layer functions are wrapped in ``torch.profiler``
``record_function`` scopes (their module attributes, restored after).
Each device operation is tied to the host call that launched it by the
profiler's correlation id, and so to the innermost span and ``aten::``
operator around that launch, and to the dispatch (a ``DISPATCH`` span
the traced loop opens around each) it belongs to.  It is tied the same
way to the innermost of the program's own layer spans
(``repro_torch.sim.*``, `repro_torch.obs.profile`), for the layers the
benchmark cannot wrap from outside.  Busy and idle time are each card's
own; a cell's is the mean over its cards.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import time
from typing import Callable, Optional

import torch

PREFIX = "portbench."
DISPATCH = PREFIX + "dispatch"          # one traced dispatch, host side
LAYER_PREFIX = "repro_torch.sim."       # the program's own layer spans
# span -> the program functions it wraps (module, attribute)
SPANS = {
    PREFIX + "sampling": (("repro_torch.core.simulator", "chunk_random_draws"),
                          ("repro_torch.core.simulator", "chunk_side_draws")),
    PREFIX + "route": (("repro_torch.core.simulator", "_compact"),
                       ("repro_torch.core.simulator", "_routing_assign")),
    PREFIX + "jsq": (("repro_torch.kernels.jsq_route.ops", "jsq_route"),),
    PREFIX + "fcfs": (("repro_torch.core.simulator", "fcfs_completion_times"),
                      ("repro_torch.core.simulator", "_fcfs_segmented")),
}


@contextlib.contextmanager
def layer_spans():
    """Wrap the program's layer functions in named profiler scopes.

    A target the program no longer has (renamed, fused or inlined) is
    skipped: its span is then never seen, and the readers of that span
    return nothing while the others still read."""
    saved = []

    def wrap(name, fn):
        def spanned(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return spanned

    try:
        for name, targets in SPANS.items():
            for mod_name, attr in targets:
                try:
                    mod = importlib.import_module(mod_name)
                except ImportError:
                    continue
                fn = getattr(mod, attr, None)
                if not callable(fn):
                    continue
                saved.append((mod, attr, fn))
                setattr(mod, attr, wrap(name, fn))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start_us: float
    end_us: float
    kind: str                 # "kernel", "memcpy" or "memset"
    span: Optional[str]       # innermost layer span around its launch
    aten: Optional[str]       # innermost aten operator around its launch
    device: int = 0           # the card it ran on
    dispatch: Optional[int] = None  # the traced dispatch that launched it
    layer: Optional[str] = None  # innermost program span (after its prefix)

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) * 1e-6


@dataclasses.dataclass(frozen=True)
class TraceView:
    """What a per-layer reader reads: the traced window's device
    operations, its length, the work it held and the cell's shapes.
    ``chunks`` counts every shard's chunks and ``shape`` is one card's,
    so that a reader's "a chunk" is a card's chunk on any number of
    cards."""

    ops: tuple
    window_s: float
    dispatches: int
    chunks: int
    shape: dict
    peaks: Optional[dict]
    spans_seen: frozenset
    cards: int = 1

    def kernels(self) -> list:
        return [op for op in self.ops if op.kind == "kernel"]

    def by_card(self) -> dict:
        """{card: its operations in order of start}; on one card every
        operation is the card's."""
        out: dict = {}
        for op in sorted(self.ops, key=lambda o: o.start_us):
            out.setdefault(op.device if self.cards > 1 else 0, []).append(op)
        return out

    def busy_s(self) -> float:
        """Seconds in which some operation ran on a card, the mean over
        the cell's cards."""
        busy = 0.0
        for ops in self.by_card().values():
            end = -float("inf")
            for op in ops:
                if op.end_us <= end:
                    continue
                busy += op.end_us - max(op.start_us, end)
                end = op.end_us
        return busy * 1e-6 / self.cards

    def idle_gaps(self) -> list:
        """(name, seconds) of every gap between one card's operations,
        named by the host call that launched the operation after it (and,
        on several cards, by the card)."""
        gaps = []
        for card, ops in self.by_card().items():
            tag = f"cuda:{card} " if self.cards > 1 else ""
            end = None
            for op in ops:
                if end is not None and op.start_us > end:
                    where = " ".join(x for x in (op.span, op.aten) if x)
                    gaps.append((f"{tag}before {where or op.name[:60]}",
                                 (op.start_us - end) * 1e-6))
                end = op.end_us if end is None else max(end, op.end_us)
        return gaps


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


class _Intervals:
    """Innermost enclosing interval of a time point, among nested ones."""

    def __init__(self, items):
        self.items = sorted(items, key=lambda it: it[1])
        self.starts = [it[1] for it in self.items]

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            name, start, end = self.items[i]
            if end >= t:
                return name
            i -= 1
        return None


def view_from_events(events, *, window_s: float, dispatches: int,
                     chunks: int, shape: dict, peaks,
                     cards: int = 1) -> TraceView:
    """Build the reader's view from ``torch.profiler`` function events."""
    cuda = torch.autograd.DeviceType.CUDA
    launches, spans, atens, layers, device, marks = {}, [], [], [], [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not e.name.startswith(PREFIX):   # not a span's device copy
                device.append(e)
        elif e.name == DISPATCH:
            marks.append((start, end))
        elif e.name.startswith(PREFIX):
            if e.name in SPANS:
                spans.append((e.name, start, end))
        elif e.name.startswith("aten::"):
            atens.append((e.name, start, end))
        elif e.name.startswith(LAYER_PREFIX):
            layers.append((e.name[len(LAYER_PREFIX):], start, end))
        elif e.name.startswith("cuda"):
            launches[e.id] = start
    span_at, aten_at = _Intervals(spans), _Intervals(atens)
    layer_at = _Intervals(layers)
    dispatch_at = _Intervals([(i, s, e) for i, (s, e) in
                              enumerate(sorted(marks))])
    ops = []
    for e in device:
        t = launches.get(e.id)
        ops.append(DeviceOp(
            name=e.name, start_us=e.time_range.start,
            end_us=e.time_range.end, kind=_kind(e.name),
            span=None if t is None else span_at.at(t),
            aten=None if t is None else aten_at.at(t),
            device=e.device_index,
            dispatch=None if t is None else dispatch_at.at(t),
            layer=None if t is None else layer_at.at(t)))
    return TraceView(ops=tuple(ops), window_s=window_s, dispatches=dispatches,
                     chunks=chunks, shape=shape, peaks=peaks,
                     spans_seen=frozenset(s[0] for s in spans), cards=cards)


def dispatch_span(dispatch: Callable) -> Callable:
    """``dispatch`` inside a ``DISPATCH`` span, for the traced loop."""
    def spanned(*args, **kwargs):
        with torch.profiler.record_function(DISPATCH):
            return dispatch(*args, **kwargs)
    return spanned


def traced(run: Callable[[], object], **view_kw) -> tuple[object, TraceView]:
    """Run ``run()`` (which ends in a host sync) under the profiler with
    the layer spans on; returns its result and the view."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with layer_spans(), profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = run()
        window_s = time.perf_counter() - t0
    return out, view_from_events(prof.events(), window_s=window_s,
                                 **view_kw)


def breakdown(view: TraceView, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each as [[name, seconds], ...]."""
    by_name: dict = {}
    for op in view.ops:
        key = op.name[:160]
        by_name[key] = by_name.get(key, 0.0) + op.seconds
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(view.idle_gaps(), key=lambda g: -g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
