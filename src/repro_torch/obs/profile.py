"""Profiling hooks: the simulator's layer spans; first-call time, steady
time, flops and bytes, peak device memory.

**Layer spans.**  The streaming simulator opens named spans around its
own layers, so any ``torch.profiler.profile(...)`` around a planning
call (``simulate_fork_join_batch``, ``sweep_simulated``,
``plan_capacity(simulate=True)``) shows them beside the kernels, on the
profiler's one clock, with no other set-up:

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        simulate_fork_join_batch(...)
    prof.key_averages().table(sort_by="cpu_time_total")

Every name starts with ``repro_torch.sim.``: ``dispatch`` (one a batch
call, so one a shard of a sharded sweep) holds ``setup`` (arguments,
parameters, bounds, the histogram scale, the carries) and one ``chunk``
a chunk; inside a chunk, consecutive leaf spans cover every operation
the chunk launches: ``draws``, ``arrivals``, ``fleet``, ``route``,
``compact``, ``fcfs.cache``, ``fcfs.broker``, ``fcfs.servers``,
``join``, ``stats``, ``telemetry`` (each only where its layer runs, and
``arrivals``, ``compact`` and ``stats`` may open more than once a chunk).
A device operation belongs to the innermost span around its launch, by
the profiler's correlation id.

:func:`layer_span` is on exactly while a profiler records
(``torch.autograd.profiler._is_profiler_enabled``, or where a torch
lacks that flag ``torch._C._autograd._profiler_enabled()``), with no
knob: off,
it returns one shared ``contextlib.nullcontext()``; on, a
``torch._C._profiler._RecordFunctionFast`` (``record_function`` where a
build lacks that class).  Those spans are not user annotations, so the
profiler mirrors none of them onto the device's timeline.  They touch no
tensor: the chunk loop keeps its contract of no host sync.
:class:`LayerSpans` runs consecutive spans through straight-line code.
Cost an enter/exit on an H100 machine's host (torch 2.11, four runs):
off 0.35-0.67 us (a ``LayerSpans.open`` 0.12-0.21 us), on 1.34-3.34
us, against 14.3-15.6 us for ``record_function``; 114 spans a dispatch
at r = 1, 274 at r = 4 (Table 6, 16 chunks).

PyTorch port of `repro.obs.profile`.  The reference reads XLA's
``cost_analysis()`` and ``memory_analysis()`` off a compiled program;
eager PyTorch has no compiled artifact, so :func:`profile_jit` measures
the call instead:

    rec = profile_jit(fn, *args, name="streaming")   # ProfileRecord
    rec.to_json()

* ``compile_s`` — the first call's wall time, kernel builds at first use
  included (the counterpart of lowering + compiling);
* ``run_s`` — the median of ``n_runs`` timed calls after one warm-up:
  CUDA events on the card, ``perf_counter`` on the CPU;
* ``flops`` — `torch.utils.flop_counter.FlopCounterMode` over the first
  call: the aten operators it has formulas for (matrix products,
  convolutions, attention).  The port's hand-written kernels are ctypes
  calls it cannot see, so they count 0 unless the caller states them;
* ``bytes_accessed`` — the arguments' and outputs' bytes, or the count a
  port kernel states for itself (``bytes_accessed=``);
* ``temp_bytes`` — on the card, the first call's
  ``torch.cuda.max_memory_allocated`` above what was allocated before
  it, less the outputs; 0.0 on the CPU.

A number that cannot be had is 0.0, as in the reference.

:func:`profile_kernels` profiles the plain and segmented (max,+) scans
through the same `ops` dispatch the simulator uses, with the bytes those
kernels move for the call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Any, Callable, ContextManager, Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike

__all__ = ["LayerSpans", "ProfileRecord", "layer_span", "profile_jit",
           "profile_kernels"]

_OFF = contextlib.nullcontext()
_RecordFunction = getattr(torch._C._profiler, "_RecordFunctionFast",
                          torch.profiler.record_function)


def _reader(flags) -> Callable[[], bool]:
    """Whether a profiler records: ``flags._is_profiler_enabled``, the
    module flag ``torch.profiler`` sets, read at each call; where a torch
    lacks that flag, the C++ query (slower, and still right)."""
    if hasattr(flags, "_is_profiler_enabled"):
        return lambda: flags._is_profiler_enabled
    return torch._C._autograd._profiler_enabled


_recording = _reader(_autograd_profiler)


def layer_span(name: str) -> ContextManager:
    """A profiler span named ``name`` while a profiler records; else one
    shared ``contextlib.nullcontext()``."""
    if not _recording():
        return _OFF
    return _RecordFunction(name)


class LayerSpans:
    """Consecutive layer spans of one run, ``prefix`` before each name.

    ``open(name)`` closes the span this object holds open and opens the
    next, so a run of ``open`` calls splits straight-line code into
    layers without indenting it.  ``chunks(n)`` yields ``range(n)``, each
    index inside a ``chunk`` span; the open span closes before each
    chunk span opens and before it closes, so leaves nest in their
    chunk.  Leaving the ``with`` block closes whatever is still open.
    """

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._open = None

    def __enter__(self) -> "LayerSpans":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def open(self, name: str) -> None:
        self.close()
        if _recording():
            span = _RecordFunction(self.prefix + name)
            span.__enter__()
            self._open = span

    def close(self) -> None:
        if self._open is not None:
            span, self._open = self._open, None
            span.__exit__(None, None, None)

    def chunks(self, n: int) -> Iterator[int]:
        self.close()
        name = self.prefix + "chunk"
        for i in range(n):
            with layer_span(name):
                try:
                    yield i
                finally:
                    self.close()


@dataclasses.dataclass(frozen=True)
class ProfileRecord:
    """One call's first-call / run / cost / memory breakdown.

    ``flops`` / ``bytes_accessed`` are for ONE call; ``peak_bytes`` is the
    argument + output + temp proxy for the live working set.  ``run_s``
    is the median of the timed calls (0.0 if none were requested).
    """

    name: str
    compile_s: float
    run_s: float
    flops: float
    bytes_accessed: float
    argument_bytes: float
    output_bytes: float
    temp_bytes: float

    @property
    def peak_bytes(self) -> float:
        return self.argument_bytes + self.output_bytes + self.temp_bytes

    @property
    def arithmetic_intensity(self) -> float:
        """flops per byte accessed — the roofline x-coordinate."""
        return self.flops / max(self.bytes_accessed, 1.0)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "compile_s": self.compile_s,
            "run_s": self.run_s,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "peak_bytes": self.peak_bytes,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ProfileRecord":
        return cls(**{f.name: d[f.name]
                      for f in dataclasses.fields(cls)})


def _tensors(x: Any) -> list[torch.Tensor]:
    """The tensor leaves of nested tuples, lists, dicts and dataclasses."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x)
                for t in _tensors(getattr(x, f.name))]
    return []


def _nbytes(ts: list[torch.Tensor]) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def profile_jit(fn: Callable, *args: Any, name: Optional[str] = None,
                n_runs: int = 3, bytes_accessed: Optional[float] = None,
                **kwargs: Any) -> ProfileRecord:
    """Call ``fn(*args, **kwargs)`` and record its cost breakdown.

    The first call is timed as ``compile_s`` (it builds whatever kernels
    the call uses) and counted by `FlopCounterMode`; then one untimed
    warm-up and ``n_runs`` timed calls give the median ``run_s``.
    ``n_runs=0`` skips those: only the first call runs.  The device is
    the first tensor argument's (the card's clocks and memory counters
    when it is a CUDA device).  ``bytes_accessed`` overrides the
    arguments' and outputs' bytes for a kernel that states its own.
    """
    from torch.utils.flop_counter import FlopCounterMode

    if name is None:
        name = getattr(fn, "__name__", repr(fn))
    arg_ts = _tensors((args, kwargs))
    cuda = any(t.device.type == "cuda" for t in arg_ts)

    def call():
        return fn(*args, **kwargs)

    base = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with counter:
        out = call()
    if cuda:
        torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    out_bytes = _nbytes(_tensors(out))
    temp = 0.0
    if cuda:
        temp = max(float(torch.cuda.max_memory_allocated() - base)
                   - out_bytes, 0.0)
    del out

    run_s = 0.0
    if n_runs > 0:
        call()                                        # warm-up
        times = []
        for _ in range(n_runs):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                call()
                stop.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(stop) / 1e3)
            else:
                t0 = time.perf_counter()
                call()
                times.append(time.perf_counter() - t0)
        run_s = statistics.median(times)

    arg_bytes = _nbytes(arg_ts)
    return ProfileRecord(
        name=name,
        compile_s=compile_s,
        run_s=run_s,
        flops=float(counter.get_total_flops()),
        bytes_accessed=(arg_bytes + out_bytes if bytes_accessed is None
                        else float(bytes_accessed)),
        argument_bytes=arg_bytes,
        output_bytes=out_bytes,
        temp_bytes=temp,
    )


def profile_kernels(rows: int = 64, cols: int = 4096, n_runs: int = 3, *,
                    device: DeviceLike = DEFAULT_DEVICE
                    ) -> list[ProfileRecord]:
    """Profile the (max, +) kernel stack on a representative shape.

    rows x cols mirrors a streaming chunk's (S * r * (p + 1), chunk)
    flattening.  The plain scan and the segmented one (8-way segments,
    the fused replicated engine's) run through the SAME `ops` dispatch
    the simulator uses (the CUDA kernels on the card), both outputs
    returned, as the reference profiles them.  Their bytes are what the
    kernels move: a and b read, out_a and out_b written, and the
    segmented scan's one row of uint8 flags.
    """
    from repro_torch.kernels.maxplus_scan import ops as mp_ops

    dev = torch.device(device)
    a = torch.linspace(0.0, 1.0, rows * cols, device=dev).reshape(rows,
                                                                  cols)
    b = torch.full((rows, cols), 0.01, device=dev)
    flags = (torch.arange(cols, device=dev) % max(cols // 8, 1) == 0)
    moved = 4.0 * rows * cols * a.element_size()
    return [
        profile_jit(mp_ops.maxplus_scan, a, b, name="maxplus_scan",
                    n_runs=n_runs, bytes_accessed=moved),
        profile_jit(mp_ops.maxplus_segment_scan, a, b, flags[None, :],
                    name="maxplus_segment_scan", n_runs=n_runs,
                    bytes_accessed=moved + cols),
    ]
