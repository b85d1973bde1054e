"""Bind and launch the hand-written CUDA service sampler.

``csrc/service_sample.cu`` writes a chunk's (S, p, n) float32 service
times in one launch, generating in registers the very variates that the
plain path (`ref.service_times_ref`) draws with torch's CUDA generators,
so both paths agree bit for bit.  It replaces no Pallas kernel.  The
launches mirror torch's own for a draw of the same size
(`draw_launches`): 256 threads a block and `grid_size` blocks, from the
device's SM count and threads an SM, read once a device; past 2^29
elements, one launch for each piece torch splits the draw into, at that
piece's Philox offset.  It is built by
`repro_torch.kernels._cuda.CudaLibrary` at first use.  ``launches``
counts the launches this process made.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Optional

import torch

from repro_torch.kernels._cuda import CudaLibrary, ptr

Tensor = torch.Tensor

_P = ctypes.c_void_p
_U = ctypes.c_uint64
_I = ctypes.c_int64

LIB = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "service_sample.cu",
    {"service_sample_cache_f32": [_P] * 5 + [_U] * 5 + [_I] * 4 + [_P],
     "service_sample_exp_f32": [_P] * 2 + [_U] * 2 + [_I] * 4 + [_P]})
THREADS = 256           # torch's block_size_bound
SPLIT_NUMEL = 2 ** 29   # torch draws a float32 tensor in one launch only
                        # while its byte offsets fit in 32 bits
MAX_PER_SCENARIO = 2 ** 31   # p x n the kernel's scenario stepping takes
STREAMS = {"cache": 4, "exponential": 1}   # seeds (and fields) a mode reads

__all__ = ["LIB", "MAX_PER_SCENARIO", "SPLIT_NUMEL", "STREAMS", "THREADS",
           "draw_launches", "grid_size", "service_sample_cuda",
           "unsupported"]

launches = 0          # kernel launches in this process


def grid_size(numel: int, sm_count: int, threads_per_sm: int) -> int:
    """Blocks of torch's draw of ``numel`` elements (``calc_execution_
    policy``): as many as the SMs hold at once, or fewer when the elements
    run out first."""
    return min(sm_count * (threads_per_sm // THREADS),
               (numel + THREADS - 1) // THREADS)


def _counter_offset(numel: int, grid: int) -> int:
    """Philox offset torch reserves for a draw of ``numel`` elements on
    ``grid`` blocks (``calc_execution_policy``): four words for each
    ``curand_uniform4`` call of a thread."""
    return ((numel - 1) // (THREADS * grid * 4) + 1) * 4


def draw_launches(numel: int, sm_count: int, threads_per_sm: int, *,
                  split: int = SPLIT_NUMEL) -> list[tuple[int, int, int,
                                                          int]]:
    """Torch's launches for a float32 draw of ``numel`` elements from a
    freshly seeded CUDA generator, as (first element, elements, grid,
    Philox counter base) each.

    Up to ``split`` elements that is one launch at offset 0.  Past it
    (``distribution_nullary_kernel``) torch first reserves the whole
    draw's offset, then halves the draw, first half first
    (``SplitUntil32Bit``, ``TensorIteratorBase::split``), until every
    piece fits, and gives each piece the generator's offset then, and
    reserves that piece's own."""
    def pieces(start: int, n: int):
        if n <= split:
            yield start, n
        else:
            half = n // 2
            yield from pieces(start, half)
            yield from pieces(start + half, n - half)

    offset = (0 if numel <= split else _counter_offset(
        numel, grid_size(numel, sm_count, threads_per_sm)))
    out = []
    for start, n in pieces(0, numel):
        grid = grid_size(n, sm_count, threads_per_sm)
        out.append((start, n, grid, offset // 4))
        offset += _counter_offset(n, grid)
    return out


@functools.lru_cache(maxsize=None)
def _sm_shape(index: int) -> tuple[int, int]:
    """(SMs, threads an SM) of CUDA device ``index``, read once."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.max_threads_per_multi_processor


def unsupported(device: torch.device, dtype: torch.dtype, mode: str,
                per_scenario: int) -> Optional[str]:
    """Why the kernel does not take this draw of ``per_scenario`` = p x n
    elements a scenario, or None when it does."""
    if device.type != "cuda":
        return f"needs a CUDA device; got {device}"
    if dtype != torch.float32:
        return f"takes float32; got {dtype}"
    if mode not in STREAMS:
        return f"takes modes {tuple(STREAMS)}; got {mode!r}"
    if per_scenario > MAX_PER_SCENARIO:
        return (f"takes at most {MAX_PER_SCENARIO} elements a scenario; "
                f"got {per_scenario}")
    return None


def service_sample_cuda(seeds: tuple[int, ...], shape: tuple[int, int, int],
                        fields: tuple[Tensor, ...], mode: str) -> Tensor:
    """Launch the sampler; returns the (S, p, n) services of
    `ref.service_times_ref` for the same arguments.  ``fields`` are
    contiguous (S,) float32 tensors on one CUDA device.  Raises on
    anything the kernel does not take: no conversion, no fallback."""
    global launches
    n_scen, p, n = shape
    numel = n_scen * p * n
    dev = fields[0].device
    why = unsupported(dev, fields[0].dtype, mode, p * n)
    if why:
        raise ValueError(f"the CUDA service sampler {why}")
    if len(seeds) != STREAMS[mode] or len(fields) != STREAMS[mode]:
        raise ValueError(f"mode {mode!r} takes {STREAMS[mode]} seeds and "
                         f"fields; got {len(seeds)} and {len(fields)}")
    if any(f.device != dev or f.dtype != torch.float32
           or tuple(f.shape) != (n_scen,) or not f.is_contiguous()
           for f in fields):
        raise ValueError(f"fields must be contiguous ({n_scen},) float32 "
                         f"tensors on {dev}; got "
                         f"{[(str(f.dtype), tuple(f.shape)) for f in fields]}")
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if numel == 0:
        return out
    sm = _sm_shape(dev.index if dev.index is not None
                   else torch.cuda.current_device())
    words = [int(s) & ((1 << 64) - 1) for s in seeds]
    for start, length, grid, base in draw_launches(numel, *sm):
        if mode == "cache":
            LIB.call("service_sample_cache_f32", dev, ptr(out),
                     *(ptr(f) for f in fields), *words, base, start, length,
                     p * n, grid)
        else:
            LIB.call("service_sample_exp_f32", dev, ptr(out), ptr(fields[0]),
                     words[0], base, start, length, p * n, grid)
        launches += 1
    return out
