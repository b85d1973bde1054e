"""Bind and launch the hand-written CUDA decode-attention kernel.

``csrc/decode_attention.cu`` replaces the Pallas TPU kernel
`repro.kernels.decode_attention.kernel.decode_attention_pallas`.  It takes
the model's layout with strides: q (B, 1, H, D) and one layer's cache
k, v (B, S, KV, D).  One launch a call: blocks split the positions
(flash-decoding), K and V arrive by TMA, and the last block of each
(batch, kv head) row merges the splits (an atomic ticket on a counter
array allocated here once for each device and stream: calls on one
stream run in order, so they never share tickets in flight).  The launch plan (TMA maps of the
cache's full S, shared memory) is `decode_plan`, memoised on shapes and
strides; the split of a call's positions is `split_plan`.  Built by
`repro_torch.kernels._cuda.CudaLibrary` at first use; ``launches`` counts
the launches this process made.

`decode_attention_cuda` is the custom operator
``repro_torch::decode_attention``: a fake gives its output's shape and a
FLOP formula its products, so a trace on fake tensors
(`repro_torch.launch.dryrun`) and ``FlopCounterMode`` on the card see the
kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._cuda import (CudaLibrary, check_rows16,
                                       int64_array, ptr)
from repro_torch.kernels.hopper import HEADER, TmaMap, tma_map

Tensor = torch.Tensor

_HERE = pathlib.Path(__file__).resolve().parent
_P = ctypes.c_void_p
_I = ctypes.c_int64

LIB = CudaLibrary(
    _HERE / "csrc" / "decode_attention.cu",
    {name: [_P] * 6 + [ctypes.POINTER(_I)] + [_I] * 4 + [_P]
     for name in ("decode_attention_f32", "decode_attention_bf16")},
    headers=(HEADER,))
HEAD_DIMS = (8, 16, 32, 64, 128)   # the D the kernels take
MAX_GROUPS = 16                    # H / KV: 1 .. kMaxG
BLOCK_N = 32                       # kBlockN: positions a K/V tile
STAGES = 4                         # kStages: the ring
CONSUMERS = 4                      # kConsumers: consumer warps a block
THREADS = 32 * (1 + CONSUMERS)     # and one producer warp
MIN_SPLIT_TILES = 32               # tiles a split walks at least

__all__ = ["LIB", "HEAD_DIMS", "MAX_GROUPS", "BLOCK_N", "DecodePlan",
           "decode_plan", "split_plan", "decode_attention_cuda"]

launches = 0          # kernel launches in this process

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# per (device, stream): the merge tickets
_COUNTERS: dict[tuple[int, int], Tensor] = {}


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """What the kernel holds fixed for one cache layout: tiles of BLOCK_N
    positions x ``dp`` elements (D, or 16 for a bf16 D of 8, the upper
    half zeros from TMA), loaded as bands of one box row (``k_map``,
    ``v_map``, over the cache's full S); a block of THREADS threads and
    ``smem_bytes`` of shared memory."""
    groups: int
    d: int
    dp: int
    smem_bytes: int
    k_map: TmaMap
    v_map: TmaMap
    head: tuple[int, ...]

    @functools.cached_property
    def args(self) -> ctypes.Array:
        """The plan as the C entry point reads it (kPlanLen int64)."""
        return int64_array([*self.head, *self.k_map.spec(),
                            *self.v_map.spec()])

    @staticmethod
    def tile_rows(t: int, n: int) -> tuple[int, int]:
        """(first position loaded, first position counted) of tile t of
        a call over n positions: the tile that would cross n is loaded
        from n - BLOCK_N (negative positions come as TMA's zeros), so no
        position >= n is read, and its rows below t BLOCK_N are masked."""
        return min(t * BLOCK_N, n - BLOCK_N), t * BLOCK_N


@functools.lru_cache(maxsize=256)
def decode_plan(q_shape, q_strides, k_shape, k_strides, v_strides,
                elem_bytes: int) -> DecodePlan:
    """The plan for q (B, 1, H, D) and k, v (B, S, KV, D) of the given
    strides (elements) in a type of ``elem_bytes``; the output is the
    wrapper's contiguous (B, 1, H, D).  Memoised: a decode step asks for
    one shape a layer, the same from step to step."""
    b, _, h, d = (int(x) for x in q_shape)
    _, s, kv, _ = (int(x) for x in k_shape)
    groups = h // kv
    dp = 16 if (d == 8 and elem_bytes == 2) else d
    row_bytes = min(dp * elem_bytes, 128)
    band = row_bytes // elem_bytes
    ring = STAGES * 2 * BLOCK_N * dp * elem_bytes
    smem = 1024 + ring + 16 * STAGES + 16
    box = (1, BLOCK_N, 1, band)
    head = (THREADS, smem, dp, groups, d, kv, b, int(q_strides[0]),
            int(q_strides[2]), h * d, d)
    return DecodePlan(
        groups=groups, d=d, dp=dp, smem_bytes=smem,
        k_map=tma_map((b, s, kv, d), k_strides, box, elem_bytes),
        v_map=tma_map((b, s, kv, d), v_strides, box, elem_bytes),
        head=head)


@functools.lru_cache(maxsize=4096)
def split_plan(n: int, rows: int, sms: int) -> tuple[int, int]:
    """(chunk, splits): ``n`` positions of each of ``rows`` = B x KV rows
    cut into ``splits`` runs of ``chunk`` positions (a multiple of
    BLOCK_N), one block each: as many splits as put one block on each of
    the card's ``sms`` SMs, but none shorter than MIN_SPLIT_TILES tiles.
    A block's fixed cost (its ring, its first loads, a split's partial
    and merge) outweighs more blocks in flight: on the card, B x KV = 64
    rows ran fastest with 1 split at 517 positions, 1-2 at 2,101 and 2
    at 32,768 (PERF.md)."""
    tiles = -(-n // BLOCK_N)
    splits = max(1, min(sms // max(rows, 1), tiles // MIN_SPLIT_TILES))
    per = -(-tiles // splits)
    return per * BLOCK_N, -(-tiles // per)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _counter(index: int, rows: int) -> Tensor:
    """The merge tickets of device ``index``'s current stream (int32, zero
    between calls: the block that merges a row resets it), grown to
    ``rows``.  One array a stream: two calls in flight at once on two
    streams would otherwise take each other's tickets, and a row could
    merge before its splits have landed."""
    key = (index, torch.cuda.current_stream(index).cuda_stream)
    have = _COUNTERS.get(key)
    if have is None or have.numel() < rows:
        have = torch.zeros(max(rows, 1024), dtype=torch.int32,
                           device=torch.device("cuda", index))
        _COUNTERS[key] = have
    return have


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def decode_attention_cuda(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                          length: int) -> Tensor:
    """Launch the kernel: q (B, 1, H, D) against k/v (B, S, KV, D), cache
    positions 0..``length`` (inclusive) -> (B, 1, H, D).

    Any strides with a contiguous, 16-byte aligned last axis.  Raises on
    anything the kernel does not take: no conversion, no fallback.
    """
    global launches
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache}
    if any(t.device.type != "cuda" or t.device != q.device
           for t in tensors.values()):
        raise ValueError("the CUDA decode attention needs CUDA tensors on "
                         "one device; got "
                         f"{[str(t.device) for t in tensors.values()]}")
    if (q.dtype not in _SUFFIX or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise TypeError("the CUDA decode attention takes float32 or bfloat16 "
                        f"q and caches of one dtype; got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if (q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4
            or v_cache.shape != k_cache.shape):
        raise ValueError(f"q must be (B, 1, H, D) and the caches (B, S, KV, "
                         f"D); got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, _, h, d = q.shape
    _, s, kv, _ = k_cache.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} and the caches "
                         f"{tuple(k_cache.shape)} do not share B and D, or H "
                         "is not a multiple of KV")
    groups = h // kv
    if d not in HEAD_DIMS or not 1 <= groups <= MAX_GROUPS:
        raise ValueError(f"the CUDA decode attention takes D in {HEAD_DIMS} "
                         f"and H / KV in 1..{MAX_GROUPS}; got D={d}, "
                         f"H / KV={groups}")
    length = int(length)
    if not 0 <= length < s or s >= 2 ** 31 or b > 65535 or kv > 65535:
        raise ValueError(f"length {length} must index the cache's {s} "
                         f"positions (shape {tuple(k_cache.shape)})")
    for name, t in tensors.items():
        check_rows16(name, t)
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    n = length + 1
    plan = decode_plan(q.shape, q.stride(), k_cache.shape, k_cache.stride(),
                       v_cache.stride(), q.element_size())
    index = (q.device.index if q.device.index is not None
             else torch.cuda.current_device())
    chunk, splits = split_plan(n, b * kv, _sm_count(index))
    part = torch.empty(b * kv * splits * groups * (d + 2) if splits > 1
                       else 1, dtype=torch.float32, device=q.device)
    LIB.call(f"decode_attention_{_SUFFIX[q.dtype]}", q.device, ptr(q),
             ptr(k_cache), ptr(v_cache), ptr(out), ptr(part),
             ptr(_counter(index, b * kv)), plan.args, len(plan.args), n,
             splits, chunk // BLOCK_N)
    launches += 1
    return out


@decode_attention_cuda.register_fake
def _(q: Tensor, k_cache: Tensor, v_cache: Tensor, length: int) -> Tensor:
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _flops(q_shape, k_shape, v_shape, length: int, *, out_shape=None,
           **kwargs) -> int:
    """QK^T and PV over cache positions 0..``length``."""
    b, _, h, d = q_shape
    return 4 * b * h * d * (int(length) + 1)
