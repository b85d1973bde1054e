"""Bind and launch the hand-written CUDA flash-attention kernel.

``csrc/flash_attention.cu`` replaces the Pallas TPU kernel
`repro.kernels.flash_attention.kernel.flash_attention_pallas`.  It takes
the model's layout with strides: q (B, S, H, D) and k, v (B, S, KV, D),
so no transposed copy is made.  bfloat16 runs the warp-specialised wgmma
kernel, whose launch plan (grid, TMA boxes and strides, shared memory) is
`flash_plan`; float32 runs the FMA kernel.  Built by
`repro_torch.kernels._cuda.CudaLibrary` at first use; ``launches`` counts
the launches this process made.

`flash_attention_cuda` is the custom operator
``repro_torch::flash_attention``: a fake gives its output's shape and a
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
    _HERE / "csrc" / "flash_attention.cu",
    {"flash_attention_f32": [_P] * 4 + [ctypes.POINTER(_I)] + [_I] * 7 + [_P],
     "flash_attention_bf16": [_P] * 4 + [ctypes.POINTER(_I), _I, _P]},
    headers=(_HERE.parent / "csrc" / "attention_io.cuh", HEADER))
HEAD_DIMS = (8, 16, 32, 64, 128)   # the D the kernels take (8 through
                                   # D = 16's tiles, zero-filled by TMA)
MAX_GROUPS = 64                    # H / KV: 1 .. 64
ROWS = 64                          # query rows (positions x G) of one
                                   # consumer warpgroup (bf16) or block (f32);
                                   # 64 // G positions, the rows past
                                   # (64 // G) G idle
CONSUMERS = 2                      # wg::kConsumers
BLOCK_ROWS = ROWS * CONSUMERS      # query rows a bf16 block
BLOCK_N = 64                       # wg::kBlockN: key positions a K/V tile
STAGES = 4                         # wg::kStages: the K/V ring
THREADS = 128 * (1 + CONSUMERS)    # a producer and the consumers

__all__ = ["LIB", "HEAD_DIMS", "MAX_GROUPS", "ROWS", "FlashPlan",
           "flash_plan",
           "check_inputs", "flash_attention_cuda"]

launches = 0          # kernel launches in this process

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How the bf16 kernel covers one call.  Block (x, y, z) holds
    CONSUMERS tiles of ROWS query rows of kv head y, batch z: row r of
    consumer c is position q0 + c (ROWS // G) + r // G, head y G + r % G,
    for r < (ROWS // G) G (the rest idle), q0 = (grid x - 1 - x)
    positions_per_block (heaviest first); it walks K/V tiles of BLOCK_N
    positions up to its causal limit."""
    grid: tuple[int, int, int]
    threads: int
    rows_per_block: int
    positions_per_block: int
    block_n: int
    smem_bytes: int
    sq: int
    sk: int
    groups: int
    d: int
    causal: bool
    q_map: TmaMap
    k_map: TmaMap
    v_map: TmaMap

    def q0(self, bx: int) -> int:
        return (self.grid[0] - 1 - bx) * self.positions_per_block

    def block_rows(self, bx: int, by: int) -> list[tuple[int, int] | None]:
        """(position, head) of each row of block (bx, by, .), past-Sq
        rows included (the kernel neither reads nor stores them); None
        for an idle row."""
        q0 = self.q0(bx)
        per_c = ROWS // self.groups
        rows = []
        for r in range(self.rows_per_block):
            c, rr = divmod(r, ROWS)
            rows.append(None if rr >= per_c * self.groups else
                        (q0 + c * per_c + rr // self.groups,
                         by * self.groups + rr % self.groups))
        return rows

    def kv_tiles(self, bx: int) -> list[int]:
        """First positions of the K/V tiles block bx loads."""
        q_last = min(self.q0(bx) + self.positions_per_block, self.sq) - 1
        k_end = min(self.sk, q_last + 1) if self.causal else self.sk
        return list(range(0, k_end, self.block_n))

    @functools.cached_property
    def args(self) -> ctypes.Array:
        """The plan as the C entry point reads it (wg::kPlanLen int64);
        the output is the wrapper's contiguous (B, Sq, H, D)."""
        h = self.groups * self.grid[1]
        return int64_array([*self.grid, self.threads, self.smem_bytes,
                            self.sq, self.sk, self.groups, self.d,
                            int(self.causal), self.sq * h * self.d,
                            h * self.d, self.d, *self.q_map.spec(),
                            *self.k_map.spec(), *self.v_map.spec()])


@functools.lru_cache(maxsize=256)
def flash_plan(q_shape, q_strides, k_shape, k_strides, v_strides, *,
               causal: bool = True) -> FlashPlan:
    """The bf16 kernel's plan for q (B, Sq, H, D) and k, v (B, Sk, KV, D)
    of the given strides (elements): TMA boxes of a band of 16 to 64
    elements of D (its bytes the swizzle; D = 8 takes a 16-wide band,
    zero past the tensor's 8): (1, ROWS // G positions, G heads, band)
    for Q, (1, BLOCK_N positions, 1 head, band) for K and V.  Memoised: a
    served model asks for a handful of shapes."""
    b, sq, h, d = (int(x) for x in q_shape)
    _, sk, kv, _ = (int(x) for x in k_shape)
    groups = h // kv
    dp = max(d, 16)                  # the tiles' width
    band = min(dp, 64)
    positions = CONSUMERS * (ROWS // groups)
    smem = (1024 + BLOCK_ROWS * dp * 2 + STAGES * 2 * BLOCK_N * dp * 2
            + 8 * (1 + 2 * STAGES))
    return FlashPlan(
        grid=(-(-sq // positions), kv, b), threads=THREADS,
        rows_per_block=BLOCK_ROWS, positions_per_block=positions,
        block_n=BLOCK_N, smem_bytes=smem, sq=sq, sk=sk, groups=groups, d=d,
        causal=bool(causal),
        q_map=tma_map((b, sq, h, d), q_strides, (1, ROWS // groups, groups,
                                                 band)),
        k_map=tma_map((b, sk, kv, d), k_strides, (1, BLOCK_N, 1, band)),
        v_map=tma_map((b, sk, kv, d), v_strides, (1, BLOCK_N, 1, band)))


def check_inputs(q: Tensor, k: Tensor, v: Tensor) -> int:
    """Raise on anything the kernel does not take, the device aside:
    dtype, shapes, D in HEAD_DIMS, H / KV in 1..MAX_GROUPS, the grid's
    limits, 16-byte rows.  Returns G = H / KV."""
    tensors = {"q": q, "k": k, "v": v}
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the CUDA flash attention takes float32 or bfloat16 "
                        f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, Sk, KV, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not "
                         "share B and D, or H is not a multiple of KV")
    groups = h // kv
    if d not in HEAD_DIMS or not 1 <= groups <= MAX_GROUPS:
        raise ValueError(f"the CUDA flash attention takes D in {HEAD_DIMS} "
                         f"and H / KV in 1..{MAX_GROUPS}; got D={d}, "
                         f"H / KV={groups}")
    if max(sq, sk) >= 2 ** 31 or b > 65535 or kv > 65535:
        raise ValueError(f"shape {tuple(q.shape)} / {tuple(k.shape)} is past "
                         "the kernel's grid")
    for name, t in tensors.items():
        check_rows16(name, t)
    return groups


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = True) -> Tensor:
    """Launch the kernel: q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D).

    Any strides with a contiguous, 16-byte aligned last axis.  Raises on
    anything the kernel does not take: no conversion, no fallback.
    """
    global launches
    if any(t.device.type != "cuda" or t.device != q.device
           for t in (q, k, v)):
        raise ValueError("the CUDA flash attention needs CUDA tensors on one "
                         f"device; got {[str(t.device) for t in (q, k, v)]}")
    groups = check_inputs(q, k, v)
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if sk == 0:
        raise ValueError("no key positions to attend to (Sk = 0)")
    if q.dtype == torch.bfloat16:
        plan = flash_plan(q.shape, q.stride(), k.shape, k.stride(),
                          v.stride(), causal=bool(causal))
        LIB.call("flash_attention_bf16", q.device, ptr(q), ptr(k), ptr(v),
                 ptr(out), plan.args, len(plan.args))
    else:
        strides = int64_array([*q.stride()[:3], *k.stride()[:3],
                               *v.stride()[:3], *out.stride()[:3]])
        LIB.call("flash_attention_f32", q.device, ptr(q), ptr(k), ptr(v),
                 ptr(out), strides, b, sq, sk, kv, groups, d, int(causal))
    launches += 1
    return out


@flash_attention_cuda.register_fake
def _(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True) -> Tensor:
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, *, causal: bool = True,
           out_shape=None, **kwargs) -> int:
    """QK^T and PV over the (query, key) pairs the kernel visits: every
    pair, or under ``causal`` query i's keys 0..i."""
    b, sq, h, d = q_shape
    sk = k_shape[1]
    if not causal:
        pairs = sq * sk
    else:
        full = min(sq, sk)
        pairs = full * (full + 1) // 2 + (sq - full) * sk
    return 4 * b * h * d * pairs
