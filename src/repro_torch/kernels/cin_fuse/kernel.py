"""Bind and launch the hand-written CUDA CIN-layer kernel.

``csrc/cin_fuse.cu`` replaces the Pallas TPU kernel
`repro.kernels.cin_fuse.kernel.cin_layer_pallas`: one xDeepFM CIN layer as
an implicit GEMM whose A operand, the (B, Hk, m, D) outer product, is
formed in registers and never written to device memory.  bfloat16 runs
the warp-specialised wgmma kernel, whose launch plan (grid, W's TMA box,
shared memory, split-K count) is `cin_plan`; float32 runs on FMAs.  Built
by `repro_torch.kernels._cuda.CudaLibrary` at first use; ``launches``
counts the calls this process launched (a split-K call is two device
launches: the products and the fixed-order sum of the splits).

`cin_layer_cuda` is the custom operator ``repro_torch::cin_layer``: a fake
gives its output's shape and a FLOP formula its products, so a trace on
fake tensors (`repro_torch.launch.dryrun`) and ``FlopCounterMode`` on the
card see the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._cuda import CudaLibrary, int64_array, ptr
from repro_torch.kernels.hopper import HEADER, TmaMap, tma_map

Tensor = torch.Tensor

_HERE = pathlib.Path(__file__).resolve().parent
_P = ctypes.c_void_p
_I = ctypes.c_int64

LIB = CudaLibrary(
    _HERE / "csrc" / "cin_fuse.cu",
    {"cin_layer_f32": [_P] * 4 + [_I] * 5 + [_P],
     "cin_layer_bf16": [_P] * 5 + [ctypes.POINTER(_I), _I, _P]},
    headers=(HEADER,))
MAX_ROW_VALUES = 768    # Hk + m: the float32 kernel stages 64 rows of them
MAX_FIELDS = 64         # m on the tensor cores: x0 rows held in registers
N_TILES = (16, 32, 64, 128, 200)   # wgmma widths instantiated
WIDE_TILE = 128         # the column tile of an O past N_TILES[-1]
CONSUMERS = 2           # wg::kConsumers, 64 rows each
BLOCK_ROWS = 64 * CONSUMERS
STAGES = 4              # wg::kStages: the W ring
THREADS = 128 * (1 + CONSUMERS)

__all__ = ["LIB", "CinPlan", "cin_plan", "check_inputs", "cin_layer_cuda"]

launches = 0          # kernel launches in this process

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@dataclasses.dataclass(frozen=True)
class CinPlan:
    """How the bf16 kernel covers one layer.  Block (x, y, z) owns rows
    (b, d) BLOCK_ROWS x .. of the B D rows, columns n_tile y .. of the
    O, and h in [h_per_split z, h_per_split (z + 1)) of the Hk; with
    splits > 1 it writes a float32 partial that a second pass sums."""
    grid: tuple[int, int, int]
    threads: int
    rows_per_block: int
    n_tile: int
    k_steps: int          # k16 steps an h: m padded to 16 k_steps
    h_per_split: int
    splits: int
    stages: int
    smem_bytes: int
    batch: int
    hk: int
    m: int
    d: int
    n_out: int
    o_pad: int            # W's row length as the kernel reads it
    pad_w: bool           # W is handed over as a copy of o_pad columns
    w_map: TmaMap

    def block_rows(self, bx: int) -> range:
        return range(bx * self.rows_per_block,
                     min((bx + 1) * self.rows_per_block, self.batch * self.d))

    def block_cols(self, by: int) -> range:
        return range(by * self.n_tile,
                     min((by + 1) * self.n_tile, self.n_out))

    def block_k(self, bz: int) -> range:
        """The K indices h m + j a split walks (j < m; the padded j are
        zeros in both operands)."""
        h = range(bz * self.h_per_split,
                  min((bz + 1) * self.h_per_split, self.hk))
        return range(h.start * self.m, h.stop * self.m)

    @functools.cached_property
    def args(self) -> ctypes.Array:
        """The plan as the C entry point reads it (wg::kPlanLen int64)."""
        return int64_array([*self.grid, self.threads, self.smem_bytes,
                            self.n_tile, self.k_steps, self.h_per_split,
                            self.stages, self.batch, self.hk, self.m, self.d,
                            self.n_out, *self.w_map.spec()])


@functools.lru_cache(maxsize=256)
def cin_plan(batch: int, hk: int, m: int, d: int, n_out: int, *,
             n_sm: int = 132, w_aligned: bool = True) -> CinPlan:
    """The bf16 kernel's plan for xk (B, Hk, D), x0 (B, m, D) and W
    (Hk m, O) on a card of ``n_sm`` SMs.  N: the narrowest of N_TILES
    that holds O rounded up to 8 (column tiles of WIDE_TILE past that).
    K is split over h when the row tiles would not fill the SMs, into as
    many splits as fit one wave.  W is read as (Hk, m, O) through boxes of (1 h, 16
    k_steps rows, a band of at most 64 columns); rows j >= m of a box are
    out of bounds, so the map fills them with zeros.  Memoised: a served
    model asks for a handful of shapes."""
    o8 = -(-n_out // 8) * 8
    n_tile = next((n for n in N_TILES if n >= o8), WIDE_TILE)
    k_steps = -(-m // 16)
    row_blocks = -(-batch * d // BLOCK_ROWS)
    splits = 1
    if 0 < row_blocks < n_sm:
        splits = max(1, min(hk, n_sm // row_blocks))
    h_per_split = -(-hk // splits) if hk else 1
    splits = -(-hk // h_per_split) if hk else 1
    band = min(n_tile, 64)
    boxes = -(-n_tile // band)
    smem = (1024 + STAGES * boxes * 16 * k_steps * 2 * band + 16 * STAGES)
    pad_w = not (n_out % 8 == 0 and w_aligned)   # TMA: 16-byte rows
    return CinPlan(
        grid=(row_blocks, -(-n_out // n_tile), splits), threads=THREADS,
        rows_per_block=BLOCK_ROWS, n_tile=n_tile, k_steps=k_steps,
        h_per_split=h_per_split, splits=splits, stages=STAGES,
        smem_bytes=smem, batch=batch, hk=hk, m=m, d=d, n_out=n_out,
        o_pad=o8, pad_w=pad_w,
        w_map=tma_map((hk, m, o8), (m * o8, o8, 1),
                      (1, 16 * k_steps, band)))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_inputs(xk: Tensor, x0: Tensor, w: Tensor) -> None:
    """Raise on anything the kernel does not take, the device aside:
    dtype, shapes, Hk + m, m on the tensor cores, contiguity."""
    tensors = {"xk": xk, "x0": x0, "w": w}
    if xk.dtype not in _SUFFIX or x0.dtype != xk.dtype or w.dtype != xk.dtype:
        raise TypeError("the CUDA CIN layer takes float32 or bfloat16 "
                        "inputs of one dtype; got "
                        f"{xk.dtype}, {x0.dtype}, {w.dtype}")
    if xk.ndim != 3 or x0.ndim != 3 or w.ndim != 2:
        raise ValueError(f"xk must be (B, Hk, D), x0 (B, m, D) and w "
                         f"(Hk*m, O); got {tuple(xk.shape)}, "
                         f"{tuple(x0.shape)}, {tuple(w.shape)}")
    b, hk, d = xk.shape
    m = x0.shape[1]
    if x0.shape[0] != b or x0.shape[2] != d or w.shape[0] != hk * m:
        raise ValueError(f"xk {tuple(xk.shape)}, x0 {tuple(x0.shape)} and w "
                         f"{tuple(w.shape)} do not agree on B, D and Hk*m")
    if hk + m > MAX_ROW_VALUES:
        raise ValueError(f"Hk + m = {hk + m} exceeds {MAX_ROW_VALUES}")
    if xk.dtype == torch.bfloat16 and m > MAX_FIELDS:
        raise ValueError(f"the tensor-core CIN layer takes m <= {MAX_FIELDS} "
                         f"fields; got {m}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"the CUDA CIN layer needs a contiguous {name} "
                             f"(strides {t.stride()})")


@torch.library.custom_op("repro_torch::cin_layer", mutates_args=())
def cin_layer_cuda(xk: Tensor, x0: Tensor, w: Tensor) -> Tensor:
    """Launch the kernel: xk (B, Hk, D), x0 (B, m, D), w (Hk*m, O) ->
    (B, O, D) in xk's dtype.

    float32 or bfloat16, one dtype, contiguous, on one CUDA device; in
    bfloat16 at most MAX_FIELDS fields.  Raises on anything else: no
    conversion, no fallback.
    """
    global launches
    if any(t.device.type != "cuda" or t.device != xk.device
           for t in (xk, x0, w)):
        raise ValueError("the CUDA CIN layer needs CUDA tensors on one "
                         "device; got "
                         f"{[str(t.device) for t in (xk, x0, w)]}")
    check_inputs(xk, x0, w)
    b, hk, d = xk.shape
    m = x0.shape[1]
    o = w.shape[1]
    y = torch.empty((b, o, d), dtype=xk.dtype, device=xk.device)
    if y.numel() == 0:
        return y
    if xk.dtype == torch.float32:
        LIB.call("cin_layer_f32", xk.device, ptr(xk), ptr(x0), ptr(w),
                 ptr(y), b, hk, m, d, o)
    else:
        plan = cin_plan(b, hk, m, d, o, n_sm=_sm_count(xk.device),
                        w_aligned=w.data_ptr() % 16 == 0)
        if plan.pad_w:
            padded = torch.zeros((hk * m, plan.o_pad), dtype=w.dtype,
                                 device=w.device)
            padded[:, :o] = w
            w = padded
        partial = (torch.empty((plan.splits, b, o, d), dtype=torch.float32,
                               device=xk.device) if plan.splits > 1 else None)
        LIB.call("cin_layer_bf16", xk.device, ptr(xk), ptr(x0), ptr(w),
                 ptr(y), ptr(partial), plan.args, len(plan.args))
    launches += 1
    return y


@cin_layer_cuda.register_fake
def _(xk: Tensor, x0: Tensor, w: Tensor) -> Tensor:
    return xk.new_empty((xk.shape[0], w.shape[1], xk.shape[2]))


@register_flop_formula(torch.ops.repro_torch.cin_layer)
def _flops(xk_shape, x0_shape, w_shape, *, out_shape=None, **kwargs) -> int:
    """The contraction over (h, j) of every output (b, o, d)."""
    b, hk, d = xk_shape
    return 2 * b * d * hk * x0_shape[1] * w_shape[1]
