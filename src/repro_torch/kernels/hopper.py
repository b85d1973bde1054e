"""Host-side geometry shared by the port's Hopper (wgmma + TMA) kernels,
and the one-tile check of ``csrc/hopper.cuh``.

A kernel's launch plan (grid, rows a block, TMA boxes and byte strides,
shared-memory bytes, split-K count) is a pure function of the shapes
and strides its wrapper sees, kept in Python so that the CPU tests reach
it; the plan is handed to the C entry point, which encodes the tensor
maps from it (``cuTensorMapEncodeTiled``) and checks it against what the
kernel was compiled for.  `TmaMap` is one map in that plan.

``hopper_tile.cu`` takes one 64 x N x K bf16 product through the same
TMA loads, descriptors and wgmma instructions the kernels use
(`tile_product`); the card tests and `chip_smoke.py` hold it against a
float32 ``torch.matmul`` so that a descriptor bug shows before it reaches
a kernel.  Nothing here is built or launched at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import pathlib
from typing import Sequence

import torch

from repro_torch.kernels._cuda import CudaLibrary, int64_array, ptr

Tensor = torch.Tensor

_HERE = pathlib.Path(__file__).resolve().parent
_P = ctypes.c_void_p
_I = ctypes.c_int64

HEADER = _HERE / "csrc" / "hopper.cuh"
SMEM_LIMIT = 232_448        # dynamic shared memory a block may use (H100)
BOX_LIMIT = 256             # TMA: elements a box dimension
SWIZZLES = (32, 64, 128)    # bytes of a box's inner extent = its swizzle
MAP_SPEC_LEN = 13           # hop::kMapSpecLen

TILE_LIB = CudaLibrary(
    _HERE / "csrc" / "hopper_tile.cu",
    {"hopper_tile_bf16": [_P] * 3 + [ctypes.POINTER(_I)] * 2 + [_I] * 4
     + [_P]},
    headers=(HEADER,))
TILE_N = (16, 32, 64, 128, 200)   # the N instantiated in hopper.cuh
TILE_K = (16, 32, 64, 128)

__all__ = ["HEADER", "SMEM_LIMIT", "BOX_LIMIT", "TmaMap", "tma_map",
           "TILE_LIB", "TILE_N", "TILE_K", "tile_maps", "tile_product"]


@dataclasses.dataclass(frozen=True)
class TmaMap:
    """One bf16 tensor map: extents and boxes innermost first, the byte
    strides of dims 1.. (dim 0 is contiguous), the swizzle in bytes."""
    dims: tuple[int, ...]
    strides: tuple[int, ...]
    box: tuple[int, ...]
    swizzle: int
    elem_bytes: int = 2

    @property
    def rank(self) -> int:
        return len(self.dims)

    @property
    def box_bytes(self) -> int:
        """What one load of the box delivers (its out-of-bounds zeros
        included): the bytes its mbarrier expects."""
        return self.elem_bytes * math.prod(self.box)

    def spec(self) -> list[int]:
        """The ``hop::encode_map`` layout: rank, 4 extents, 3 strides, 4
        box extents (padded with 1), the swizzle."""
        pad = 4 - self.rank
        return [self.rank, *self.dims, *(1,) * pad,
                *self.strides, *(0,) * (3 - len(self.strides)),
                *self.box, *(1,) * pad, self.swizzle]


def tma_map(shape: Sequence[int], strides: Sequence[int],
            box: Sequence[int], elem_bytes: int = 2) -> TmaMap:
    """The map of a strided tensor: ``shape``, ``strides`` (elements) and
    ``box`` in PyTorch's order (outermost first), the last axis
    contiguous.  The swizzle is the box's inner extent in bytes."""
    if strides[-1] != 1:
        raise ValueError(f"a TMA map needs a contiguous last axis; strides "
                         f"{tuple(strides)}")
    swizzle = box[-1] * elem_bytes
    if swizzle not in SWIZZLES:
        raise ValueError(f"a box's inner extent must be 32, 64 or 128 "
                         f"bytes; got {swizzle}")
    return TmaMap(dims=tuple(int(x) for x in reversed(shape)),
                  strides=tuple(int(s) * elem_bytes
                                for s in reversed(strides[:-1])),
                  box=tuple(int(x) for x in reversed(box)),
                  swizzle=swizzle, elem_bytes=elem_bytes)


def tile_maps(n: int, k: int, b_mn_major: bool) -> tuple[TmaMap, TmaMap]:
    """The maps of the tile check: A (64, k) row-major; B (n, k) K-major
    or (k, n) MN-major, each boxed in bands of at most 64 elements."""
    a = tma_map((64, k), (k, 1), (64, min(k, 64)))
    if b_mn_major:
        b = tma_map((k, n), (n, 1), (k, min(n, 64)))
    else:
        b = tma_map((n, k), (k, 1), (n, min(k, 64)))
    return a, b


def tile_product(a: Tensor, b: Tensor, *, b_mn_major: bool,
                 a_in_regs: bool) -> Tensor:
    """C = A B (64 x N, float32) through one wgmma tile: ``a`` (64, K)
    bf16; ``b`` (N, K) when K-major (C = a b^T) or (K, N) when MN-major
    (C = a b); contiguous, on the card; K in TILE_K, N in TILE_N."""
    k = a.shape[1]
    n = b.shape[1] if b_mn_major else b.shape[0]
    if (a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16
            or a.shape[0] != 64 or k not in TILE_K or n not in TILE_N
            or b.shape != ((k, n) if b_mn_major else (n, k))
            or not (a.is_contiguous() and b.is_contiguous())
            or a.device.type != "cuda" or b.device != a.device):
        raise ValueError(f"the tile check takes contiguous bf16 a (64, K) "
                         f"and b on one card, K in {TILE_K}, N in {TILE_N}; "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}")
    a_map, b_map = tile_maps(n, k, b_mn_major)
    c = torch.empty((64, n), dtype=torch.float32, device=a.device)
    TILE_LIB.call("hopper_tile_bf16", a.device, ptr(a), ptr(b), ptr(c),
                  int64_array(a_map.spec()), int64_array(b_map.spec()), n, k,
                  int(b_mn_major), int(a_in_regs))
    return c
