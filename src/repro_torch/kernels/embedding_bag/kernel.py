"""Bind and launch the hand-written CUDA EmbeddingBag kernel.

``csrc/embedding_bag.cu`` replaces the Pallas TPU kernel
`repro.kernels.embedding_bag.kernel.embedding_bag_pallas`.  It takes the
model op's arguments (a mask, not counts), never uses a masked entry's id
and never gathers its row.  Built by `repro_torch.kernels._cuda
.CudaLibrary` at first use; ``launches`` counts the launches this process
made.  `bag_plan` picks, in Python, what the launch depends on: the width
of the unit a lane loads from a row, and whether a bag's mask and ids come
in vector loads.

`embedding_bag_cuda` is the custom operator
``repro_torch::embedding_bag``: a fake gives its output's shape (no FLOP
formula: gathers and sums, which `FlopCounterMode` counts nowhere), so a
trace on fake tensors (`repro_torch.launch.dryrun`) and
``FlopCounterMode`` on the card see the kernel.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import NamedTuple

import torch

from repro_torch.kernels._cuda import CudaLibrary, ptr

Tensor = torch.Tensor

_HERE = pathlib.Path(__file__).resolve().parent
_P = ctypes.c_void_p
_I = ctypes.c_int64

LIB = CudaLibrary(
    _HERE / "csrc" / "embedding_bag.cu",
    {name: [_P] * 4 + [_I] * 7 + [_P]
     for name in ("embedding_bag_f32", "embedding_bag_bf16")})

__all__ = ["LIB", "BagPlan", "bag_plan", "embedding_bag_cuda"]

launches = 0          # kernel launches in this process

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ID_BYTES = {torch.int32: 4, torch.int64: 8}


class BagPlan(NamedTuple):
    unit_bytes: int   # a lane's load from a row: 16, 8, 4 or 2 bytes
    vec4: bool        # M = 4: the mask in one 4-byte load, ids in 16-byte


def bag_plan(table: Tensor, ids: Tensor, mask: Tensor) -> BagPlan:
    """The widest unit, up to 16 bytes, that divides a row of ``table``
    and its start (so every row and output row is aligned to it), and
    whether a bag's M = 4 mask bytes and ids can be read as vectors."""
    el = table.element_size()
    row_bytes = table.shape[-1] * el
    unit = 16
    while unit > el and (row_bytes % unit or table.data_ptr() % unit):
        unit //= 2
    vec4 = (ids.shape[-1] == 4 and mask.data_ptr() % 4 == 0
            and ids.data_ptr() % 16 == 0)
    return BagPlan(unit, vec4)


@torch.library.custom_op("repro_torch::embedding_bag", mutates_args=())
def embedding_bag_cuda(table: Tensor, ids: Tensor, mask: Tensor) -> Tensor:
    """Launch the kernel: table (R, D), ids (..., M), mask (..., M) ->
    (..., D) in the table's dtype.

    The table float32 or bfloat16, ids int32 or int64, the mask bool or
    uint8; all contiguous, on one CUDA device.  Raises on anything else: no
    conversion, no fallback.
    """
    global launches
    tensors = {"table": table, "ids": ids, "mask": mask}
    if any(t.device.type != "cuda" or t.device != table.device
           for t in tensors.values()):
        raise ValueError("the CUDA embedding bag needs CUDA tensors on one "
                         "device; got "
                         f"{[str(t.device) for t in tensors.values()]}")
    if (table.dtype not in _SUFFIX or ids.dtype not in _ID_BYTES
            or mask.dtype not in (torch.bool, torch.uint8)):
        raise TypeError("the CUDA embedding bag takes a float32 or bfloat16 "
                        "table, int32 or int64 ids and a bool or uint8 mask; "
                        f"got {table.dtype}, {ids.dtype}, {mask.dtype}")
    if table.ndim != 2 or ids.ndim < 1 or mask.shape != ids.shape:
        raise ValueError(f"the table must be (R, D) and ids and mask of one "
                         f"shape (..., M); got {tuple(table.shape)}, "
                         f"{tuple(ids.shape)}, {tuple(mask.shape)}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"the CUDA embedding bag needs a contiguous "
                             f"{name} (strides {t.stride()})")
    rows, dim = table.shape
    bag = ids.shape[-1]
    out = torch.empty((*ids.shape[:-1], dim), dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0:
        return out
    n_bags = out.numel() // dim
    plan = bag_plan(table, ids, mask)
    LIB.call(f"embedding_bag_{_SUFFIX[table.dtype]}", table.device,
             ptr(table), ptr(ids), ptr(mask), ptr(out), n_bags, bag, dim,
             rows, _ID_BYTES[ids.dtype], plan.unit_bytes, int(plan.vec4))
    launches += 1
    return out


@embedding_bag_cuda.register_fake
def _(table: Tensor, ids: Tensor, mask: Tensor) -> Tensor:
    return table.new_empty((*ids.shape[:-1], table.shape[1]))
