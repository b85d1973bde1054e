"""Device and dtype resolution shared by the port's entry points.

The JAX reference leans on weak typing: a Python float adopts the dtype
of the array it meets.  Here a Python number becomes a tensor of the
call's dtype — the first floating tensor argument's, else the ``dtype=``
the caller passed, else float32 — on the call's device — the first
tensor argument's, else ``device=``, else ``cuda``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]

DEFAULT_DEVICE = "cuda"


def _leaves(xs):
    for x in xs:
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            yield from _leaves(getattr(x, f.name)
                               for f in dataclasses.fields(x))
        else:
            yield x


def resolve(*xs: Any, device: DeviceLike = None,
            dtype: Optional[torch.dtype] = None
            ) -> tuple[torch.device, torch.dtype]:
    """(device, dtype) for a call over ``xs`` (dataclasses are walked)."""
    tensors = [x for x in _leaves(xs) if isinstance(x, torch.Tensor)]
    if device is None:
        device = tensors[0].device if tensors else DEFAULT_DEVICE
    if dtype is None:
        floats = [t.dtype for t in tensors if t.is_floating_point()]
        dtype = floats[0] if floats else torch.float32
    return torch.device(device), dtype


def as_tensor(x: Any, device: torch.device, dtype: torch.dtype
              ) -> torch.Tensor:
    """For formulas: a tensor keeps its own dtype (moved to ``device``),
    as a JAX array does; a number or array becomes ``dtype``.  A Python
    number is filled on the device: copying it from the host would wait
    for the device's queue on the card."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (int, float)):
        return torch.full((), x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def from_host(x: Any, device: DeviceLike, dtype: torch.dtype
              ) -> torch.Tensor:
    """For a run's inputs: a tensor on ``device`` whose floating values are
    ``dtype``; integers stay integers.  Numbers and arrays pass through a
    float64 numpy copy, so a float64 run receives them unrounded."""
    t = (x.to(device) if isinstance(x, torch.Tensor)
         else torch.as_tensor(np.array(x), device=device))
    return t.to(dtype) if t.is_floating_point() else t
