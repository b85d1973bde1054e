"""Device meshes for scenario sharding and the engine's index servers.

PyTorch port of `repro.launch.mesh`.  A `DeviceMesh` is a tuple of
`torch.device`s laid out row-major over a shape with one name an axis;
the port's sharded paths (`core.sweep`'s ``mesh=``, `engine.distributed
.make_search_fn`) place shard d on ``mesh.devices[d]`` and gather the
pieces back themselves, so no collective library is involved.

The constructors are functions, and building a mesh touches no device
state beyond counting the visible CUDA devices.  A mesh may repeat a
device: ``make_sweep_mesh(devices=["cpu"] * 8)`` is the counterpart of
the reference's eight virtual host devices, and ``devices=["cuda:0"] * n``
runs an n-way split on one card, shard after shard.  Asking for more
CUDA devices than are visible raises, naming the count; nothing falls
back to fewer devices or to the CPU.

`make_production_mesh` gives the production meshes the dry run
(`repro_torch.launch.dryrun`) lays every cell out on: (16, 16) over
("data", "model"), or (2, 16, 16) with "pod" in front.  The dry run
passes ``devices=["meta"] * 256`` (or 512): its stand-ins allocate
nothing, so no machine needs that many cards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch._tensor import DeviceLike

__all__ = ["DeviceMesh", "make_production_mesh", "make_sweep_mesh",
           "make_mesh", "mesh_axes", "data_axes"]


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """``devices`` row-major over ``shape``, one name in ``axis_names``
    an axis."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} has "
                             f"{len(self.shape)} axes but names "
                             f"{self.axis_names}")
        if len(self.devices) != math.prod(self.shape):
            raise ValueError(f"mesh shape {self.shape} needs "
                             f"{math.prod(self.shape)} devices; got "
                             f"{len(self.devices)}")

    @property
    def size(self) -> int:
        return len(self.devices)


def _devices(n: Optional[int], devices: Optional[Sequence[DeviceLike]]
             ) -> tuple[torch.device, ...]:
    """The first ``n`` of ``devices`` (default: every visible CUDA device);
    raises when fewer are there."""
    if devices is None:
        count = torch.cuda.device_count()
        pool = tuple(torch.device("cuda", i) for i in range(count))
        what = f"{count} visible CUDA device{'s' * (count != 1)}"
    else:
        pool = tuple(torch.device(d) for d in devices)
        what = f"{len(pool)} given device{'s' * (len(pool) != 1)}"
    n = len(pool) if n is None else int(n)
    if n < 1:
        raise ValueError(f"a mesh needs at least one device; asked for {n}"
                         f" ({what})")
    if n > len(pool):
        raise ValueError(f"asked for a mesh of {n} devices but there are "
                         f"{what}")
    return pool[:n]


def make_sweep_mesh(n_devices: Optional[int] = None, *,
                    devices: Optional[Sequence[DeviceLike]] = None
                    ) -> DeviceMesh:
    """1-D ("scenario",) mesh for scenario-sharded what-if sweeps.

    The one mesh constructor of `core.sweep` and
    ``examples/torch_global_sweep.py``.  ``n_devices`` defaults to every
    visible CUDA device (or every entry of ``devices``); ``devices`` may
    name any devices, repeats included.
    """
    devs = _devices(n_devices, devices)
    return DeviceMesh(devs, (len(devs),), ("scenario",))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              devices: Optional[Sequence[DeviceLike]] = None
              ) -> DeviceMesh:
    """A mesh of ``shape`` over the first prod(shape) of ``devices``
    (default: the visible CUDA devices); e.g. the engine's
    ``make_mesh((8,), ("servers",))``."""
    shape = tuple(int(s) for s in shape)
    return DeviceMesh(_devices(math.prod(shape), devices), shape,
                      tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence[DeviceLike]] = None
                         ) -> DeviceMesh:
    """16 x 16 single-pod (256 chips) or 2 x 16 x 16 multi-pod (512
    chips), over the first 256 (512) of ``devices`` (default: the
    visible CUDA devices; fewer raise)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_mesh(shape, mesh_axes(multi_pod), devices=devices)


def mesh_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def data_axes(multi_pod: bool) -> tuple[str, ...]:
    """The data-parallel axes (replica dimension for DP batch sharding)."""
    return ("pod", "data") if multi_pod else ("data",)
