"""Carry parameters, load and random numbers across from numpy.

A simulator has no weights; what a run is made of is its server
parameters, its arrival process and its random draws.  These functions
build the port's objects from numpy arrays — never from a `repro`
object — so that a test can hand both packages the same parameters, the
same load and the same random numbers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike, from_host
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.queueing import ServerParams

__all__ = ["server_params_from_numpy", "arrival_process_from_numpy",
           "draws_from_numpy"]


def server_params_from_numpy(fields: dict, *,
                             device: DeviceLike = DEFAULT_DEVICE,
                             dtype: torch.dtype = torch.float32
                             ) -> ServerParams:
    """ServerParams from a dict of numpy arrays (or numbers) by field name.

    Floating fields become ``dtype``; an integer ``p`` stays integer.
    """
    return ServerParams(**{k: from_host(v, device, dtype)
                           for k, v in fields.items()})


def arrival_process_from_numpy(rates, bin_seconds,
                               trace_gaps: Optional[np.ndarray] = None, *,
                               device: DeviceLike = DEFAULT_DEVICE,
                               dtype: torch.dtype = torch.float32
                               ) -> ArrivalProcess:
    """ArrivalProcess from its three arrays (rates (..., n_bins), the bin
    width, and optional trace gaps)."""
    return ArrivalProcess(
        rates=from_host(rates, device, dtype),
        bin_seconds=from_host(bin_seconds, device, dtype),
        trace_gaps=(None if trace_gaps is None
                    else from_host(trace_gaps, device, dtype)))


def draws_from_numpy(per_chunk: Sequence[tuple], *,
                     device: DeviceLike = DEFAULT_DEVICE,
                     dtype: torch.dtype = torch.float32):
    """A ``draws=`` callable serving precomputed per-chunk draws.

    ``per_chunk[c]`` is (u_gaps (S, chunk) or None, u_broker (S, chunk),
    services (S, p, chunk)) for chunk c, as numpy arrays, optionally
    followed by a dict of side streams (``"route"`` int replica indices,
    ``"cache_hit"`` bool, ``"cache_unit"``, ``"tap"``; each (S, chunk); see
    `repro_torch.core.simulator.chunk_side_draws`).  Everything is moved
    to ``device`` once, up front: floating arrays in ``dtype``, integer
    and bool arrays as they are.
    """
    def move(x):
        return None if x is None else from_host(x, device, dtype)

    chunks = []
    for entry in per_chunk:
        base = tuple(move(x) for x in entry[:3])
        if len(entry) > 3:
            base += ({k: move(v) for k, v in entry[3].items()},)
        chunks.append(base)

    def draws(chunk_idx: int):
        return chunks[chunk_idx]
    return draws
