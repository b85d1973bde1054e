"""Public wrapper for join-shortest-queue routing.

``impl`` picks the path: ``"cuda"`` launches the hand-written kernel
(`repro_torch.kernels.jsq_route.kernel`), ``"torch"`` runs the plain loop
(`ref.jsq_route_ref`), and ``"auto"`` takes the kernel for a CUDA tensor
and the plain loop for a CPU tensor.  A CUDA tensor under ``"auto"`` or
``"cuda"`` launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._cuda import resolve_impl
from repro_torch.kernels.jsq_route import kernel, ref

Tensor = torch.Tensor

__all__ = ["jsq_route", "launch_count", "reset_launch_count"]


def launch_count() -> int:
    """JSQ kernel launches made by this process so far."""
    return kernel.launches


def reset_launch_count() -> None:
    kernel.launches = 0


def jsq_route(w: Tensor, gaps: Tensor, services: Tensor, live: Tensor, *,
              n_act: Optional[Tensor] = None, up: Optional[Tensor] = None,
              impl: str = "auto"):
    """Route one chunk by join-shortest-queue on carried per-replica work.

    w: (S, r, p) remaining seconds per replica server at the previous
    arrival; gaps, live: (S, n); services: (S, p, n) (broadcast views are
    materialized for the kernel).  ``n_act`` (S, n) int32, the active
    replica count a query, and ``up`` (S, n, r) bool, the replica-up
    mask, take replicas out of the argmin (their trackers keep draining).
    Returns (choice (S, n) int64, the tracker after the chunk (S, r, p)),
    plus (spill, unavail) (S, n) bool when ``up`` is given.
    """
    if resolve_impl(impl, w.device) == "torch":
        return ref.jsq_route_ref(w, gaps, services, live, n_act=n_act, up=up)
    return kernel.jsq_route_cuda(
        w.contiguous(), gaps.contiguous(), services.contiguous(),
        live.contiguous(), n_act=n_act, up=up)
