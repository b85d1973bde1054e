"""Public wrapper for the fleet scan (replica-up masks and the
autoscaler's active count of one chunk).

``impl`` picks the path: ``"cuda"`` launches the hand-written kernel
(`repro_torch.kernels.fleet_scan.kernel`), ``"torch"`` runs the plain
loop (`ref.fleet_scan_ref`), and ``"auto"`` takes the kernel for a CUDA
tensor and the plain loop for a CPU tensor.  A CUDA tensor under
``"auto"`` or ``"cuda"`` launches the kernel or raises; nothing falls
back.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.kernels._cuda import resolve_impl
from repro_torch.kernels.fleet_scan import kernel, ref

Tensor = torch.Tensor

__all__ = ["fleet_scan", "launch_count", "reset_launch_count"]


def launch_count() -> int:
    """Fleet-scan kernel launches made by this process so far."""
    return kernel.launches


def reset_launch_count() -> None:
    kernel.launches = 0


def fleet_scan(gaps: Tensor, *, n_valid: Optional[int] = None,
               t_arr: Optional[Tensor] = None, u: Optional[Tensor] = None,
               demand: Optional[Tensor] = None,
               up_frac: Optional[Tensor] = None,
               up_state: Optional[Tensor] = None,
               as_state: Optional[tuple] = None, fault: Any = None,
               policy: Any = None, p: int = 1, r: int = 1,
               impl: str = "auto"):
    """One chunk of the fleet's recurrences.

    gaps: (S, n) interarrival seconds.  ``fault`` (a `FaultSpec`, or
    None) asks for the replica-up mask (S, n, r): its outage windows read
    ``t_arr`` (S, n) absolute arrival times, its MTBF/MTTR chain ``u``
    (S, n, r) uniforms and the chain's carried state ``up_state`` (S, r)
    int32.  ``policy`` (an `AutoscalePolicy`, or None) asks for the
    active count (S, n) int32 from ``demand`` (S, n) server-seconds a
    query, the p-server fork and the controller's carried five-value
    state ``as_state``; queries from ``n_valid`` on advance it by
    nothing.  With a mask the controller sees the up fraction (the
    mask's count over r); ``up_frac`` (S, n) overrides it.

    Returns ``(up or None, n_act or None, up_state, as_state)``.
    """
    windows = ()
    mtbf, mttr = None, 60.0
    if fault is None:
        r = 1                       # no mask: the replica count is unused
    else:
        windows = tuple((int(i) % r, float(s), float(e))
                        for i, s, e in fault.outages)
        mtbf, mttr = fault.mtbf_seconds, float(fault.mttr_seconds)
    n_valid = gaps.shape[-1] if n_valid is None else int(n_valid)
    kw = dict(n_valid=n_valid, t_arr=t_arr, u=u, demand=demand,
              up_frac=up_frac, up_state=up_state, as_state=as_state,
              windows=windows, mtbf=mtbf, mttr=mttr, policy=policy, p=p,
              r=r)
    if resolve_impl(impl, gaps.device) == "torch":
        return ref.fleet_scan_ref(gaps, **kw)

    def c(t):
        return None if t is None else t.contiguous()
    kw.update(t_arr=c(t_arr), u=c(u), demand=c(demand), up_frac=c(up_frac),
              up_state=c(up_state),
              as_state=None if as_state is None else tuple(
                  c(t) for t in as_state))
    return kernel.fleet_scan_cuda(gaps.contiguous(), **kw)
