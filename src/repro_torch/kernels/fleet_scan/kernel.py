"""Bind and launch the hand-written CUDA fleet scan.

``csrc/fleet_scan.cu`` runs the reference's per-query outage-mask and
autoscaler recurrences (`repro.core.faults.fault_scan`,
`repro.launch.elastic.autoscale_scan`, both `lax.scan`s; no Pallas
kernel) as one launch per chunk: a block a scenario, three warps in a
pipeline over tiles of 32 queries (the MTBF/MTTR chain; the windows, up
bytes and the controller's operands; the controller's serial step).  It
is built by `repro_torch.kernels._cuda.CudaLibrary` at first
use.  ``launches`` counts the launches this process made.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Any, Optional

import torch

from repro_torch.kernels._cuda import CudaLibrary, ptr

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int64

LIB = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "fleet_scan.cu",
    {name: [_P] * 19 + [_I] * 4
     + [ctypes.POINTER(_I), _I, ctypes.POINTER(ctypes.c_double), _I, _P]
     for name in ("fleet_scan_f32", "fleet_scan_f64")})
MAX_REPLICAS = 16       # kMaxReplicas: lanes of a warp that carry a replica
MAX_WINDOWS = 32        # kMaxWindows: outage windows a launch takes

__all__ = ["LIB", "MAX_REPLICAS", "MAX_WINDOWS", "fleet_args",
           "fleet_scan_cuda"]

launches = 0          # kernel launches in this process

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def fleet_args(windows: tuple, mtbf: Optional[float], mttr: float,
               policy: Any, p: int, upf_mode: int
               ) -> tuple[list[int], list[float]]:
    """The spec as the C entry point reads it: (iargs, fargs).

    iargs: windows, mtbf_on, policy_on, upf_mode (0 none, 1 the mask's
    count, 2 an input), p, min_r, max_r, up step, down step,
    stabilization intervals, trigger_on, then each window's replica;
    fargs: MTBF, MTTR, target, interval, trigger, then the windows'
    starts, then their ends."""
    if len(windows) > MAX_WINDOWS:
        raise ValueError(f"the CUDA fleet scan takes up to {MAX_WINDOWS} "
                         f"outage windows; got {len(windows)}")
    pol = policy
    trigger = None if pol is None else pol.queue_trigger_seconds
    iargs = [len(windows), int(mtbf is not None), int(pol is not None),
             upf_mode, int(p)]
    iargs += ([0] * 6 if pol is None else
              [int(pol.min_r), int(pol.max_r), int(pol.scale_up_step),
               int(pol.scale_down_step), int(pol.stabilization_intervals),
               int(trigger is not None)])
    iargs += [int(rep) for rep, _, _ in windows]
    fargs = [0.0 if mtbf is None else float(mtbf), float(mttr)]
    fargs += ([0.0] * 3 if pol is None else
              [float(pol.target_utilization),
               float(pol.decision_interval_seconds),
               0.0 if trigger is None else float(trigger)])
    fargs += [float(s) for _, s, _ in windows]
    fargs += [float(e) for _, _, e in windows]
    return iargs, fargs


def fleet_scan_cuda(gaps: Tensor, *, n_valid: int, t_arr: Optional[Tensor],
                    u: Optional[Tensor], demand: Optional[Tensor],
                    up_frac: Optional[Tensor], up_state: Optional[Tensor],
                    as_state: Optional[tuple], windows: tuple,
                    mtbf: Optional[float], mttr: float, policy: Any, p: int,
                    r: int):
    """Launch the fleet scan; returns (up (S, n, r) bool or None, n_act
    (S, n) int32 or None, the chain's state, the controller's state), as
    `ref.fleet_scan_ref`.  ``windows`` hold replica indices already
    reduced mod r.  Every tensor is contiguous on one CUDA device, floats
    of ``gaps``' dtype; raises on anything the kernel does not take: no
    conversion, no fallback."""
    global launches
    outage = bool(windows) or mtbf is not None
    need = {"gaps": gaps}
    if windows:
        need["t_arr"] = t_arr
    if mtbf is not None:
        need["u"] = u
        need["up_state"] = up_state
    if policy is not None:
        need["demand"] = demand
        n_c, te, we, st, bk = as_state
        need.update(n=n_c, te=te, we=we, stab=st, bk=bk)
    if up_frac is not None:
        need["up_frac"] = up_frac
    missing = [k for k, t in need.items() if t is None]
    if missing:
        raise ValueError(f"the fleet scan needs {missing}")
    tensors = list(need.values())
    if any(t.device.type != "cuda" or t.device != gaps.device
           for t in tensors):
        raise ValueError("the CUDA fleet scan needs CUDA tensors on one "
                         f"device; got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA fleet scan needs contiguous tensors")
    if gaps.dtype not in _SUFFIX:
        raise TypeError(f"the CUDA fleet scan takes float32 or float64; "
                        f"got {gaps.dtype}")
    floats = [need[k] for k in ("t_arr", "u", "demand", "up_frac", "te",
                                "we", "bk") if k in need]
    ints = [need[k] for k in ("up_state", "n", "stab") if k in need]
    if (any(t.dtype != gaps.dtype for t in floats)
            or any(t.dtype != torch.int32 for t in ints)):
        raise TypeError("the fleet scan's float inputs share gaps' dtype "
                        "and its integer carries are int32")
    if not 1 <= r <= MAX_REPLICAS:
        raise ValueError(f"the CUDA fleet scan takes 1..{MAX_REPLICAS} "
                         f"replicas; got r={r}")
    n_scen, n = gaps.shape
    shapes = {"t_arr": (n_scen, n), "u": (n_scen, n, r),
              "demand": (n_scen, n), "up_frac": (n_scen, n),
              "up_state": (n_scen, r), "n": (n_scen,), "te": (n_scen,),
              "we": (n_scen,), "stab": (n_scen,), "bk": (n_scen,)}
    bad = {k: tuple(need[k].shape) for k in shapes
           if k in need and tuple(need[k].shape) != shapes[k]}
    if bad:
        raise ValueError(f"shapes disagree with gaps {tuple(gaps.shape)} "
                         f"and r={r}: {bad}")
    upf_mode = 2 if up_frac is not None else (
        1 if outage and policy is not None else 0)
    iargs, fargs = fleet_args(windows, mtbf, mttr, policy, p, upf_mode)
    dev = gaps.device
    up = (torch.empty((n_scen, n, r), dtype=torch.bool, device=dev)
          if outage else None)
    n_act = chain_out = None
    new_as = None
    if policy is not None:
        n_act = torch.empty((n_scen, n), dtype=torch.int32, device=dev)
        new_as = tuple(torch.empty_like(t) for t in as_state)
    if mtbf is not None:
        chain_out = torch.empty_like(up_state)
    c_as = (None,) * 5 if policy is None else as_state
    o_as = (None,) * 5 if new_as is None else new_as
    LIB.call(f"fleet_scan_{_SUFFIX[gaps.dtype]}", dev, ptr(gaps),
             ptr(t_arr if windows else None),
             ptr(u if mtbf is not None else None),
             ptr(demand if policy is not None else None), ptr(up_frac),
             ptr(up_state if mtbf is not None else None),
             *(ptr(t) for t in c_as), ptr(up), ptr(n_act), ptr(chain_out),
             *(ptr(t) for t in o_as), n_scen, n, r, int(n_valid),
             (_I * len(iargs))(*iargs), len(iargs),
             (ctypes.c_double * len(fargs))(*fargs), len(fargs))
    launches += 1
    return (up, n_act, up_state if chain_out is None else chain_out,
            new_as)
