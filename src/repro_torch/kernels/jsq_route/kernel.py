"""Bind and launch the hand-written CUDA join-shortest-queue router.

``csrc/jsq_route.cu`` runs the reference's per-query JSQ recurrence
(`repro.core.simulator._jsq_route`, a `lax.scan`; no Pallas kernel) as one
launch per chunk, on one carried maximum per replica.  Its launch plan
(tracker in registers or in shared memory, tile width, shared bytes) is
`jsq_plan`, pure Python so that the CPU tests reach it.  Past 16
replicas the wide instance carries ceil(r / 32) maxima a lane.  With the
autoscaler's active counts and the fault injector's up mask it takes
replicas out of the argmin (the `MASKED` instances).  It is built by
`repro_torch.kernels._cuda.CudaLibrary` at first use.  ``launches``
counts the launches this process made.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib
from typing import Optional

import torch

from repro_torch.kernels._cuda import CudaLibrary, int64_array, ptr
from repro_torch.kernels.hopper import SMEM_LIMIT

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int64

LIB = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "jsq_route.cu",
    {name: [_P] * 10 + [_I] * 4 + [ctypes.POINTER(_I), _I, _P]
     for name in ("jsq_route_f32", "jsq_route_f64")})
MAX_REPLICAS = 256                 # the wide instance: kMaxRpl x 32
NARROW_REPLICAS = 16               # the largest KC bucket in the source
KC_BUCKETS = (2, 4, 8, 16)         # replicas a lane carries (>= r)
PER_BUCKETS = (1, 2, 4, 8, 16)     # servers of each replica a lane holds
REG_BUDGET = 64                    # kRegBudget: 32-bit registers a lane
                                   # gives the tracker
TILES = (32, 16, 8, 4, 2, 1)       # queries a staged tile, widest first

__all__ = ["LIB", "MAX_REPLICAS", "JsqPlan", "jsq_plan", "jsq_route_cuda",
           "up_words"]

launches = 0          # kernel launches in this process

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@dataclasses.dataclass(frozen=True)
class JsqPlan:
    """How the kernel covers one chunk: a one-warp block a scenario, lane
    l the servers l, l + 32, ... (``per`` of each replica).
    ``registers``: the tracker lies in registers (``kc`` >= r carried
    replicas), else in shared memory.  Services, gaps and live are staged
    ``tile`` queries at a time, double-buffered, in rows of tile + 1
    (and, with the tracker in registers, the choices of a tile as
    int32).  ``masked``: the instances that read an active count and a
    word of up bits a query, staged with the tile (4 x tile int32 more).
    ``wide`` (r > 16): the tracker in shared memory, lane l the maxima
    of replicas l, l + 32, ... (``kc`` = 32 x ``words``), and a masked
    query's up bits in ``words`` int32."""
    registers: bool
    kc: int
    per: int
    tile: int
    smem_bytes: int
    masked: bool = False
    wide: bool = False

    @property
    def words(self) -> int:
        """int32 words of up bits a query."""
        return self.kc // 32 if self.wide else 1

    def servers(self, lane: int, p: int) -> list[int]:
        """The servers (of every replica) lane ``lane`` holds."""
        return [j for j in range(lane, 32 * self.per, 32) if j < p]

    @functools.cached_property
    def args(self) -> ctypes.Array:
        """The plan as the C entry point reads it (kPlanLen int64)."""
        variant = 2 if self.wide else (0 if self.registers else 1)
        return int64_array([variant, self.kc, self.per, self.tile,
                            self.smem_bytes, int(self.masked)])


def _bucket(x: int, buckets: tuple[int, ...]) -> int | None:
    return next((b for b in buckets if b >= x), None)


@functools.lru_cache(maxsize=256)
def jsq_plan(r: int, p: int, itemsize: int, masked: bool = False
             ) -> JsqPlan:
    """The plan for (r, p) in a float of ``itemsize`` bytes: the tracker
    in registers where KC x PER fits REG_BUDGET, else in shared memory
    (past 16 replicas, the wide instance's); the widest tile whose
    buffers (and, ``masked``, mask rows) fit a block's shared memory."""
    if not 1 <= r <= MAX_REPLICAS:
        raise ValueError(f"the CUDA JSQ router takes 1..{MAX_REPLICAS} "
                         f"replicas; got r={r}")
    if r > NARROW_REPLICAS:
        words = -(-r // 32)
        for tile in TILES:
            smem = ((r * p + 2 * (p + 2) * (tile + 1)) * itemsize
                    + 8 * (1 + words) * tile * masked)
            if smem <= SMEM_LIMIT:
                return JsqPlan(False, 32 * words, -(-p // 32), tile, smem,
                               masked, wide=True)
        raise ValueError(
            f"r={r}, p={p} needs {smem} B of shared memory at a one-query "
            f"tile (the tracker alone {r * p * itemsize} B); a block has "
            f"{SMEM_LIMIT}")
    kc = _bucket(r, KC_BUCKETS)
    per = _bucket(-(-p // 32), PER_BUCKETS)
    if per is not None and kc * per * (itemsize // 4) <= REG_BUDGET:
        for tile in TILES:
            smem = (2 * (p + 2) * (tile + 1) * itemsize + 4 * tile
                    + 16 * tile * masked)
            if smem <= SMEM_LIMIT:
                return JsqPlan(True, kc, per, tile, smem, masked)
    per = -(-p // 32)
    for tile in TILES:
        smem = ((r * p + 2 * (p + 2) * (tile + 1)) * itemsize
                + 16 * tile * masked)
        if smem <= SMEM_LIMIT:
            return JsqPlan(False, kc, per, tile, smem, masked)
    raise ValueError(f"r={r}, p={p} needs {r * p * itemsize} B of shared "
                     f"memory for the tracker alone; a block has "
                     f"{SMEM_LIMIT}")


def up_words(up: Optional[Tensor], n_scen: int, n: int, words: int,
             device) -> Tensor:
    """(S, n, r) bool -> (S, n, words) int32, word q bit b replica 32 q +
    b (every bit set without a mask; bits past r are never read)."""
    if up is None:
        return torch.full((n_scen, n, words), -1, dtype=torch.int32,
                          device=device)
    r = up.shape[-1]
    pad = torch.nn.functional.pad(up.to(torch.int32), (0, 32 * words - r))
    shift = torch.arange(32, dtype=torch.int32, device=device)
    return (pad.view(n_scen, n, words, 32) << shift).sum(
        -1, dtype=torch.int32).contiguous()


def jsq_route_cuda(w: Tensor, gaps: Tensor, services: Tensor, live: Tensor,
                   n_act: Optional[Tensor] = None,
                   up: Optional[Tensor] = None):
    """Launch the router; returns (choice (S, n) int64, w_new (S, r, p)),
    plus (spill, unavail) (S, n) bool when ``up`` is given.

    w: (S, r, p); gaps, live: (S, n); services: (S, p, n); all contiguous
    CUDA tensors of one float dtype.  n_act: (S, n) int32 active counts;
    up: (S, n, r) bool up mask.  Either mask launches the masked
    instance (the other then takes every replica); the up mask goes to
    the kernel as ``plan.words`` int32 of bits a query (one up to 16
    replicas).  Raises on anything the
    kernel does not take: no conversion, no fallback.
    """
    global launches
    tensors = (w, gaps, services, live)
    masks = tuple(t for t in (n_act, up) if t is not None)
    if any(t.device.type != "cuda" or t.device != w.device
           for t in tensors + masks):
        raise ValueError("the CUDA JSQ router needs CUDA tensors on one "
                         f"device; got "
                         f"{[str(t.device) for t in tensors + masks]}")
    if w.dtype not in _SUFFIX or any(t.dtype != w.dtype for t in tensors):
        raise TypeError("the CUDA JSQ router takes float32 or float64 "
                        f"tensors of one dtype; got "
                        f"{[t.dtype for t in tensors]}")
    if w.ndim != 3 or gaps.ndim != 2:
        raise ValueError(f"w must be (S, r, p) and gaps (S, n); got "
                         f"{tuple(w.shape)} and {tuple(gaps.shape)}")
    n_scen, r, p = w.shape
    n = gaps.shape[1]
    if (gaps.shape != (n_scen, n) or live.shape != (n_scen, n)
            or services.shape != (n_scen, p, n)
            or (n_act is not None and n_act.shape != (n_scen, n))
            or (up is not None and up.shape != (n_scen, n, r))):
        raise ValueError(f"shapes disagree: w {tuple(w.shape)}, gaps "
                         f"{tuple(gaps.shape)}, services "
                         f"{tuple(services.shape)}, live "
                         f"{tuple(live.shape)}, n_act "
                         f"{None if n_act is None else tuple(n_act.shape)}"
                         f", up {None if up is None else tuple(up.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("w, gaps, services and live must be contiguous")
    if ((n_act is not None and n_act.dtype != torch.int32)
            or (up is not None and up.dtype != torch.bool)):
        raise TypeError("n_act must be int32 and up bool")
    masked = bool(masks)
    plan = jsq_plan(r, p, w.element_size(), masked)
    choice = torch.empty((n_scen, n), dtype=torch.int64, device=w.device)
    w_new = torch.empty_like(w)
    spill = unavail = bits = None
    if masked:
        if n_act is None:
            n_act = torch.full((n_scen, n), r, dtype=torch.int32,
                               device=w.device)
        if plan.wide:
            bits = up_words(up, n_scen, n, plan.words, w.device)
        elif up is None:
            bits = torch.full((n_scen, n), (1 << r) - 1, dtype=torch.int32,
                              device=w.device)
        else:
            shift = torch.arange(r, dtype=torch.int32, device=w.device)
            bits = (up.to(torch.int32) << shift).sum(-1, dtype=torch.int32)
        n_act = n_act.contiguous()
        spill = torch.empty((n_scen, n), dtype=torch.bool, device=w.device)
        unavail = torch.empty_like(spill)
    if n_scen == 0 or p == 0:
        choice.zero_()
        w_new.copy_(w)
        if up is None:
            return choice, w_new
        return choice, w_new, spill.zero_(), unavail.zero_()
    LIB.call(f"jsq_route_{_SUFFIX[w.dtype]}", w.device, ptr(w), ptr(gaps),
             ptr(services), ptr(live), ptr(n_act if masked else None),
             ptr(bits), ptr(choice), ptr(w_new), ptr(spill), ptr(unavail),
             n_scen, r, p, n, plan.args, len(plan.args))
    launches += 1
    if up is None:
        return choice, w_new
    return choice, w_new, spill, unavail
