"""Optimizers: AdamW, SGD with momentum, cosine schedule, global-norm
clipping.

PyTorch port of `repro.train.optimizer`.  Where the reference's states
are pytrees mirroring the parameter tree, the port's map parameter
names (`nn.Module.named_parameters`) to tensors: float32 moments for
parameters of any dtype (the mixed-precision layout).  ``update`` takes
the gradients, the state and the parameters as such name -> tensor maps
(an `nn.Module` is read through its ``named_parameters``), writes the
new values into the parameters **in place** (the reference returns new
ones) and returns ``(params, new_state)``; the moments are updated in
place too.  The update is computed in float32 and cast back to each
parameter's dtype, in the reference's order: clip, moments, bias
corrections, decoupled weight decay.

The step counter is a 0-dim int32 tensor on the parameters' device and
a schedule maps it to a 0-dim float32 tensor there, so a step never
waits for the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, NamedTuple, Union

import torch
from torch import nn

Tensor = torch.Tensor
Named = Mapping[str, Tensor]

__all__ = ["AdamW", "AdamWState", "SGD", "SGDState", "clip_by_global_norm",
           "cosine_schedule", "named_tensors"]


def named_tensors(params: Union[nn.Module, Named]) -> dict:
    """name -> tensor of a module's parameters, or of a mapping as is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _step0(named: dict) -> Tensor:
    device = next(iter(named.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def _zeros(named: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named.items()}


def _lr(lr, step: Tensor):
    return lr(step) if callable(lr) else lr


class AdamWState(NamedTuple):
    step: Tensor            # 0-dim int32
    m: dict                 # name -> float32 first moment
    v: dict                 # name -> float32 second moment


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[Tensor], Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        named = named_tensors(params)
        return AdamWState(step=_step0(named), m=_zeros(named),
                          v=_zeros(named))

    @torch.no_grad()
    def update(self, grads: Named, state: AdamWState, params):
        named = named_tensors(params)
        grads = clip_by_global_norm(grads, self.clip_norm)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        t = step.float()
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        lr = _lr(self.lr, step)
        for k, p in named.items():
            g = grads[k].float()
            m = state.m[k].mul_(b1).add_((1 - b1) * g)
            v = state.v[k].mul_(b2).add_((1 - b2) * g.square())
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p32 = p.float()
            u = u + self.weight_decay * p32
            p.copy_(p32 - lr * u)
        return params, AdamWState(step=step, m=state.m, v=state.v)


class SGDState(NamedTuple):
    step: Tensor            # 0-dim int32
    momentum: dict          # name -> float32 momentum


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: Union[Callable[[Tensor], Tensor], float] = 1e-2
    momentum: float = 0.9
    clip_norm: float = 1.0

    def init(self, params) -> SGDState:
        named = named_tensors(params)
        return SGDState(step=_step0(named), momentum=_zeros(named))

    @torch.no_grad()
    def update(self, grads: Named, state: SGDState, params):
        named = named_tensors(params)
        grads = clip_by_global_norm(grads, self.clip_norm)
        step = state.step + 1
        lr = _lr(self.lr, step)
        for k, p in named.items():
            mom = state.momentum[k].mul_(self.momentum).add_(
                grads[k].float())
            p.copy_(p.float() - lr * mom)
        return params, SGDState(step=step, momentum=state.momentum)


@torch.no_grad()
def clip_by_global_norm(grads: Named, max_norm: float) -> dict:
    """Scale every gradient by min(1, max_norm / global L2 norm), the norm
    summed in float32; each keeps its dtype.  ``max_norm <= 0``: as is."""
    grads = dict(grads)
    if max_norm <= 0:
        return grads
    sq = sum(g.float().square().sum() for g in grads.values())
    scale = torch.clamp(max_norm / torch.clamp_min(torch.sqrt(sq), 1e-9),
                        max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[Tensor], Tensor]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    down to ``min_frac * base_lr`` at ``total``; step -> 0-dim float32,
    on the step's device."""
    def lr(step: Tensor) -> Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr
