"""Train-step builder: loss -> gradients -> (compressed) update, with
gradient accumulation over microbatches.

PyTorch port of `repro.train.trainer`.  ``params`` is an `nn.Module` (or
a name -> tensor map of leaf tensors); `TrainStep.init_state` turns on
``requires_grad`` for every parameter it trains, and a call updates them
**in place** under ``torch.no_grad()`` (the reference returns new
params), returning ``(params, state, loss)``.  With ``microbatches = n``
the batch's leading axis splits n ways, in order, as the reference's
reshape to (n, B / n, ...); each microbatch's gradients are added into
float32 accumulators and divided by n, as its ``lax.scan`` does.  The
loss comes back as a 0-dim tensor on the parameters' device: a step
never waits for the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.train.compression import Compressor
from repro_torch.train.optimizer import AdamW, named_tensors

Tensor = torch.Tensor

__all__ = ["TrainStep"]


@dataclasses.dataclass(frozen=True)
class TrainStep:
    loss_fn: Callable            # (params, batch) -> 0-dim loss
    optimizer: object = None     # AdamW-like; default AdamW()
    microbatches: int = 1
    compressor: Optional[Compressor] = None

    def _optimizer(self):
        return self.optimizer or AdamW()

    def _compressing(self) -> bool:
        return self.compressor is not None and self.compressor.mode != "none"

    def init_state(self, params) -> dict:
        """{"opt": the optimizer's state[, "residual": the compressor's]};
        turns on gradients for every parameter of ``params``."""
        named = named_tensors(params)
        for p in named.values():
            p.requires_grad_(True)
        state = {"opt": self._optimizer().init(named)}
        if self._compressing():
            state["residual"] = self.compressor.init(named)
        return state

    def _value_and_grad(self, params, named: dict, batch):
        with torch.enable_grad():
            loss = self.loss_fn(params, batch)
            grads = torch.autograd.grad(loss, list(named.values()))
        return loss.detach(), dict(zip(named, grads))

    def __call__(self, params, state: dict, batch: dict):
        """One optimizer step on ``batch``, a dict of tensors whose
        leading axis splits into the microbatches."""
        named = named_tensors(params)
        n = self.microbatches
        if n == 1:
            loss, grads = self._value_and_grad(params, named, batch)
        else:
            def split(x: Tensor) -> Tensor:
                if x.shape[0] % n:
                    raise ValueError(f"batch axis {x.shape[0]} does not "
                                     f"split into {n} microbatches")
                return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
            parts = {k: split(x) for k, x in batch.items()}
            loss = None
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in named.items()}
            for i in range(n):
                loss_i, g = self._value_and_grad(
                    params, named, {k: x[i] for k, x in parts.items()})
                loss = loss_i.float() if loss is None else loss + loss_i
                for k, acc in grads.items():
                    acc.add_(g[k])
                del g
            loss = loss / n
            for acc in grads.values():
                acc.div_(n)

        new_state = dict(state)
        if self._compressing():
            grads, new_state["residual"] = self.compressor.compress(
                grads, state["residual"])
        _, new_state["opt"] = self._optimizer().update(
            grads, state["opt"], named)
        return params, new_state, loss
