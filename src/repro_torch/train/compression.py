"""Gradient compression for the data-parallel all-reduce, with error
feedback.

PyTorch port of `repro.train.compression`.  Compressing the gradients
(bf16, or int8 with a per-tensor scale) cuts the bytes the all-reduce
carries 2-4x; a biased compressor keeps the quantization residual
locally and adds it back next step (error feedback, Karimireddy et al.
2019), so training still converges.  Gradients and residuals are
name -> tensor maps (the port's optimizer states' layout); residuals are
float32.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

Tensor = torch.Tensor

__all__ = ["Compressor"]


@dataclasses.dataclass(frozen=True)
class Compressor:
    mode: str = "bf16"   # "none" | "bf16" | "int8"

    def init(self, grads: Mapping[str, Tensor]):
        if self.mode == "none":
            return ()
        return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for k, g in grads.items()}

    @torch.no_grad()
    def compress(self, grads: Mapping[str, Tensor], residual):
        """(compressed-then-decompressed grads, new residual).

        The grads returned are what the collective would carry, already
        dequantized for the optimizer, in each gradient's dtype; the
        residual holds the error to add back next step.
        """
        if self.mode == "none":
            return dict(grads), residual
        comp, res = {}, {}
        for k, g in grads.items():
            x = g.float() + residual[k]
            if self.mode == "bf16":
                q = x.to(torch.bfloat16).float()
            elif self.mode == "int8":
                scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
                q = torch.round(x / scale).clamp(-127, 127) * scale
            else:
                raise ValueError(self.mode)
            comp[k], res[k] = q.to(g.dtype), x - q
        return comp, res

    def wire_bytes_per_element(self) -> float:
        return {"none": 4.0, "bf16": 2.0, "int8": 1.0}[self.mode]
