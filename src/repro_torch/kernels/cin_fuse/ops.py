"""Public wrapper for one fused CIN layer.

``impl`` picks the path: ``"cuda"`` launches the hand-written kernel
(`repro_torch.kernels.cin_fuse.kernel`), ``"torch"`` runs the plain
version (`ref`), and ``"auto"`` takes the kernel for a CUDA tensor and the
plain version for a CPU tensor.  A CUDA tensor under ``"auto"`` or
``"cuda"`` launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._cuda import resolve_impl
from repro_torch.kernels.cin_fuse import kernel, ref

Tensor = torch.Tensor

__all__ = ["cin_layer", "launch_count", "plain_count", "reset_counts"]

plain_calls = 0       # calls that took the plain version, this process


def launch_count() -> int:
    """CIN kernel launches made by this process so far."""
    return kernel.launches


def plain_count() -> int:
    """Calls that ran the plain version instead of the kernel."""
    return plain_calls


def reset_counts() -> None:
    global plain_calls
    kernel.launches = 0
    plain_calls = 0


def cin_layer(xk: Tensor, x0: Tensor, w: Tensor, *,
              impl: str = "auto") -> Tensor:
    """y[b, o, d] = sum_{h, j} xk[b, h, d] x0[b, j, d] w[h m + j, o]:
    xk (B, Hk, D), x0 (B, m, D), w (Hk*m, O) -> (B, O, D) in xk's dtype."""
    global plain_calls
    if resolve_impl(impl, xk.device, what="CIN") == "cuda":
        return kernel.cin_layer_cuda(xk, x0, w)
    plain_calls += 1
    return ref.cin_layer_ref(xk, x0, w)
