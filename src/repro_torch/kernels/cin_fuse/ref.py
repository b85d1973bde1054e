"""Plain PyTorch version of the CIN layer (the reference's oracle,
`repro.kernels.cin_fuse.ref.cin_layer_ref`, ported).

The outer product is formed in the input dtype, as the Pallas kernel forms
it, and the contraction with W runs in float32 (float64 for float64 inputs); the
result is cast back to the input dtype.  It materializes (B, Hk, m, D): keep B small.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def cin_layer_ref(xk: Tensor, x0: Tensor, w: Tensor) -> Tensor:
    """xk (B, Hk, D), x0 (B, m, D), w (Hk*m, O) -> (B, O, D)."""
    hk, m = xk.shape[1], x0.shape[1]
    outer = xk[:, :, None, :] * x0[:, None, :, :]          # (B, Hk, m, D)
    acc = torch.float64 if xk.dtype == torch.float64 else torch.float32
    y = torch.einsum("bhmd,hmo->bod", outer.to(acc),
                     w.to(acc).reshape(hk, m, -1))
    return y.to(xk.dtype)
