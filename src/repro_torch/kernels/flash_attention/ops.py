"""Public wrapper for GQA flash attention in the model's layout.

``impl`` picks the path: ``"cuda"`` launches the hand-written kernel
(`repro_torch.kernels.flash_attention.kernel`), ``"torch"`` runs the plain
version (`ref`), and ``"auto"`` takes the kernel for a CUDA tensor and the
plain version for a CPU tensor.  A CUDA tensor under ``"auto"`` or
``"cuda"`` launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._cuda import resolve_impl
from repro_torch.kernels.flash_attention import kernel, ref

Tensor = torch.Tensor

__all__ = ["flash_attention", "launch_count", "plain_count", "reset_counts"]

plain_calls = 0       # calls that took the plain version, this process


def launch_count() -> int:
    """Flash-attention kernel launches made by this process so far."""
    return kernel.launches


def plain_count() -> int:
    """Calls that ran the plain version instead of the kernel."""
    return plain_calls


def reset_counts() -> None:
    global plain_calls
    kernel.launches = 0
    plain_calls = 0


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    impl: str = "auto") -> Tensor:
    """Causal GQA attention: q (B, Sq, H, D), k/v (B, Sk, KV, D) ->
    (B, Sq, H, D) in q's dtype; H / KV query heads share each kv head.

    The model path passes ``causal=True`` with Sq == Sk; ``causal=False``
    and Sq != Sk are kept for parity with `flash_attention_pallas`, whose
    function this wrapper ports whole."""
    global plain_calls
    if resolve_impl(impl, q.device, what="attention") == "cuda":
        return kernel.flash_attention_cuda(q, k, v, causal=causal)
    plain_calls += 1
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    out = ref.flash_attention_ref(
        q.movedim(2, 1).reshape(b * h, sq, d),
        k.movedim(2, 1).reshape(b * kv, sk, d),
        v.movedim(2, 1).reshape(b * kv, sk, d), n_rep=h // kv, causal=causal)
    return out.reshape(b, h, sq, d).movedim(1, 2)
