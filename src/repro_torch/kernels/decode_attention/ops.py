"""Public wrapper for one-token GQA decode attention in the model's layout.

``impl`` picks the path: ``"cuda"`` launches the hand-written kernel
(`repro_torch.kernels.decode_attention.kernel`), ``"torch"`` runs the
plain version (`ref`), and ``"auto"`` takes the kernel for a CUDA tensor
and the plain version for a CPU tensor.  A CUDA tensor under ``"auto"`` or
``"cuda"`` launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._cuda import resolve_impl
from repro_torch.kernels.decode_attention import kernel, ref

Tensor = torch.Tensor

__all__ = ["decode_attention", "launch_count", "plain_count",
           "reset_counts"]

plain_calls = 0       # calls that took the plain version, this process


def launch_count() -> int:
    """Decode-attention kernel calls made by this process so far."""
    return kernel.launches


def plain_count() -> int:
    """Calls that ran the plain version instead of the kernel."""
    return plain_calls


def reset_counts() -> None:
    global plain_calls
    kernel.launches = 0
    plain_calls = 0


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     length: int, *, impl: str = "auto") -> Tensor:
    """q (B, 1, H, D) against k/v caches (B, S, KV, D) over positions
    0..``length`` (the last valid one, inclusive) -> (B, 1, H, D)."""
    global plain_calls
    if resolve_impl(impl, q.device, what="attention") == "cuda":
        return kernel.decode_attention_cuda(q, k_cache, v_cache, length)
    plain_calls += 1
    b, _, h, d = q.shape
    _, s, kv, _ = k_cache.shape
    out = ref.decode_attention_ref(
        q.reshape(b * kv, h // kv, d),
        k_cache.movedim(2, 1).reshape(b * kv, s, d),
        v_cache.movedim(2, 1).reshape(b * kv, s, d), length)
    return out.reshape(b, 1, h, d)
