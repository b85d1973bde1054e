"""Public wrapper for EmbeddingBag with the model op's signature.

``impl`` picks the path: ``"cuda"`` launches the hand-written kernel
(`repro_torch.kernels.embedding_bag.kernel`), ``"torch"`` runs the plain
version (`ref.embedding_bag_masked`), and ``"auto"`` takes the kernel for
a CUDA tensor and the plain version for a CPU tensor.  A CUDA tensor under
``"auto"`` or ``"cuda"`` launches the kernel or raises; nothing falls
back.

Where gradients are wanted (grad mode on and the table requires one),
``"auto"`` and ``"cuda"`` go through `autograd.BagFunction`: the same
forward, and a plain-PyTorch backward written out by hand;
``"torch"`` leaves the plain version to autograd.  Serving (no grad)
calls the forward directly, one launch a call.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._cuda import resolve_impl
from repro_torch.kernels.embedding_bag import kernel, ref
from repro_torch.kernels.embedding_bag.autograd import BagFunction

Tensor = torch.Tensor

__all__ = ["embedding_bag", "launch_count", "plain_count", "reset_counts"]

plain_calls = 0       # calls that took the plain version, this process


def launch_count() -> int:
    """Embedding-bag kernel launches made by this process so far."""
    return kernel.launches


def plain_count() -> int:
    """Calls that ran the plain version instead of the kernel."""
    return plain_calls


def reset_counts() -> None:
    global plain_calls
    kernel.launches = 0
    plain_calls = 0


def embedding_bag(table: Tensor, ids: Tensor, mask: Tensor, *,
                  impl: str = "auto") -> Tensor:
    """(R, D) table x (..., M) globalized ids and mask -> (..., D): the
    mean of each bag's masked-in rows (torch.nn.EmbeddingBag(mode='mean')
    semantics), summed in float32, in the table's dtype."""
    path = resolve_impl(impl, table.device, what="embedding bag")
    forward = kernel.embedding_bag_cuda if path == "cuda" else _plain
    if impl != "torch" and torch.is_grad_enabled() and table.requires_grad:
        return BagFunction.apply(table, ids, mask, forward)
    return forward(table, ids, mask)


def _plain(table: Tensor, ids: Tensor, mask: Tensor) -> Tensor:
    global plain_calls
    plain_calls += 1
    return ref.embedding_bag_masked(table, ids, mask)
