"""Public wrapper for EmbeddingBag with the model op's signature.

``impl`` picks the path: ``"cuda"`` launches the hand-written kernel
(`repro_torch.kernels.embedding_bag.kernel`), ``"torch"`` runs the plain
version (`ref.embedding_bag_masked`), and ``"auto"`` takes the kernel for
a CUDA tensor and the plain version for a CPU tensor.  A CUDA tensor under
``"auto"`` or ``"cuda"`` launches the kernel or raises; nothing falls
back.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._cuda import resolve_impl
from repro_torch.kernels.embedding_bag import kernel, ref

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
    global plain_calls
    if resolve_impl(impl, table.device, what="embedding bag") == "cuda":
        return kernel.embedding_bag_cuda(table, ids, mask)
    plain_calls += 1
    return ref.embedding_bag_masked(table, ids, mask)
