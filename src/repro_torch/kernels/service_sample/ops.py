"""Public wrapper for service sampling (the simulator's (S, p, n) service
times of one chunk).

``impl`` picks the path: ``"cuda"`` launches the hand-written kernel
(`repro_torch.kernels.service_sample.kernel`), ``"torch"`` runs the plain
draws (`ref.service_times_ref`), and ``"auto"`` takes the kernel for what
it takes (a CUDA device, float32, mode ``"cache"`` or ``"exponential"``,
at most `kernel.MAX_PER_SCENARIO` elements a scenario) and the plain
draws for the rest: the CPU, other dtypes, ``"balanced"``.  Both give the
same values bit for bit, so the choice moves no result.  Under ``"cuda"``
a draw the kernel does not take raises.  `plain_count` counts the calls
that ran the plain draws, so a caller on the card can tell that none did.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._cuda import resolve_impl
from repro_torch.kernels.service_sample import kernel, ref

Tensor = torch.Tensor

__all__ = ["launch_count", "plain_count", "reset_counts", "service_times"]

plain_calls = 0       # calls that ran the plain draws, this process


def launch_count() -> int:
    """Service-sampler kernel launches made by this process so far."""
    return kernel.launches


def plain_count() -> int:
    """Calls that ran the plain draws instead of the kernel."""
    return plain_calls


def reset_counts() -> None:
    global plain_calls
    kernel.launches = 0
    plain_calls = 0


def service_times(seeds: tuple[int, ...], shape: tuple[int, int, int],
                  fields: tuple[Tensor, ...], mode: str, *,
                  impl: str = "auto") -> Tensor:
    """(S, p, n) service times from the streams ``seeds`` and the (S,)
    ``fields`` (see `ref.service_times_ref`); the fields' device and dtype
    are the result's."""
    global plain_calls
    dev, dtype = fields[0].device, fields[0].dtype
    path = resolve_impl(impl, dev, what="service sampler")
    n_scen, p, n = shape
    why = kernel.unsupported(dev, dtype, mode, p * n)
    if path == "torch" or (why and impl == "auto"):
        plain_calls += 1
        return ref.service_times_ref(seeds, shape, fields, mode)
    if why:
        raise ValueError(f"the CUDA service sampler {why}")
    return kernel.service_sample_cuda(
        seeds, shape, tuple(f.expand(n_scen).contiguous() for f in fields),
        mode)
