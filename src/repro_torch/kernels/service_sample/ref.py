"""Plain PyTorch service sampling: torch's own draws, scaled per scenario.

Each stream is one draw from a `torch.Generator` freshly seeded with that
stream's seed (the simulator's RNG primitives, `repro_torch.core.
simulator._unit_exponential` / `_unit_uniform`), and the services are
broadcast products of those draws with each scenario's (S,) fields, then
a mixture:

* ``"exponential"``: ``Exp(1) * s_mean``;
* ``"balanced"``: one ``Exp(1) * s_mean`` a query, shared by the p
  servers (a broadcast view);
* ``"cache"``: ``where(U < hit, Exp(1) * s_hit, Exp(1) * s_miss +
  Exp(1) * s_disk)`` from four streams (hit uniform, hit, miss and disk
  exponentials).

The CUDA kernel (`kernel.service_sample_cuda`) gives these values bit for
bit on the card.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

__all__ = ["service_times_ref"]


def service_times_ref(seeds: tuple[int, ...], shape: tuple[int, int, int],
                      fields: tuple[Tensor, ...], mode: str) -> Tensor:
    """(S, p, n) service times of ``mode`` from the streams ``seeds`` and
    the (S,) ``fields``: ``(s_mean,)`` with one seed, or for ``"cache"``
    ``(hit, s_hit, s_miss, s_disk)`` with four."""
    # imported here: the simulator imports this package
    from repro_torch.core.simulator import (
        _unit_exponential as unit_exponential, _unit_uniform as unit_uniform)
    n_scen, _, n = shape
    dev, dtype = fields[0].device, fields[0].dtype
    col = [f[:, None, None] for f in fields]
    if mode == "exponential":
        return unit_exponential(seeds[0], shape, dev, dtype) * col[0]
    if mode == "balanced":
        one = unit_exponential(seeds[0], (n_scen, 1, n), dev, dtype)
        return (one * col[0]).expand(shape)
    if mode == "cache":
        is_hit = unit_uniform(seeds[0], shape, dev, dtype) < col[0]
        t_hit = unit_exponential(seeds[1], shape, dev, dtype) * col[1]
        t_miss = (unit_exponential(seeds[2], shape, dev, dtype) * col[2]
                  + unit_exponential(seeds[3], shape, dev, dtype) * col[3])
        return torch.where(is_hit, t_hit, t_miss)
    raise ValueError(f"unknown service mode: {mode}")
