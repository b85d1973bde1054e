"""The program's per-chunk random plan, rebuilt from the seed alone.

The simulator under test draws its own numbers: every chunk's variates
come from ``torch.Generator``s seeded by a SplitMix64 hash of (dispatch
seed, chunk index) and a stream word, with salted side streams for
random routing and the result cache.  This module regenerates the same
raw variates (unit exponentials, uniforms, replica indices) on the same
device, so that the reference simulates the very sample path the
program did.  It copies the plan and nothing else: all arithmetic on
the variates (means, mixtures, queues, statistics) is the reference's
own.  A program change to this plan (hash, salts, stream words, draw
order or shapes) changes the simulated results, and has to be carried
here in a benchmark change.  A faulted run's MTBF/MTTR chain draws from
one more salted stream (``fault_u``).

A sharded sweep (`core.sweep.sweep_simulated(mesh=)`) seeds its flat
(p, r) dispatch k from ``mix(seed, k)`` and that dispatch's shard d from
``mix(mix(seed, k), d)``; a shard holds a contiguous block of the
dispatch's scenarios, the last block padded with copies of the last
scenario (``shard_seeds``, ``shard_rows``).
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1
ROUTE_SALT = 0x2077
CACHE_SALT = 0xCA8E
FAULT_SALT = 0xFA17


def mix(*words: int) -> int:
    """SplitMix64 hash of a word sequence."""
    h = 0x243F6A8885A308D3
    for w in words:
        h = ((h ^ (w & _MASK64)) + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h


def shard_seeds(seed: int, n_shards: int) -> list[int]:
    """Each shard's seed in the first (p, r) dispatch, k = 0, of a sharded
    sweep run from ``seed``: a grid of one p and one r has no other."""
    k = mix(seed, 0)
    return [mix(k, d) for d in range(n_shards)]


def shard_rows(n_scen: int, n_shards: int) -> list[list[int]]:
    """Each shard's scenarios, as indices into the dispatch's ``n_scen``:
    equal contiguous blocks, padded at the end by edge replication."""
    per = -(-n_scen // n_shards)
    return [[min(i, n_scen - 1) for i in range(d * per, (d + 1) * per)]
            for d in range(n_shards)]


def _gen(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def unit_exponential(seed: int, shape, device) -> torch.Tensor:
    return torch.empty(shape, device=device, dtype=torch.float32
                       ).exponential_(generator=_gen(seed, device))


def unit_uniform(seed: int, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=_gen(seed, device), device=device,
                      dtype=torch.float32)


def chunk_variates(seed: int, chunk_idx: int, *, n_scen: int, chunk: int,
                   p: int, mode: str, route_r: int | None,
                   result_cache: bool, device,
                   fault_r: int | None = None) -> dict:
    """The raw float32 variates of one chunk of a dispatch seeded ``seed``.

    Keys: ``gap`` and ``broker`` (S, chunk) unit exponentials; for
    ``mode="exponential"`` ``server`` (S, p, chunk) unit exponentials, for
    ``mode="cache"`` ``hit_u`` (S, p, chunk) uniforms and ``hit_e``,
    ``miss_e``, ``disk_e`` (S, p, chunk) unit exponentials; with
    ``route_r`` (random routing) ``route`` (S, chunk) int64 replicas; with
    ``result_cache`` ``cache_u`` (S, chunk) uniforms and ``cache_e``
    (S, chunk) unit exponentials; with ``fault_r`` (an MTBF/MTTR chain
    over that many replicas) ``fault_u`` (S, chunk, r) uniforms.
    """
    dev = torch.device(device)
    row, full = (n_scen, chunk), (n_scen, p, chunk)
    kc = mix(seed, chunk_idx)
    out = {"gap": unit_exponential(mix(kc, 0), row, dev),
           "broker": unit_exponential(mix(kc, 1), row, dev)}
    ks = mix(kc, 2)
    if mode == "exponential":
        out["server"] = unit_exponential(mix(ks, 0), full, dev)
    elif mode == "cache":
        out["hit_u"] = unit_uniform(mix(ks, 1), full, dev)
        out["hit_e"] = unit_exponential(mix(ks, 2), full, dev)
        out["miss_e"] = unit_exponential(mix(ks, 3), full, dev)
        out["disk_e"] = unit_exponential(mix(ks, 4), full, dev)
    else:
        raise ValueError(f"no reference for service mode {mode!r}")
    if route_r is not None:
        out["route"] = torch.randint(
            0, route_r, row, generator=_gen(mix(seed, chunk_idx, ROUTE_SALT),
                                            dev), device=dev)
    if result_cache:
        out["cache_u"] = unit_uniform(mix(seed, chunk_idx, CACHE_SALT, 0),
                                      row, dev)
        out["cache_e"] = unit_exponential(mix(seed, chunk_idx, CACHE_SALT, 1),
                                          row, dev)
    if fault_r is not None:
        out["fault_u"] = unit_uniform(mix(seed, chunk_idx, FAULT_SALT, 0),
                                      row + (fault_r,), dev)
    return out
