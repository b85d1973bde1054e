"""The plain reference against the program's plain path, on the same
variates (the program draws them; the reference rebuilds them from the
seed), at a tiny slab on the CPU."""

from __future__ import annotations

import pytest
import torch

from portbench.inputs import table6
from portbench.reference import forkjoin

P, N, CHUNK = 8, 1024, 256
SLAB = {"memory": [1, 4], "cpu": [1, 4], "disk": [1], "rho": [0.3, 0.85]}
# float32 program against a float64 reference: a few float32 ulps of
# accumulated rounding in the sums, the scans and the histogram edges
RTOL = 1e-5


def _port(seed, r, routing, cache, mode, device="cpu"):
    from repro_torch.core import simulator
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.queueing import ServerParams
    rates, cols = table6.what_if_slab(SLAB, p=P, load_scale=r)
    lam = torch.tensor(rates, dtype=torch.float32).to(device)
    fields = {k: torch.tensor(v, dtype=torch.float32).to(device)
              for k, v in cols.items()}
    res = simulator.simulate_fork_join_batch(
        seed, lam, ServerParams(p=P, **fields), N, p=P, mode=mode,
        chunk_size=CHUNK, device=device,
        cluster=ClusterSpec(r=r, routing=routing, result_cache=cache))
    ref = forkjoin.simulate(seed, lam, fields, p=P, n_queries=N, chunk=CHUNK,
                            warmup_fraction=0.1, hist_bins=256,
                            quantile=0.95, mode=mode, r=r, routing=routing,
                            result_cache=cache)
    return res, ref


CASES = [
    (1, "round_robin", None, "cache"),              # table6-p100-r1
    (4, "jsq", (0.2, 2e-3), "cache"),               # table6-p100-r4-jsq-cache
    (4, "random", (0.2, 2e-3), "cache"),
    (1, "round_robin", None, "exponential"),
]


@pytest.mark.parametrize("r,routing,cache,mode", CASES)
@pytest.mark.parametrize("seed", [3, 2**40 + 11])
def test_reference_matches_plain_path(seed, r, routing, cache, mode):
    res, ref = _port(seed, r, routing, cache, mode)
    torch.testing.assert_close(res.mean_response.double(), ref["mean"],
                               rtol=RTOL, atol=0.0)
    torch.testing.assert_close(res.quantile(0.95).double(), ref["quantile"],
                               rtol=RTOL, atol=0.0)
    assert torch.equal(res.count.long(), ref["count"])


def test_lindley_closed_form_is_the_recurrence():
    gen = torch.Generator().manual_seed(0)
    arr = torch.cumsum(torch.rand(3, 50, generator=gen, dtype=torch.float64),
                       -1)
    svc = torch.rand(3, 50, generator=gen, dtype=torch.float64) * 1.5
    carry = torch.tensor([0.0, 2.0, 40.0], dtype=torch.float64)
    want = torch.empty_like(arr)
    prev = carry.clone()
    for i in range(50):
        prev = torch.maximum(arr[:, i], prev) + svc[:, i]
        want[:, i] = prev
    torch.testing.assert_close(forkjoin.lindley(arr, svc, carry), want)


def test_bfloat16_control_is_far_off():
    """The reference in bfloat16 misses the float64 one by far more than
    any limit a cell sets (per cent, not parts per million)."""
    rates, cols = table6.what_if_slab(SLAB, p=P, load_scale=1)
    lam = torch.tensor(rates, dtype=torch.float32)
    fields = {k: torch.tensor(v, dtype=torch.float32)
              for k, v in cols.items()}
    kw = dict(p=P, n_queries=N, chunk=CHUNK, warmup_fraction=0.1,
              hist_bins=256, quantile=0.95, mode="cache")
    ref = forkjoin.simulate(5, lam, fields, **kw)
    ctl = forkjoin.simulate(5, lam, fields, dtype=torch.bfloat16,
                           route_dtype=torch.bfloat16, **kw)
    err = ((ctl["mean"].double() - ref["mean"]).abs() / ref["mean"]).max()
    assert float(err) > 1e-2
