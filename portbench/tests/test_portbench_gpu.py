"""On the card: the program's kernels (where the CPU runs their plain
versions) against the reference, at the CPU test's tiny slab; the cells'
own checks compare at full size.  Run there with ``python -m pytest -m
gpu portbench/tests``; skipped without a card."""

from __future__ import annotations

import pytest
import torch

from portbench.tests import test_portbench_faulted as faulted_cases
from portbench.tests.test_portbench_reference import CASES

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("r,routing,cache,mode", CASES)
def test_kernels_match_reference(r, routing, cache, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.tests import test_portbench_reference as t
    res, ref = t._port(2**35 + 3, r, routing, cache, mode, device="cuda")
    torch.testing.assert_close(res.mean_response.double(), ref["mean"],
                               rtol=t.RTOL, atol=0.0)
    torch.testing.assert_close(res.quantile(0.95).double(), ref["quantile"],
                               rtol=t.RTOL, atol=0.0)


@pytest.mark.parametrize("case", sorted(faulted_cases.CASES))
def test_fault_kernels_match_reference(case):
    """The fleet scan and the masked router on the card against the
    faulted reference, each fault channel alone and all together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    faulted_cases.check_case(2**35 + 7, case, device="cuda")
