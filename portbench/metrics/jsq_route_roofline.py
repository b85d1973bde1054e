"""The JSQ router's share of its roofline (`kernels.jsq_route`).

Per launch, one chunk of (S scenarios, r replicas, p servers, n queries):
the services (S, p, n), the gaps and the live flags (S, n) and the
tracker (S, r, p) read once, the tracker written once and the (S, n)
int64 choices written once; per query and scenario, a drain (subtract,
clamp) and a reduction over r x p, an argmin over r and a deposit
(multiply, add) over p.  The least time is the larger of bytes over the
card's HBM rate and operations over its float32 rate.
"""

import re

UNIT = "%"
PATTERN = re.compile(r"jsq_\w*kernel")


def bytes_per_launch(shape):
    s, p, r, n, isz = (shape["n_scen"], shape["p"], shape["r"],
                       shape["chunk"], shape["itemsize"])
    return (s * p * n + 2 * s * n + 2 * s * r * p) * isz + s * n * 8


def ops_per_launch(shape):
    s, p, r, n = shape["n_scen"], shape["p"], shape["r"], shape["chunk"]
    return s * n * (3 * r * p + r + 2 * p)


def read(view):
    ks = [op for op in view.kernels() if PATTERN.search(op.name)]
    if not ks or view.peaks is None:
        return None
    least = max(bytes_per_launch(view.shape) / view.peaks["hbm_bytes_per_s"],
                ops_per_launch(view.shape) / view.peaks["fp32_flops_per_s"])
    return 100.0 * len(ks) * least / sum(op.seconds for op in ks)
