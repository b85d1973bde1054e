"""The JSQ router's share of its roofline (`kernels.jsq_route`).

Per launch, one chunk of (S scenarios, r replicas, p servers, n queries):
the services (S, p, n), the gaps and the live flags (S, n) and the
tracker (S, r, p) read once, the tracker written once and the (S, n)
int64 choices written once; per query and scenario, a drain (subtract,
clamp) and a reduction over r x p, an argmin over r and a deposit
(multiply, add) over p.  A ``MASKED`` instance (its last template
argument ``true``: the fault injector's replica-up mask or the
autoscaler's active count) also reads a query's int32 active count and
its ceil(r / 32) int32 words of up bits and writes its spill and
unavailable flags, a byte each; per query and scenario, the mask's
select over r, its any over r, and the two flags.  The least time is
the larger of bytes over the card's HBM rate and operations over its
float32 rate, summed over the launches of each instance.
"""

import re

UNIT = "%"
PATTERN = re.compile(r"jsq_\w*kernel")
MASKED = re.compile(r"jsq_\w*kernel<[^>]*\btrue>")


def bytes_per_launch(shape):
    s, p, r, n, isz = (shape["n_scen"], shape["p"], shape["r"],
                       shape["chunk"], shape["itemsize"])
    return (s * p * n + 2 * s * n + 2 * s * r * p) * isz + s * n * 8


def masked_bytes_per_launch(shape):
    s, r, n = shape["n_scen"], shape["r"], shape["chunk"]
    words = -(-r // 32)
    return bytes_per_launch(shape) + s * n * (4 + 4 * words + 2)


def ops_per_launch(shape):
    s, p, r, n = shape["n_scen"], shape["p"], shape["r"], shape["chunk"]
    return s * n * (3 * r * p + r + 2 * p)


def masked_ops_per_launch(shape):
    s, r, n = shape["n_scen"], shape["r"], shape["chunk"]
    return ops_per_launch(shape) + s * n * (2 * r + 2)


def read(view):
    ks = [op for op in view.kernels() if PATTERN.search(op.name)]
    if not ks or view.peaks is None:
        return None
    hbm, fp32 = view.peaks["hbm_bytes_per_s"], view.peaks["fp32_flops_per_s"]
    n_masked = sum(1 for op in ks if MASKED.search(op.name))
    least = max(bytes_per_launch(view.shape) / hbm,
                ops_per_launch(view.shape) / fp32)
    least_masked = max(masked_bytes_per_launch(view.shape) / hbm,
                       masked_ops_per_launch(view.shape) / fp32)
    return (100.0 * (len(ks) - n_masked) * least
            + 100.0 * n_masked * least_masked) / sum(op.seconds for op in ks)
