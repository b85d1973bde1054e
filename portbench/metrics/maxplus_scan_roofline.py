"""The (max,+) scans' share of their roofline (`kernels.maxplus_scan`,
plain and segmented), over the FCFS levels of the traced window's chunks.

A chunk of n queries has one FCFS level per queue kind: the result
cache (S rows, where there is one), the broker (S rows) and the index
servers (S p rows).  Per level the scan reads the a and b inputs once
and writes the completions once (3 x rows x n values); a plain scan
also reads each row's carry, a segmented one (r > 1) an (S, n) byte of
reset flags.  Three operations an element (add, add, max).  The least
time is the larger of bytes over the card's HBM rate and operations
over its float32 rate, whatever kernels do the work.
"""

import re

UNIT = "%"
PATTERN = re.compile(r"maxplus_(segment_)?scan_kernel")


def levels(shape):
    s, p = shape["n_scen"], shape["p"]
    return ([s] if shape["result_cache"] else []) + [s, s * p]


def least_s_per_chunk(shape, peaks):
    n, isz, s = shape["chunk"], shape["itemsize"], shape["n_scen"]
    total = 0.0
    for rows in levels(shape):
        moved = 3 * rows * n * isz + (rows * isz if shape["r"] == 1
                                      else s * n)
        total += max(moved / peaks["hbm_bytes_per_s"],
                     3 * rows * n / peaks["fp32_flops_per_s"])
    return total


def read(view):
    ks = [op for op in view.kernels() if PATTERN.search(op.name)]
    if not ks or view.peaks is None:
        return None
    least = view.chunks * least_s_per_chunk(view.shape, view.peaks)
    return 100.0 * least / sum(op.seconds for op in ks)
