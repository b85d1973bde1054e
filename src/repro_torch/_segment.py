"""Segment sums and row gathers whose sums repeat bit for bit on the card.

A float ``index_add_`` / ``scatter_add_`` on a CUDA tensor adds with
atomics whose order varies run to run, and the sort-based
``index_put_(accumulate=True)`` (what a gather's backward runs) adds each
run of equal ids in one thread, one after the other: exact and repeatable,
but a popular row read 10^5 times is 10^5 serial adds.  Here the ids are
sorted (a stable radix sort), the rows follow them, and each run of equal
ids is summed by a log-depth segmented scan in float32: step s adds the
partial sum s places back where that element is in the same run (its
place in the run is its index less the run's first, found by a binary
search of the sorted ids), so a run of n rows takes ceil(log2 n) steps
over the whole array and every sum has one fixed order.  The last
element of each run holds its sum; it is copied to its id's row (no two
writers) and rounded once to the data's dtype.

Ids outside [0, n) are dropped, as ``jax.ops.segment_sum`` drops them:
callers mark a masked entry by an id of n, and its row is never read.
The number of steps (the longest run among the kept ids) and the runs'
ends are read on the host: two synchronisations a call.  The run sums
are one operator, ``torch.ops.repro_torch.run_sums``, whose fake
implementation gives only the output's shape and dtype, so a trace
under ``FakeTensorMode`` (the dry run, `repro_torch.launch.dryrun`)
passes through them without reading a value; on real tensors the
operator runs the code below, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

__all__ = ["segment_sum", "gather_rows"]


def _acc_dtype(data: Tensor) -> torch.dtype:
    return torch.float64 if data.dtype == torch.float64 else torch.float32


@torch.library.custom_op("repro_torch::run_sums", mutates_args=())
def _run_sums(data: Tensor, ids: Tensor, n: int) -> Tensor:
    """(N, ...) data, (N,) ids -> (n, ...) float32 sums, no autograd."""
    acc = _acc_dtype(data)
    out = torch.zeros((n + 1,) + tuple(data.shape[1:]), dtype=acc,
                      device=data.device)
    if ids.numel() == 0:
        return out[:n]
    keys = torch.where((ids >= 0) & (ids < n), ids.long(), n)
    keys, order = torch.sort(keys, stable=True)
    x = data.to(acc)[order]
    # an element's place in its run: its index less its run's first
    run_pos = (torch.arange(keys.numel(), device=keys.device)
               - torch.searchsorted(keys, keys))
    longest = int(run_pos.masked_fill(keys == n, 0).max()) + 1  # staticcheck-torch: disable=RPT101 (the step count, read on purpose: ROADMAP queue 2, held item 4)
    shape = (-1,) + (1,) * (x.ndim - 1)
    y = torch.empty_like(x)
    s = 1
    while s < longest:
        y[:s] = x[:s]
        torch.addcmul(x[s:], x[:-s], (run_pos[s:] >= s).to(acc)
                      .reshape(shape), out=y[s:])
        x, y = y, x
        s *= 2
    ends = torch.ones_like(keys, dtype=torch.bool)
    ends[:-1] = keys[1:] != keys[:-1]
    ends = ends.nonzero().squeeze(1)  # one row a run  # staticcheck-torch: disable=RPT101 (the run ends, read on purpose: ROADMAP queue 2, held item 4)
    out.index_copy_(0, keys[ends], x[ends])
    return out[:n]


@_run_sums.register_fake
def _(data: Tensor, ids: Tensor, n: int) -> Tensor:
    return data.new_empty((n,) + tuple(data.shape[1:]),
                          dtype=_acc_dtype(data))


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(data: Tensor, ids: Tensor, n: int) -> Tensor:
        return _run_sums(data, ids, n).to(data.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ids, n = inputs
        ctx.save_for_backward(ids)
        ctx.n = n

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        kept = (ids >= 0) & (ids < ctx.n)
        rows = g[torch.where(kept, ids.long(), 0)]
        shape = (-1,) + (1,) * (rows.ndim - 1)
        return rows * kept.reshape(shape).to(rows.dtype), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(table: Tensor, ids: Tensor, grad_ids: Tensor) -> Tensor:
        return table[ids.long()]

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, _, grad_ids = inputs
        ctx.save_for_backward(grad_ids)
        ctx.rows = table.shape[0]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = g.reshape((ids.numel(),) + tuple(g.shape[ids.ndim:]))
        return segment_sum(flat, ids.reshape(-1), ctx.rows), None, None


def segment_sum(data: Tensor, ids: Tensor, n: int) -> Tensor:
    """sum of ``data[i]`` over the i with ``ids[i] == k``, for k < n:
    (N, ...) x (N,) -> (n, ...) in ``data``'s dtype, summed in float32
    (float64 for float64 data) and rounded once; ids outside [0, n)
    dropped.  Differentiable in ``data`` (the backward gathers)."""
    return _SegmentSum.apply(data, ids, n)


def gather_rows(table: Tensor, ids: Tensor, *,
                grad_ids: Optional[Tensor] = None) -> Tensor:
    """``table[ids]`` whose backward is `segment_sum` into the table's
    rows (a dense gradient, the same bits run to run).  ``grad_ids``
    (default ``ids``) are the rows the backward adds into, an id outside
    the table dropping its entry: a padded entry whose gradient is known
    to be zero gives nothing, and lengthens no run of equal ids."""
    return _GatherRows.apply(table, ids, ids if grad_ids is None
                             else grad_ids)
