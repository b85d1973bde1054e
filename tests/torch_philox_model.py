"""A numpy model of the float32 variates torch draws on a CUDA device.

``torch.rand`` and ``Tensor.exponential_`` on a CUDA generator freshly
seeded with ``seed`` run Philox4x32-10 (curand's, Random123's algorithm)
in torch's grid-stride layout (ATen/native/cuda/DistributionTemplates.h):
blocks of 256 threads, ``grid`` of them (`kernel.grid_size`), T = 256 x
grid; thread t's k-th ``curand_uniform4`` is the Philox block of counter
(k, 0, t, 0) under key (seed lo, seed hi), and its word ii lands on
element t + 4Tk + T ii.  A draw past 2^29 float32 elements torch makes in
pieces (`kernel.draw_launches`), each laid out so from its first element,
with k counted on from the piece's counter base.  A word w becomes
u = w 2^-32 + 2^-33 in (0, 1].
The service sampler's CUDA kernel (`repro_torch.kernels.service_sample`)
makes the same words in registers; this model keeps that layout testable
without a card.  Only numpy: the card's tests import it too.
"""

from __future__ import annotations

import numpy as np

M0, M1 = 0xD2511F53, 0xCD9E8D57      # Philox4x32 multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85      # key increments
THREADS = 256
_LO = 0xFFFFFFFF


def philox4x32_10(ctr, key) -> np.ndarray:
    """Philox4x32-10 of counters ``ctr`` (4, ...) uint32-valued under the
    two-word ``key``; returns (4, ...) uint32."""
    c = [np.asarray(x, dtype=np.uint64) for x in ctr]
    k0, k1 = int(key[0]) & _LO, int(key[1]) & _LO
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + W0) & _LO, (k1 + W1) & _LO
        p0 = np.uint64(M0) * c[0]
        p1 = np.uint64(M1) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ np.uint64(k0),
             p1 & np.uint64(_LO),
             (p0 >> np.uint64(32)) ^ c[3] ^ np.uint64(k1),
             p0 & np.uint64(_LO)]
    return np.stack(c).astype(np.uint32)


def place(numel: int, grid: int) -> tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """(thread t, call k, word ii) of each element of a draw."""
    span = THREADS * grid
    e = np.arange(numel, dtype=np.int64)
    k, rem = np.divmod(e, 4 * span)
    ii, t = np.divmod(rem, span)
    return t, k, ii


def words_at(seed: int, index, launches) -> np.ndarray:
    """The uint32 Philox words torch turns into the elements ``index`` of
    a draw made in ``launches``: (first element, elements, grid, counter
    base) each."""
    index = np.asarray(index, dtype=np.int64)
    out = np.zeros(index.shape, dtype=np.uint32)
    key = (seed & _LO, (seed >> 32) & _LO)
    for start, n, grid, base in launches:
        sel = (index >= start) & (index < start + n)
        local = index[sel] - start
        span = THREADS * grid
        k, rem = np.divmod(local, 4 * span)
        ii, t = np.divmod(rem, span)
        k = k + base
        zero = np.zeros_like(t)
        blocks = philox4x32_10((k & _LO, k >> 32, t, zero), key)
        out[sel] = blocks[ii, np.arange(local.size)]
    return out


def words(seed: int, numel: int, grid: int) -> np.ndarray:
    """The uint32 Philox word torch turns into element e of a draw of
    ``numel`` elements in one launch, for each e."""
    return words_at(seed, np.arange(numel), [(0, numel, grid, 0)])


def uniform(w: np.ndarray) -> np.ndarray:
    """curand's uniform of a word, float32 in (0, 1]."""
    return (w.astype(np.float32) * np.float32(2.0 ** -32)
            + np.float32(2.0 ** -33))


def _reverse_bound(u: np.ndarray) -> np.ndarray:
    """curand's (0, 1] reversed to ``torch.rand``'s [0, 1)."""
    return np.where(u == np.float32(1.0), np.float32(0.0), u)


def torch_rand(seed: int, numel: int, grid: int) -> np.ndarray:
    """``torch.rand`` on the card, a draw in one launch."""
    return _reverse_bound(uniform(words(seed, numel, grid)))


def torch_rand_at(seed: int, index, launches) -> np.ndarray:
    """Elements ``index`` of ``torch.rand`` on the card, a draw made in
    ``launches`` (see `words_at`)."""
    return _reverse_bound(uniform(words_at(seed, index, launches)))


def torch_exponential(seed: int, numel: int, grid: int) -> np.ndarray:
    """``Tensor.exponential_()`` on the card, up to the error of the
    fast ``__logf`` torch takes there (ATen/NumericUtils.h): the
    logarithm here is float64's, rounded once to float32."""
    u = uniform(words(seed, numel, grid))
    half_eps = np.float32(2.0 ** -24)
    with np.errstate(divide="ignore"):
        log = np.log(u.astype(np.float64)).astype(np.float32)
    return np.where(u >= np.float32(1.0) - half_eps, half_eps, -log)
