"""Deterministic synthetic data pipelines.

A copy of `repro.data.pipeline` (numpy only; the port imports nothing of
the reference): every batch is a pure function of (seed, step, shard),
bit for bit the reference's, so any host can regenerate any shard of any
batch and a restart needs no data-order state beyond the step counter.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LMBatchPipeline"]


@dataclasses.dataclass(frozen=True)
class LMBatchPipeline:
    """Token batches with a learnable bigram structure (so loss decreases).

    Tokens follow a Zipf unigram distribution mixed with a deterministic
    bigram successor function: p(next = succ(cur)) = coherence.
    """

    vocab_size: int
    seq_len: int
    global_batch: int
    zipf_alpha: float = 1.1
    coherence: float = 0.5
    seed: int = 0

    def _unigram_cdf(self) -> np.ndarray:
        w = np.arange(1, self.vocab_size + 1, dtype=np.float64) ** (
            -self.zipf_alpha)
        return np.cumsum(w / w.sum())

    def batch(self, step: int, *, shard: int = 0, n_shards: int = 1
              ) -> tuple[np.ndarray, np.ndarray]:
        """(tokens, labels), int32 (b, seq_len), for this step's shard of
        the global batch; the last label of a row is -1 (masked)."""
        if self.global_batch % n_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {n_shards} shards")
        b = self.global_batch // n_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard)
        cdf = self._unigram_cdf()
        draws = np.searchsorted(
            cdf, rng.random((b, self.seq_len))).astype(np.int32)
        draws = np.minimum(draws, self.vocab_size - 1)
        # bigram successor: succ(t) = (t * 31 + 7) % V
        tokens = draws.copy()
        follow = rng.random((b, self.seq_len)) < self.coherence
        for s in range(1, self.seq_len):
            succ = (tokens[:, s - 1] * 31 + 7) % self.vocab_size
            tokens[:, s] = np.where(follow[:, s], succ, draws[:, s])
        labels = np.concatenate(
            [tokens[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        return tokens, labels
