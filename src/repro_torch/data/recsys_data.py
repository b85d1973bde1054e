"""Synthetic Criteo-like CTR batches, the port's own copy of
`repro.data.recsys_data.ctr_batch`.

Per-field categorical ids are Zipf-distributed (the same popularity skew
the paper measures for query terms).  Labels come from a fixed random
logistic teacher.  numpy only: for the same (cfg, batch, step, seed) the
arrays are bit-identical to the reference's.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.recsys import field_offsets

__all__ = ["ctr_batch"]


def _zipf_ids(rng, vocab: int, size, alpha: float = 1.05) -> np.ndarray:
    w = np.arange(1, vocab + 1, dtype=np.float64) ** (-alpha)
    cdf = np.cumsum(w / w.sum())
    out = np.searchsorted(cdf, rng.random(size))
    return np.minimum(out, vocab - 1).astype(np.int32)


def ctr_batch(cfg: RecsysConfig, batch: int, *, step: int = 0,
              seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ids (B,F,M) globalized int64, mask (B,F,M) bool, labels (B,)
    float32) for one step.  Fields of more than 1000 ids are one-hot, the
    others ``cfg.multi_hot``-hot; the valid ids of a bag come first."""
    rng = np.random.default_rng(seed * 1_000_003 + step)
    offs = field_offsets(cfg)
    m = cfg.multi_hot
    ids = np.zeros((batch, cfg.n_sparse, m), np.int64)
    mask = np.zeros((batch, cfg.n_sparse, m), bool)
    for f, vocab in enumerate(cfg.field_vocabs):
        n_hot = 1 if vocab > 1000 else m   # big fields one-hot, small multi
        ids[:, f, :n_hot] = (_zipf_ids(rng, vocab, (batch, n_hot))
                             + offs[f])
        mask[:, f, :n_hot] = True
    # teacher: logistic over hashed id parities
    h = ((ids * 2654435761) % 97).sum(axis=(1, 2)) % 13
    prob = 1.0 / (1.0 + np.exp(-(h.astype(np.float64) - 6.0) / 2.0))
    labels = (rng.random(batch) < prob).astype(np.float32)
    return ids, mask, labels
