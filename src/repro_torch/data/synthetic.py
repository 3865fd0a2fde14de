"""Deterministic synthetic Criteo-like batches, addressed by sample index.

Port of ``criteo_batch``, ``zipf_indices``, ``_rng_for``, ``RowFreqCounter``
``estimate_row_freq`` and ``lm_batch`` from ``repro/data/synthetic.py``.
They are numpy, and their bytes are identical to the reference's: every
sample is a pure function of (seed, sample index), so the two packages
train on the same data.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.configs.dlrm_models import DLRMConfig


def _rng_for(seed: int, idx_block: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, idx_block]))


def zipf_indices(rng: np.random.Generator, rows: int, size,
                 alpha: float) -> np.ndarray:
    """Bounded-Zipf row ids in ``[0, rows)``: P(id = i) ∝ (i + 1)^-alpha.

    ``alpha = 0`` is the uniform distribution. Id 0 is the hottest row, the
    frequency-packed placement the hot-row cache assumes.
    """
    if alpha <= 0.0:
        return rng.integers(0, rows, size)
    u = rng.random(size)
    if abs(alpha - 1.0) < 1e-9:
        x = np.exp(u * np.log(rows))
    else:
        x = ((rows ** (1.0 - alpha) - 1.0) * u + 1.0) ** (1.0 / (1.0 - alpha))
    # x is continuous in [1, rows]; floor then shift so ranks start at 0
    return np.minimum(x.astype(np.int64), rows) - 1


class RowFreqCounter:
    """Exact per-row lookup counts over the pooled table, fed one (B, T, H)
    batch of per-table-local ids at a time (or a ragged (B, sum(bag_sizes))
    one); the input of the placement planners and of the hot-row cache
    sizing."""

    def __init__(self, table_rows: Sequence[int],
                 bag_sizes: Optional[Sequence[int]] = None):
        self.table_rows = tuple(int(r) for r in table_rows)
        self.bag_sizes = bag_sizes
        self.offsets = np.concatenate(
            ([0], np.cumsum(self.table_rows)[:-1])).astype(np.int64)
        self.total_rows = int(sum(self.table_rows))
        self.counts = np.zeros((self.total_rows,), np.int64)
        self.n_lookups = 0

    def update(self, sparse: np.ndarray) -> None:
        """sparse: (B, T, H) per-table-local ids from one batch, or
        (B, sum(bag_sizes)) ragged ones."""
        from repro_torch.kernels.fused_embedding import column_values
        sparse = np.asarray(sparse)
        flat = (sparse + column_values(self.offsets, sparse.ndim,
                                       self.bag_sizes)).reshape(-1)
        self.counts += np.bincount(flat, minlength=self.total_rows)
        self.n_lookups += flat.size

    def top_k(self, k: int) -> np.ndarray:
        """Global row ids of the k most-frequent rows (hottest first)."""
        k = min(int(k), self.total_rows)
        part = np.argpartition(self.counts, -k)[-k:]
        return part[np.argsort(-self.counts[part], kind="stable")]

    def hit_rate(self, table_hot: Sequence[int]) -> float:
        """Fraction of observed lookups a per-table hot-prefix cache serves."""
        if self.n_lookups == 0:
            return 0.0
        hot = 0
        for off, k in zip(self.offsets, table_hot):
            hot += int(self.counts[off:off + int(k)].sum())
        return hot / self.n_lookups


def estimate_row_freq(cfg: DLRMConfig, seed: int, n_samples: int = 2048,
                      batch_size: int = 256,
                      start: int = 0) -> RowFreqCounter:
    """Row-frequency estimate from a deterministic synthetic sample range."""
    ctr = RowFreqCounter(cfg.table_rows, cfg.bag_sizes)
    for lo in range(start, start + n_samples, batch_size):
        hi = min(lo + batch_size, start + n_samples)
        batch = criteo_batch(cfg, seed, np.arange(lo, hi))
        ctr.update(batch["sparse"])
    return ctr


def criteo_batch(cfg: DLRMConfig, seed: int, indices: np.ndarray,
                 zipf_alpha: Optional[float] = None) -> Dict[str, np.ndarray]:
    """indices: (B,) absolute sample ids -> batch dict (dense/sparse/label).

    ``zipf_alpha`` (default ``cfg.zipf_alpha``) skews the sparse ids to a
    power law; 0 keeps the uniform stream. ``sparse`` is (B, T, H), or for
    per-table lookups (``cfg.bag_sizes``) the sample-major ragged (B,
    sum(multi_hot)), table ``t``'s ``multi_hot[t]`` ids one after another.
    """
    alpha = cfg.zipf_alpha if zipf_alpha is None else zipf_alpha
    B = len(indices)
    sizes = cfg.bag_sizes
    per_table = (cfg.multi_hot,) * cfg.n_tables if sizes is None else sizes
    starts = np.concatenate(([0], np.cumsum(per_table))).astype(np.int64)
    dense = np.empty((B, cfg.n_dense), np.float32)
    sparse = np.empty((B, int(starts[-1])), np.int64)
    label = np.empty((B,), np.float32)
    w_dense = np.linspace(-1.0, 1.0, cfg.n_dense).astype(np.float32)
    first = starts[[0, 1 % cfg.n_tables]]     # tables 0 and 1's first ids
    for i, idx in enumerate(np.asarray(indices)):
        rng = _rng_for(seed, int(idx))
        dense[i] = rng.normal(0, 1, cfg.n_dense).astype(np.float32)
        for t, rows in enumerate(cfg.table_rows):
            h, at = int(per_table[t]), slice(starts[t], starts[t + 1])
            if alpha > 0.0:
                sparse[i, at] = zipf_indices(rng, rows, h, alpha)
            else:
                sparse[i, at] = rng.integers(0, rows, h)
        # informative structure: dense projection + parity of first buckets
        logit = float(dense[i] @ w_dense)
        logit += 0.5 * ((sparse[i, first[0]] % 2) - 0.5) * 2
        logit += 0.25 * ((sparse[i, first[1]] % 4 == 0) - 0.25) * 4
        p = 1.0 / (1.0 + np.exp(-logit))
        label[i] = float(rng.random() < p)
    if sizes is None:
        sparse = sparse.reshape(B, cfg.n_tables, cfg.multi_hot)
    return {"dense": dense, "sparse": sparse.astype(np.int32), "label": label}


# --- LM token streams -------------------------------------------------------
def lm_batch(seed: int, indices: np.ndarray, seq_len: int,
             vocab_size: int) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic token stream; deterministic per sample index."""
    B = len(indices)
    tokens = np.empty((B, seq_len + 1), np.int64)
    for i, idx in enumerate(np.asarray(indices)):
        rng = _rng_for(seed, int(idx))
        # piecewise-linear congruential stream => learnable local structure
        start = rng.integers(0, vocab_size)
        steps = rng.integers(1, 7, seq_len + 1)
        tokens[i] = (start + np.cumsum(steps)) % vocab_size
    return {"tokens": tokens[:, :-1].astype(np.int32),
            "targets": tokens[:, 1:].astype(np.int32)}
