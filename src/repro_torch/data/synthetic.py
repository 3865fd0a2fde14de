"""Deterministic synthetic Criteo-like batches, addressed by sample index.

Port of ``criteo_batch``, ``zipf_indices`` and ``_rng_for`` from
``repro/data/synthetic.py``. They are numpy, and their bytes are identical
to the reference's: every sample is a pure function of (seed, sample index),
so the two packages train on the same data.
"""
from __future__ import annotations

from typing import Dict, Optional

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


def criteo_batch(cfg: DLRMConfig, seed: int, indices: np.ndarray,
                 zipf_alpha: Optional[float] = None) -> Dict[str, np.ndarray]:
    """indices: (B,) absolute sample ids -> batch dict (dense/sparse/label).

    ``zipf_alpha`` (default ``cfg.zipf_alpha``) skews the sparse ids to a
    power law; 0 keeps the uniform stream.
    """
    alpha = cfg.zipf_alpha if zipf_alpha is None else zipf_alpha
    B = len(indices)
    dense = np.empty((B, cfg.n_dense), np.float32)
    sparse = np.empty((B, cfg.n_tables, cfg.multi_hot), np.int64)
    label = np.empty((B,), np.float32)
    w_dense = np.linspace(-1.0, 1.0, cfg.n_dense).astype(np.float32)
    for i, idx in enumerate(np.asarray(indices)):
        rng = _rng_for(seed, int(idx))
        dense[i] = rng.normal(0, 1, cfg.n_dense).astype(np.float32)
        for t, rows in enumerate(cfg.table_rows):
            if alpha > 0.0:
                sparse[i, t] = zipf_indices(rng, rows, cfg.multi_hot, alpha)
            else:
                sparse[i, t] = rng.integers(0, rows, cfg.multi_hot)
        # informative structure: dense projection + parity of first buckets
        logit = float(dense[i] @ w_dense)
        logit += 0.5 * ((sparse[i, 0, 0] % 2) - 0.5) * 2
        logit += 0.25 * ((sparse[i, 1 % cfg.n_tables, 0] % 4 == 0) - 0.25) * 4
        p = 1.0 / (1.0 + np.exp(-logit))
        label[i] = float(rng.random() < p)
    return {"dense": dense, "sparse": sparse.astype(np.int32), "label": label}
