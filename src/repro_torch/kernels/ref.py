"""Plain autodiff oracle of the fused embedding bag (tests only)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def fused_embedding_bag_ref(pool, indices, weights=None, *,
                            offsets: Optional[Sequence[int]] = None,
                            combiner="sum"):
    """Multi-table oracle over the pooled layout: one gather, one reduction.

    pool (R, D) row-concatenated tables; indices (B, T, H) per-table-local
    rows (global if ``offsets`` is None); weights (B, T, H)? -> (B, T, D).
    Differentiable through plain autograd.
    """
    B, T, H = indices.shape
    idx = indices.long()
    if offsets is not None:
        idx = idx + torch.as_tensor(offsets, dtype=torch.long,
                                    device=idx.device)[None, :, None]
    gathered = pool[idx.reshape(-1)].reshape(B, T, H, pool.shape[1])
    if weights is not None:
        gathered = gathered * weights[..., None]
    if combiner == "sum":
        return gathered.sum(dim=2)
    if combiner == "mean":
        return gathered.mean(dim=2)
    if combiner == "max":
        return gathered.amax(dim=2)
    raise ValueError(combiner)
