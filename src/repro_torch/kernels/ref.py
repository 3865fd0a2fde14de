"""Plain oracles (tests only): the embedding bags and naive attention.

Twins of ``repro/kernels/ref.py``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.common import MASK_VALUE


def embedding_bag_ref(table, indices, weights=None, *, combiner="sum"):
    """table (R, D); indices (B, n) int; weights (B, n) or None -> (B, D).

    The weights multiply before the combiner; differentiable through plain
    autograd."""
    gathered = table[indices.long()]                        # (B, n, D)
    if weights is not None:
        gathered = gathered * weights[..., None]
    if combiner == "sum":
        return gathered.sum(dim=1)
    if combiner == "mean":
        return gathered.mean(dim=1)
    if combiner == "max":
        return gathered.amax(dim=1)
    raise ValueError(combiner)


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


def attention_ref(q, k, v, *, causal=True, window: Optional[int] = None,
                  softcap: float = 0.0, q_offset: int = 0):
    """Naive quadratic attention in f32. q (B,Sq,Hq,D); k,v (B,Skv,Hkv,D)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (D ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    dpos = qpos[:, None] - kpos[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= dpos >= 0
    if window is not None:
        mask &= dpos < window
    s = torch.where(mask[None, None, None], s, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, cache_pos, pos, *,
                         window: Optional[int] = None, softcap: float = 0.0):
    """q (B,1,Hq,D); caches (B,L,Hkv,D); cache_pos (B,L); pos (B,)."""
    B, L, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * (D ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = (cache_pos >= 0) & (cache_pos <= pos[:, None])
    if window is not None:
        valid &= cache_pos > (pos[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)
