"""Chunked (flash-style) attention and cache attention in plain PyTorch.

Port of ``repro/models/attention.py``, the reference's ``xla`` path. It is
not K4 or K5: those are ``kernels/flash_attention.py`` and
``kernels/decode_attention.py``, which follow the Pallas kernels and compute
in f32 throughout. This path keeps the reference's mixed precision: scores
accumulate in f32, but the probabilities are cast to the value dtype before
the PV product, so at bf16 the two paths differ by that rounding; at f32
they agree to rounding.

It is the port's training route for full-sequence attention
(``models/transformer.full_attention``), as it is the reference's. When
autograd records a call, each (q block x k block) step is recomputed in the
backward (``torch.utils.checkpoint``) instead of keeping its scores and
probabilities, so the backward holds O(S x chunk) per call, not O(S^2):
without it, Whisper's 24-layer encoder at 8 x 1,500 frames (which the
reference does not checkpoint) ran the H100 out of memory. The
recomputation repeats the same operations, so values and gradients are the
ones without it.

Shapes: q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); GQA via Hq = Hkv * group.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def _block_attn(q, k, v, qpos, kpos, *, causal, window, softcap, scale):
    """One (q-block × k-block) attention with flash accumulators returned.

    q: (B, Cq, Hkv, G, D); k/v: (B, Ck, Hkv, D). Returns (o, m, l): the
    unnormalised weighted values (f32), the row max and the row sum-exp.
    """
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    s = _softcap(s * scale, softcap)
    dpos = qpos[:, None] - kpos[None, :]                   # (Cq, Ck)
    mask = torch.ones(dpos.shape, dtype=torch.bool, device=q.device)
    if causal:
        mask &= dpos >= 0
    if window is not None:
        mask &= dpos < window
    s = torch.where(mask[None, None, None], s, NEG_INF)
    m = s.amax(dim=-1)                                     # (B,H,G,Cq)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask[None, None, None], p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o, m, l


def _merge(acc, new):
    """Merge two flash partials (o, m, l) -> combined."""
    o1, m1, l1 = acc
    o2, m2, l2 = new
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    # o has layout (B, Cq, Hkv, G, D); m/l have (B, Hkv, G, Cq)
    w1 = a1.permute(0, 3, 1, 2)[..., None]
    w2 = a2.permute(0, 3, 1, 2)[..., None]
    return o1 * w1 + o2 * w2, m, l1 * a1 + l2 * a2


def _finalize(o, m, l, dtype):
    w = (1.0 / torch.clamp(l, min=1e-30)).permute(0, 3, 1, 2)[..., None]
    return (o * w).to(dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: float = 0.0, q_chunk: int = 1024,
                      k_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Flash-style chunked attention; O(chunk²) memory, exact result.

    For ``window`` (local) attention each q chunk sees only the K/V band it
    can reach (``window + q_chunk`` keys), as in the reference; global
    attention walks every K chunk. A length that is no multiple of its
    chunk ends in a shorter chunk, where the reference halves the chunk
    until it divides the length: Whisper's 1,500 frames would walk 4-wide
    chunks there, 140,625 block pairs per layer, which an eager loop cannot
    afford. Either walk is exact attention; at f32 they agree to rounding,
    at bf16 the probabilities' cast sees other block maxima.
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = D ** -0.5
    dt = q.dtype
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, G, D)
    block = _block_attn
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        def block(*args, **kw):
            return checkpoint(_block_attn, *args, use_reentrant=False, **kw)

    q_chunk = min(q_chunk, Sq)
    outs = []

    if window is not None and Skv > (window + q_chunk):
        # local: a band of static length W + Cq per q chunk (causal only)
        assert causal, "windowed attention requires causal=True (SWA/local)"
        band = window + q_chunk
        for q0, cq in _chunks(Sq, q_chunk):
            qpos = q_offset + q0 + torch.arange(cq, device=dev)
            start = min(max(q0 + cq - band, 0), Skv - band)
            kpos = start + torch.arange(band, device=dev)
            o, m, l = block(qg[:, q0:q0 + cq], k[:, start:start + band],
                            v[:, start:start + band], qpos, kpos,
                            causal=causal, window=window, softcap=softcap,
                            scale=scale)
            outs.append(_finalize(o, m, l, dt))
        return torch.cat(outs, dim=1).reshape(B, Sq, Hq, D)

    # global (or short-enough local): q blocks × k blocks
    k_chunk = min(k_chunk, Skv)
    for q0, cq in _chunks(Sq, q_chunk):
        q_blk = qg[:, q0:q0 + cq]
        qpos = q_offset + q0 + torch.arange(cq, device=dev)
        acc = (torch.zeros((B, cq, Hkv, G, D), device=dev),
               torch.full((B, Hkv, G, cq), NEG_INF, device=dev),
               torch.zeros((B, Hkv, G, cq), device=dev))
        for k0, ck in _chunks(Skv, k_chunk):
            kpos = k0 + torch.arange(ck, device=dev)
            new = block(q_blk, k[:, k0:k0 + ck], v[:, k0:k0 + ck], qpos,
                        kpos, causal=causal, window=window, softcap=softcap,
                        scale=scale)
            acc = _merge(acc, new)
        outs.append(_finalize(*acc, dt))
    return torch.cat(outs, dim=1).reshape(B, Sq, Hq, D)


def _chunks(n: int, chunk: int):
    """(start, size) of consecutive chunks of ``chunk`` covering ``n``; the
    last one is shorter when ``chunk`` does not divide ``n``."""
    return [(s, min(chunk, n - s)) for s in range(0, n, chunk)]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_pos: torch.Tensor,
                     pos: torch.Tensor, *, window: Optional[int] = None,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single-token attention over a (possibly ring-buffer) KV cache.

    q (B, 1, Hq, D); caches (B, L, Hkv, D); cache_pos (B, L) absolute
    positions, -1 = empty; pos (B,) the current position. Masking is driven
    by the stored positions, so full and ring caches work alike.
    """
    B, L, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    qg = q.reshape(B, Hkv, G, D).to(k_cache.dtype)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) * scale
    s = _softcap(s, softcap)
    valid = (cache_pos >= 0) & (cache_pos <= pos[:, None])
    if window is not None:
        valid &= cache_pos > (pos[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)
