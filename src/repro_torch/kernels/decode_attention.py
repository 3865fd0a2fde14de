"""K5: single-token (decode) attention over a KV cache.

Port of ``repro/kernels/decode_attention.py``. Masking is driven by the
absolute positions stored beside the cache, so the same kernel serves full
caches and sliding-window rings: slot ``j`` of row ``b`` is valid when
``cache_pos[b, j] >= 0`` (padded slots hold -1), ``cache_pos[b, j] <=
pos[b]`` and, with a window, ``cache_pos[b, j] > pos[b] - window``.

The cache is split into ``split_plan(B, Hkv, L)`` contiguous ranges of
slots ("flash decoding"): each range keeps its own running softmax, and the
partials are merged in split order. One split (every cache of at most 128
slots, the serving engine's included) is the unsplit computation.

* CUDA tensors launch K5 (``csrc/decode_attention.cu``): one thread block
  per (split, kv head, batch row) takes the G query heads of that kv head
  together over its range (head dim up to 128: up to 8 q-heads per block;
  up to 256: up to 4; a larger G is taken in chunks, a block each, over the
  same range); with more than one split a combine kernel merges the
  partials. One call counts as one launch, whatever the split or chunk
  count.
* CPU tensors run the plain version ``decode_attention_plain``, which runs
  the same split and combine; inside a split it follows the Pallas body: k
  blocks of ``block_k`` slots, f32 scores and softcap, running
  ``m``/``l``/``acc`` over the blocks, ``l`` clamped to 1e-30 (a row with
  no valid slot gives 0).

q is bfloat16 or float32, the caches float32 (the serving engine's dtype)
or bfloat16; the output has q's dtype. K5 has no backward: its CUDA entry
raises when grad mode is on and an input requires grad.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.common import MASK_VALUE as NEG_INF

BLOCK_K = 512         # the Pallas wrapper's default k block
MAX_HEAD_DIM = 256    # a lane holds 4 (D <= 128) or 8 elements of a row
SPLIT_SMS = 132       # the H100's SMs; the kernel runs one block on each
SPLIT_MIN_SLOTS = 128 # no split of a cache of at most this many slots
_DTYPES = (torch.float32, torch.bfloat16)


def split_plan(B: int, Hkv: int, L: int) -> int:
    """How many contiguous ranges of slots K5 splits a cache into.

    The kernel's blocks take 189 registers x 256 threads, so the card holds
    one per SM at a time: the plan fills one wave, (split, kv head, batch
    row) blocks up to the 132 SMs, with at least ``SPLIT_MIN_SLOTS`` slots
    per split on average. A function of the shape alone; 1 for every cache
    of at most 128 slots and for every B x Hkv of 67 or more."""
    if B * Hkv <= 0 or L <= SPLIT_MIN_SLOTS:
        return 1
    return max(1, min(SPLIT_SMS // (B * Hkv), -(-L // SPLIT_MIN_SLOTS)))


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_pos: torch.Tensor,
                           pos: torch.Tensor, *, window: Optional[int] = None,
                           softcap: float = 0.0,
                           block_k: int = BLOCK_K) -> torch.Tensor:
    """Plain version of K5: q (B, 1, Hq, D); caches (B, L, Hkv, D);
    cache_pos (B, L); pos (B,) -> (B, 1, Hq, D) in q's dtype."""
    B, L, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    qg = q.reshape(B, Hkv, G, D).float()
    kt = k_cache.permute(0, 2, 1, 3).float()               # (B, Hkv, L, D)
    vt = v_cache.permute(0, 2, 1, 3).float()
    pos = pos.to(torch.int32)
    n_split = split_plan(B, Hkv, L)
    chunk = -(-L // n_split)
    parts = []
    for j0 in range(0, n_split * chunk, chunk):
        m = torch.full((B, Hkv, G, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G, 1), device=q.device)
        acc = torch.zeros((B, Hkv, G, D), device=q.device)
        j1 = min(L, j0 + chunk)
        for k_start in range(j0, j1, block_k):
            k_end = min(k_start + block_k, j1)
            kb = kt[:, :, k_start:k_end]
            vb = vt[:, :, k_start:k_end]
            # (B, Hkv, G, bk)
            s = torch.matmul(qg, kb.transpose(-1, -2)) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            cpos = cache_pos[:, k_start:k_end].to(torch.int32)
            valid = (cpos >= 0) & (cpos <= pos[:, None])
            if window is not None:
                valid &= cpos > pos[:, None] - window
            valid = valid[:, None, None, :]
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(valid, torch.exp(s - m_new), 0.0)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vb)
            m = m_new
        parts.append((m, l, acc))
    # the combine pass, in split order (exact for a single split)
    m_all = functools.reduce(torch.maximum, [m for m, _, _ in parts])
    l = torch.zeros_like(m_all)
    acc = torch.zeros((B, Hkv, G, D), device=q.device)
    for m_s, l_s, acc_s in parts:
        f = torch.exp(m_s - m_all)
        l = l + l_s * f
        acc = acc + acc_s * f
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def _check(q, k_cache, v_cache, cache_pos, pos) -> None:
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_cache, v_cache)):
        raise RuntimeError(
            "decode_attention: K5 has no backward, and an input requires "
            "grad under grad mode")
    if not q.is_cuda:
        raise ValueError(f"decode_attention: q must be a CUDA tensor, got "
                         f"{q.device}")
    B, L, Hkv, D = k_cache.shape
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device or t.dtype not in _DTYPES \
                or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be a contiguous "
                             f"float32 or bfloat16 tensor on {q.device}")
    if v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype \
            or q.dim() != 4 or q.shape[0] != B or q.shape[1] != 1 \
            or q.shape[3] != D or q.shape[2] % Hkv:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)}")
    if D > MAX_HEAD_DIM or D % (4 if D <= 128 else 8):
        raise ValueError(f"decode_attention: head_dim {D} (a multiple of 4 "
                         f"up to 128, of 8 up to {MAX_HEAD_DIM})")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} is not 16-byte "
                             "aligned (the kernel reads rows as vectors)")
    if cache_pos.device != q.device or cache_pos.dtype != torch.int32 \
            or tuple(cache_pos.shape) != (B, L) \
            or not cache_pos.is_contiguous():
        raise ValueError("decode_attention: cache_pos must be a contiguous "
                         f"({B}, {L}) int32 tensor on {q.device}")
    if pos.device != q.device or pos.dtype != torch.int32 \
            or tuple(pos.shape) != (B,):
        raise ValueError(f"decode_attention: pos must be a ({B},) int32 "
                         f"tensor on {q.device}")


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_pos: torch.Tensor,
                          pos: torch.Tensor, *, window: Optional[int] = None,
                          softcap: float = 0.0) -> torch.Tensor:
    """Launch K5 on CUDA tensors (raises on anything else).

    Replaces the TPU kernel ``_decode_kernel`` of
    ``repro/kernels/decode_attention.py``. Bound by bytes: the K and V rows
    of the valid slots are read once (the kernel loads no row of an invalid
    slot), against about 4·G·D flops per slot. The cache is split into
    ``split_plan(B, Hkv, L)`` ranges, one block each per kv head and batch
    row, so that a batch-1 call fills the card; each lane reads 4 (head dim
    up to 128) or 8 (up to 256) elements of a row in vector loads. With more than one split the partial
    softmaxes go to f32 scratch allocated here and a combine kernel merges
    them; the call counts one launch.
    """
    _check(q, k_cache, v_cache, cache_pos, pos)
    B, L, Hkv, D = k_cache.shape
    G = q.shape[2] // Hkv
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    n_split = split_plan(B, Hkv, L)
    part_m = part_l = part_acc = None
    if n_split > 1:
        part_m = torch.empty((B, Hkv, n_split, G), dtype=torch.float32,
                             device=q.device)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty((B, Hkv, n_split, G, D), dtype=torch.float32,
                               device=q.device)
    lib = cuda_lib.load()
    status = lib.repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_pos.data_ptr(), pos.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr()
          for t in (part_m, part_l, part_acc)),
        B, L, Hkv, G, D, n_split, -1 if window is None else window,
        float(softcap), D ** -0.5, int(q.dtype == torch.bfloat16),
        int(k_cache.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(status, "decode_attention")
    cuda_lib.LAUNCHES["decode_attention"] += 1
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_pos: torch.Tensor,
                     pos: torch.Tensor, *, window: Optional[int] = None,
                     softcap: float = 0.0) -> torch.Tensor:
    """q (B, 1, Hq, D); caches (B, L, Hkv, D); cache_pos (B, L); pos (B,)
    -> (B, 1, Hq, D).

    K5 on CUDA tensors, the plain version on CPU and meta tensors.
    """
    kw = dict(window=window, softcap=softcap)
    if q.is_cuda:
        return decode_attention_cuda(
            q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
            cache_pos.to(torch.int32).contiguous(),
            pos.to(torch.int32).contiguous(), **kw)
    if q.device.type in cuda_lib.PLAIN_DEVICES:
        return decode_attention_plain(q, k_cache, v_cache, cache_pos, pos,
                                      **kw)
    raise ValueError(f"decode_attention: unsupported device {q.device}")
