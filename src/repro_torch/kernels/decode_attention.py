"""K5: single-token (decode) attention over a KV cache.

Port of ``repro/kernels/decode_attention.py``. Masking is driven by the
absolute positions stored beside the cache, so the same kernel serves full
caches and sliding-window rings: slot ``j`` of row ``b`` is valid when
``cache_pos[b, j] >= 0`` (padded slots hold -1), ``cache_pos[b, j] <=
pos[b]`` and, with a window, ``cache_pos[b, j] > pos[b] - window``.

* CUDA tensors launch K5 (``csrc/decode_attention.cu``): one thread block
  per (kv head, batch row) takes the G query heads of that kv head together
  over the whole cache.
* CPU tensors run the plain version ``decode_attention_plain``, which
  follows the Pallas body: k blocks of ``block_k`` slots, f32 scores and
  softcap, running ``m``/``l``/``acc`` over the blocks, ``l`` clamped to
  1e-30 (a row with no valid slot gives 0).

q is bfloat16 or float32, the caches float32 (the serving engine's dtype)
or bfloat16; the output has q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.common import MASK_VALUE as NEG_INF

BLOCK_K = 512         # the Pallas wrapper's default k block
MAX_HEAD_DIM = 128
MAX_GROUP = 8         # q heads per kv head the kernel holds in registers
_DTYPES = (torch.float32, torch.bfloat16)


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
    m = torch.full((B, Hkv, G, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, 1), device=q.device)
    acc = torch.zeros((B, Hkv, G, D), device=q.device)
    for k_start in range(0, L, block_k):
        kb = kt[:, :, k_start:k_start + block_k]
        vb = vt[:, :, k_start:k_start + block_k]
        s = torch.matmul(qg, kb.transpose(-1, -2)) * scale  # (B, Hkv, G, bk)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        cpos = cache_pos[:, k_start:k_start + block_k].to(torch.int32)
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
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def _check(q, k_cache, v_cache, cache_pos, pos) -> None:
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
    if D > MAX_HEAD_DIM or q.shape[2] // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: head_dim {D} (at most "
                         f"{MAX_HEAD_DIM}) or group {q.shape[2] // Hkv} "
                         f"(at most {MAX_GROUP})")
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
    slot), against about 4·G·D flops per slot. Each of the block's 8 warps
    takes every 8th group of 4 slots with its own running softmax; the
    warps' partials are merged at the end. Split-K across blocks is for
    later: at B·Hkv blocks the card is not filled.
    """
    _check(q, k_cache, v_cache, cache_pos, pos)
    B, L, Hkv, D = k_cache.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = cuda_lib.load()
    status = lib.repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_pos.data_ptr(), pos.data_ptr(), out.data_ptr(), B, L, Hkv,
        q.shape[2] // Hkv, D, -1 if window is None else window,
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

    K5 on CUDA tensors, the plain version on CPU tensors.
    """
    kw = dict(window=window, softcap=softcap)
    if q.is_cuda:
        return decode_attention_cuda(
            q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
            cache_pos.to(torch.int32).contiguous(),
            pos.to(torch.int32).contiguous(), **kw)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_pos, pos,
                                      **kw)
    raise ValueError(f"decode_attention: unsupported device {q.device}")
