"""K4: block-wise flash attention (causal / sliding-window / GQA / softcap).

Port of ``repro/kernels/flash_attention.py``. Forward only, as there: the
reference trains LMs through the chunked path, not through this kernel,
and so does the port (``models/transformer.full_attention``). The CUDA
entry raises when grad mode is on and an input requires grad, so that a
kernel output never silently drops a gradient.

* CUDA tensors launch K4 by one of two routes, chosen by ``tc_route`` from
  the dtype and the shapes alone. bf16 with head dim 64, 128 or 256 takes
  the tensor-core kernel (``csrc/flash_attention_tc.cu``: TMA loads into a
  shared-memory ring, ``wgmma`` for QK^T and for PV, P split into bf16 hi
  and lo parts so that it keeps f32 accuracy; 128-key tiles at head dim 64
  and 128, 64-key tiles at 256). Everything else (f32 at every head dim,
  bf16 at other head dims up to 256) takes the SIMT kernel
  (``csrc/flash_attention.cu``: products on the f32 cores). In both, one
  thread block per (q block, q head, batch row) walks the reachable k
  blocks with running f32 ``m``/``l``/``acc``. Neither gives way to the
  other on a failure. Where the tensor-core grid holds fewer CTAs than the
  card has SMs (Whisper's cross-attention: 16 CTAs on 132), ``split_plan``
  cuts the keys into contiguous ranges: each range keeps its own running
  softmax, and a combine kernel merges the ranges in split order ("flash
  decoding", as K5 does over its cache). One split is the unsplit
  computation; the SIMT route is never split.
* CPU tensors run the plain version ``flash_attention_plain``, which follows
  the Pallas body step by step on the same block sizes: f32 scores, the
  softcap, the ``kpos < kv_len`` / causal / window masks, the running
  rescale, ``l`` clamped to 1e-30 (a fully masked row gives 0), and tiles
  that no query of the block can reach skipped. It follows the same split
  plan and combine.

Unlike the Pallas wrapper, both take ``q_offset`` (the absolute position of
the first query) and apply it as ``models/attention.chunked_attention``
does; the reference's ``ops.flash_attention`` drops it on its Pallas route.
Layout is the model's (B, S, H, D); q-head ``h`` reads kv-head ``h // G``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.common import MASK_VALUE as NEG_INF
from repro_torch.kernels.decode_attention import SPLIT_SMS

BLOCK_Q = 64          # the SIMT kernel's tile: 64 queries x 64 keys
BLOCK_K = 64
MAX_HEAD_DIM = 256    # the SIMT kernel's; 209 KB of shared memory at 256
TC_HEAD_DIMS = (64, 128, 256)   # the tensor-core kernel's (bf16 only)
TC_BLOCK_Q = 128      # the tensor-core kernel's queries per CTA
SPLIT_KEYS = 128      # a split's key range is a multiple of this: the key
                      # tiles (128, 64 at head dim 256) and BLOCK_K nest in it
SPLIT_MAX = 8         # ranges at most: the combine loads them all at once


def tc_route(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether K4 on these inputs takes the tensor-core kernel: bf16 with
    head dim 64, 128 or 256 and at least one key. Otherwise the SIMT
    kernel."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS
            and k.shape[1] > 0)


def split_plan(dtype: torch.dtype, B: int, Sq: int, Hq: int, Skv: int,
               D: int) -> int:
    """How many contiguous key ranges K4 splits a call into.

    A function of the dtype and the shapes alone. 1 off the tensor-core
    route (the SIMT route is not split) and wherever the unsplit grid,
    ``B·Hq·ceil(Sq/128)`` CTAs of one per SM, already fills the
    ``SPLIT_SMS`` SMs. Otherwise the keys go into ranges of a whole number
    of ``SPLIT_KEYS`` keys (``split_keys``), at most ``SPLIT_MAX``, as many
    as keep the split grid within one wave, none of them empty: Whisper's
    cross-attention (B=1, 16 heads, 1,500 keys) gets 6 ranges of 256 keys,
    96 CTAs."""
    if dtype != torch.bfloat16 or D not in TC_HEAD_DIMS \
            or min(B, Sq, Hq, Skv) <= 0:
        return 1
    base = B * Hq * -(-Sq // TC_BLOCK_Q)
    if base >= SPLIT_SMS:
        return 1
    units = -(-Skv // SPLIT_KEYS)
    chunk = -(-units // min(SPLIT_SMS // base, units, SPLIT_MAX))
    return -(-units // chunk)


def split_keys(Skv: int, n_split: int) -> int:
    """Keys per range of an ``n_split``-way split: a multiple of
    ``SPLIT_KEYS``; the last range takes what is left."""
    units = -(-Skv // SPLIT_KEYS)
    return SPLIT_KEYS * max(1, -(-units // n_split))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None, softcap: float = 0.0,
                          q_offset: int = 0, block_q: int = BLOCK_Q,
                          block_k: int = BLOCK_K,
                          n_split: Optional[int] = None) -> torch.Tensor:
    """Plain version of K4: q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) ->
    (B, Sq, Hq, D) in q's dtype, computed in f32.

    The keys are cut as ``split_plan`` cuts them for the kernel (``n_split``
    overrides the plan, for tests): each range runs the block loop with its
    own running ``m``/``l``/``acc``, and the ranges are merged in order."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = D ** -0.5
    if n_split is None:
        n_split = split_plan(q.dtype, B, Sq, Hq, Skv, D)
    span = split_keys(Skv, n_split) if n_split > 1 else max(Skv, 1)
    ranges = [(j0, min(Skv, j0 + span)) for j0 in range(0, Skv, span)]
    qt = q.permute(0, 2, 1, 3).float()                     # (B, Hq, Sq, D)
    kt = k.permute(0, 2, 1, 3).float().repeat_interleave(G, dim=1)
    vt = v.permute(0, 2, 1, 3).float().repeat_interleave(G, dim=1)
    out = torch.zeros((B, Hq, Sq, D), dtype=torch.float32, device=q.device)
    for q_start in range(0, Sq, block_q):
        qb = qt[:, :, q_start:q_start + block_q]
        parts = [_flash_range(qb, kt, vt, q_offset + q_start, j0, j1,
                              causal, window, softcap, scale, block_q,
                              block_k) for j0, j1 in ranges]
        if len(parts) == 1:
            _, l, acc = parts[0]
        else:   # the combine, in split order
            m_all = functools.reduce(torch.maximum, [p[0] for p in parts])
            l = torch.zeros_like(m_all)
            acc = torch.zeros_like(parts[0][2])
            for m_s, l_s, acc_s in parts:
                f = torch.exp(m_s - m_all)
                l = l + l_s * f
                acc = acc + acc_s * f
        out[:, :, q_start:q_start + qb.shape[2]] = \
            acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _flash_range(qb, kt, vt, q_abs: int, j0: int, j1: int, causal: bool,
                 window: Optional[int], softcap: float, scale: float,
                 block_q: int, block_k: int):
    """The Pallas body's block loop for the queries ``qb`` (first position
    ``q_abs``) over keys ``j0 .. j1``: the running f32 ``m``, ``l`` and
    unnormalised ``acc``."""
    B, Hq, n_q, D = qb.shape
    dev = qb.device
    qpos = q_abs + torch.arange(n_q, device=dev)
    m = torch.full((B, Hq, n_q, 1), NEG_INF, device=dev)
    l = torch.zeros((B, Hq, n_q, 1), device=dev)
    acc = torch.zeros((B, Hq, n_q, D), device=dev)
    for k_start in range(j0, j1, block_k):
        # block-level reachability guard: skip fully masked tiles
        if causal and k_start > q_abs + block_q - 1:
            continue
        if window is not None and \
                k_start + block_k - 1 < q_abs - window + 1:
            continue
        k_end = min(k_start + block_k, j1)
        kb = kt[:, :, k_start:k_end]
        vb = vt[:, :, k_start:k_end]
        kpos = k_start + torch.arange(kb.shape[2], device=dev)
        s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        # keys past kv_len do not exist here (no padding), so the
        # reference's kpos < kv_len mask is always true
        mask = torch.ones((n_q, kb.shape[2]), dtype=torch.bool, device=dev)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vb)
        m = m_new
    return m, l, acc


def _check(q, k, v, q_offset: int) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: K4 has no backward, and an input requires "
            "grad under grad mode; training attention takes the chunked "
            "route (models/transformer.full_attention)")
    if not q.is_cuda:
        raise ValueError(f"flash_attention: q must be a CUDA tensor, got "
                         f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: dtype {q.dtype} (float32 or "
                         "bfloat16)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or t.dim() != 4 \
                or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"4-d {q.dtype} tensor on {q.device}")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or Hq % k.shape[2]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} > {MAX_HEAD_DIM}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None, softcap: float = 0.0,
                         q_offset: int = 0) -> torch.Tensor:
    """Launch K4 on CUDA tensors (raises on anything else).

    Replaces the TPU kernel ``_flash_kernel`` of
    ``repro/kernels/flash_attention.py``. Bound by operations: 4·D flops
    per reachable (query, key) pair and q-head against a few bytes per
    element of q, k, v and o (by bytes for a few queries against many
    keys). ``tc_route`` picks the kernel: the tensor-core one (bf16, head
    dim 64, 128 or 256; its TMA loads need 16-byte aligned q, k, v) or the
    SIMT one on the f32 cores. On the tensor-core route with
    ``split_plan(...) > 1`` the ranges' f32 partials go to scratch
    allocated here and a combine kernel merges them; the call counts one
    launch.
    """
    _check(q, k, v, q_offset)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = cuda_lib.load()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, Hq, Hkv, D, q_offset, int(causal),
            -1 if window is None else window, float(softcap), D ** -0.5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if tc_route(q, k):
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} is not 16-byte "
                                 "aligned (the TMA loads need it)")
        n_split = split_plan(q.dtype, B, Sq, Hq, Skv, D)
        part = None
        if n_split > 1:
            # acc (n_split, B, Sq, Hq, D), then m and l (n_split, B, Sq, Hq)
            part = torch.empty(n_split * B * Sq * Hq * (D + 2),
                               dtype=torch.float32, device=q.device)
        status = lib.repro_flash_attention_tc(
            *args[:4], None if part is None else part.data_ptr(), *args[4:],
            n_split, split_keys(Skv, n_split), stream)
    else:
        status = lib.repro_flash_attention(
            *args, int(q.dtype == torch.bfloat16), stream)
    cuda_lib.check(status, "flash_attention")
    cuda_lib.LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    K4 on CUDA tensors, the plain version on CPU and meta tensors.
    """
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    if q.is_cuda:
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), **kw)
    if q.device.type in cuda_lib.PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, **kw)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
