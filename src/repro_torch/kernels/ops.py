"""Public kernel entry points: the DLRM training path and LM attention.

Port of ``fused_embedding_bag``, ``embedding_bag``, ``sparse_row_grads``,
``fused_row_update``, ``flash_attention`` and ``decode_attention`` of
``repro/kernels/ops.py``, and the port's own ``cin_product`` and
``cin_contract`` (xDeepFM's CIN, which the reference leaves to XLA). There
is no implementation switch: each call dispatches by the device of its
tensors. CUDA tensors launch the hand-written kernels (K1 for the embedding
bags, K2/K3 for the row updates, K4 for full-sequence attention, K5 for
cache attention, ``csrc/cin.cu`` for the CIN); CPU tensors run
their plain PyTorch versions, and so do ``meta`` tensors at the bags and
attention, which hold no data for a kernel to read (``launch/costs.py``
counts FLOPs on them; the row updates' plain versions select rows by value
and take no meta tensor). A CUDA tensor never reaches a plain version; any
other device raises.
"""
from __future__ import annotations

from repro_torch.kernels import cin
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_embedding as fe
from repro_torch.kernels import fused_update as fu
from repro_torch.sharding.policy import EmbeddingPlan


def fused_embedding_bag(pool, indices, weights=None, *, plan):
    """Multi-table fused embedding bag (one call for all tables).

    pool (R, D) row-concatenated tables, or the (n_ps * max_range, D) view of
    the padded store under ``plan.layout``; indices (B, T, H) per-table-local
    rows; weights (B, T, H)? -> (B, T, D). ``plan`` is an ``EmbeddingPlan``.
    The backward dedupes and scatters sparse row gradients.
    """
    return fe.fused_embedding_bag(pool, indices, weights, plan=plan)


def embedding_bag(table, indices, weights=None, *, plan=None):
    """Single-table embedding bag. table (R, D); indices (B, n);
    weights (B, n)? -> (B, D).

    ``fused_embedding_bag`` with one table (T=1), so it shares the combiner
    semantics (weights apply before sum/mean/max), K1 and the sparse
    backward. ``plan`` is an ``EmbeddingPlan``; ``None`` is the default
    plan (sum, no offsets, no cache). The reference's loose ``combiner=``
    keyword, a deprecated shim, has no counterpart: pass it in ``plan``.
    """
    out = fused_embedding_bag(
        table, indices[:, None, :],
        None if weights is None else weights[:, None, :],
        plan=EmbeddingPlan() if plan is None else plan)
    return out[:, 0]


def sparse_row_grads(pool, indices, g, weights=None, *, plan):
    """Fused sparse backward: bag cotangents → deduped COO row gradients.

    Returns ``(rows, vals, dweights)``; scattering ``vals`` at ``rows``
    reproduces the dense pool gradient bit for bit, and ``(rows, vals)``
    feed ``fused_row_update`` directly.
    """
    return fe.sparse_row_grads(pool, indices, g, weights, plan=plan)


def fused_row_update(params, rows, vals, *state, kind, **hyper):
    """Row-wise optimizer update on deduped COO row grads, in place.

    ``state`` holds the moment pools in the params' row space: ``(acc,)``
    for ``kind="adagrad"``, ``(m, v)`` for ``kind="adam"``. Returns the
    updated ``(params, *state)`` (the same tensors).
    """
    if kind == "adagrad":
        (acc,) = state
        return fu.adagrad_row_update(params, acc, rows, vals, **hyper)
    if kind == "adam":
        m, v = state
        return fu.adam_row_update(params, m, v, rows, vals, **hyper)
    raise ValueError(f"unknown row-update kind: {kind!r}")


def cin_product(xk, x0):
    """A CIN layer's outer products, xk (B, H, D) and x0 (B, m, D) ->
    ``z`` (B*D, H*m), ``z[b*D + d, h*m + j] = xk[b, h, d] * x0[b, j, d]``:
    the operand of ``torch.mm`` with the layer's (H*m, n) weight."""
    return cin.cin_product(xk, x0)


def cin_contract(gz, xk, x0):
    """The cotangents ``(gxk, gx0)`` of ``xk`` and ``x0`` from ``gz``
    (B*D, H*m), the cotangent of ``cin_product(xk, x0)``."""
    return cin.cin_contract(gz, xk, x0)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=0.0,
                    q_offset=0):
    """Full-sequence attention. q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) ->
    (B, Sq, Hq, D); query ``i`` sits at position ``q_offset + i``."""
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, cache_pos, pos, *, window=None,
                     softcap=0.0):
    """One-token attention over a KV cache. q (B, 1, Hq, D); caches
    (B, L, Hkv, D); cache_pos (B, L) (-1 = empty); pos (B,)."""
    return da.decode_attention(q, k_cache, v_cache, cache_pos, pos,
                               window=window, softcap=softcap)
