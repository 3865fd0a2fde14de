"""Public kernel entry points of the DLRM training path.

Port of ``fused_embedding_bag``, ``sparse_row_grads`` and
``fused_row_update`` of ``repro/kernels/ops.py``. There is no
implementation switch: each call dispatches by the device of its tensors.
CUDA tensors launch the hand-written kernels (K1 for the embedding bag,
K2/K3 for the row updates); CPU tensors run their plain PyTorch versions.
A CUDA tensor never reaches a plain version.
"""
from __future__ import annotations

from repro_torch.kernels import fused_embedding as fe
from repro_torch.kernels import fused_update as fu


def fused_embedding_bag(pool, indices, weights=None, *, plan):
    """Multi-table fused embedding bag (one call for all tables).

    pool (R, D) row-concatenated tables, or the (n_ps * max_range, D) view of
    the padded store under ``plan.layout``; indices (B, T, H) per-table-local
    rows; weights (B, T, H)? -> (B, T, D). ``plan`` is an ``EmbeddingPlan``.
    The backward dedupes and scatters sparse row gradients.
    """
    return fe.fused_embedding_bag(pool, indices, weights, plan=plan)


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
