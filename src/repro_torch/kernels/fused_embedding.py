"""Fused multi-table embedding engine: hot-row encoding, K1 forward, sparse VJP.

Port of ``repro/kernels/fused_embedding.py``. All ``T`` tables share the
width ``D`` and are concatenated row-wise into one pool ``(sum(rows), D)``
addressed by static per-table ``offsets``; one call pools every table.

Padded layout: with a ``PaddedLayout`` the pool is the ``(n_ps *
max_range, D)`` view of the padded store. Lookups arrive as flat pooled rows
and are translated to padded rows here, on the forward and in the backward.

Hot-row cache: the hot rows of table ``t`` are its leading local ids
``[0, table_hot[t])``. The forward gathers them from the pool into a
``(sum(table_hot), D)`` cache and encodes hot lookups as
``-(cache_slot + 1)``; on Hopper the packed prefix stays resident in L2.
Output is bit-identical with the cache on or off.

Forward: ``embedding_bag_forward`` launches K1 (``csrc/fused_embedding.cu``)
on CUDA tensors, on the route ``bag_route`` picks from the shape and the
arrays' alignment and the grid ``bag_plan`` sizes, and runs its plain
version, ``embedding_bag_plain``, on CPU tensors. Backward
(``torch.autograd.Function``): per-lookup row cotangents, a deterministic
dedupe (stable sort + sequential segment sum) and one scatter into the
unique rows, shared with ``sparse_row_grads``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import cuda_lib

COMBINERS = ("sum", "mean", "max")
_COMBINER_CODE = {"sum": 0, "mean": 1, "max": 2}


def table_offsets(table_rows: Sequence[int]) -> Tuple[int, ...]:
    """Exclusive cumulative row offsets for a pooled-table layout."""
    offs, acc = [], 0
    for r in table_rows:
        offs.append(acc)
        acc += int(r)
    return tuple(offs)


def cache_slot_offsets(table_hot: Sequence[int]) -> Tuple[int, ...]:
    """Cache slot where each table's hot rows begin."""
    return table_offsets(table_hot)


def hot_row_ids(offsets: Sequence[int], table_hot: Sequence[int]) -> np.ndarray:
    """Flat pool row ids mirrored by the cache, in cache-slot order (int64)."""
    parts = [np.arange(o, o + k, dtype=np.int64)
             for o, k in zip(offsets, table_hot) if k > 0]
    if not parts:
        return np.zeros((0,), np.int64)
    return np.concatenate(parts)


def translate_rows(rows: torch.Tensor, layout) -> torch.Tensor:
    """Flat pooled rows → rows of the flattened padded pool.

    The tensor twin of ``PaddedLayout.flat_to_padded``: the shard is the
    rightmost start not above the row (empty shards are never selected),
    rebased to ``shard * max_range + slot``. Same shape and dtype as
    ``rows``.
    """
    starts = torch.as_tensor(layout.shard_starts, dtype=rows.dtype,
                             device=rows.device)
    shard = (torch.searchsorted(starts, rows.contiguous(), right=True) - 1
             ).clamp_(0, layout.n_ps - 1)
    return (shard * layout.max_range + rows - starts[shard]).to(rows.dtype)


def encode_hot_indices(idx: torch.Tensor, offsets: Sequence[int],
                       table_hot: Sequence[int]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route each lookup: hot rows -> ``-(cache_slot+1)``, cold -> flat row.

    Encoding always happens in the FLAT id space; under a padded layout
    only the cold entries are rebased afterwards.

    Args:
      idx:       (B, T, H) flat global index tensor (offsets applied).
      offsets:   per-table flat-pool start rows.
      table_hot: per-table hot-prefix sizes.

    Returns ``(encoded, hit)``.
    """
    def col(vals):
        return torch.as_tensor(vals, dtype=idx.dtype,
                               device=idx.device)[None, :, None]

    local = idx - col(offsets)
    hit = local < col(table_hot)
    slot = col(cache_slot_offsets(table_hot)) + local
    return torch.where(hit, -slot - 1, idx), hit


# ---------------------------------------------------------------------------
# K1: the forward kernel and its plain version
# ---------------------------------------------------------------------------
def embedding_bag_plain(pool: torch.Tensor, enc: torch.Tensor,
                        weights: Optional[torch.Tensor],
                        cache: Optional[torch.Tensor],
                        combiner: str) -> torch.Tensor:
    """Plain PyTorch version of K1, with the kernel's operation order.

    Args:
      pool:     (R, D) store.
      enc:      (B, T, H) int encoded lookups: with a cache, ``v < 0`` reads
                cache slot ``-v-1`` clamped to ``K-1``; ``v >= 0`` reads pool
                row ``v`` clamped to ``R-1``. With no cache (``None`` or
                ``K = 0``) a negative ``v`` reads pool row 0, as the
                reference's Pallas kernel does (``jnp.clip(v, 0, R - 1)``).
      weights:  optional (B, T, H) f32 per-lookup weights, applied first.
      cache:    optional (K, D) hot-row cache.
      combiner: "sum" | "mean" (sum / H) | "max".

    Returns (B, T, D) in the pool dtype. Lookups are combined one after the
    other in order ``j = 0..H-1``, as K1 does, so the two agree bit for bit.
    """
    B, T, H = enc.shape
    R, D = pool.shape
    flat = enc.reshape(-1).long()
    rows = pool.index_select(0, flat.clamp(0, R - 1))
    if cache is not None and cache.shape[0] > 0:
        slot = (-flat - 1).clamp(0, cache.shape[0] - 1)
        rows = torch.where((flat < 0)[:, None], cache.index_select(0, slot),
                           rows)
    rows = rows.reshape(B, T, H, D).float()
    if weights is not None:
        rows = rows * weights.reshape(B, T, H, 1).float()
    out = rows[:, :, 0]
    for j in range(1, H):
        x = rows[:, :, j]
        out = torch.where(x > out, x, out) if combiner == "max" else out + x
    if combiner == "mean":
        # a tensor divisor: PyTorch's CUDA division by a Python number
        # multiplies by its reciprocal, which for an H that is no power of
        # two is not the correctly rounded quotient that K1 computes
        out = out / torch.full((), H, dtype=out.dtype, device=out.device)
    return out.to(pool.dtype)


# K1's routes and launch geometry (csrc/fused_embedding.cu): the main
# path's shapes have H = 4 lookups per bag (every DLRM config's multi_hot)
# on the deep D=16 pool and the wide D=1 pool.
BAG_H = 4
BAG_THREADS = {"vector": 256, "wide": 64, "generic": 256}   # per block
BAG_LANES = {"vector": 4, "wide": 1, "generic": 1}          # threads per bag
_ROUTE_CODE = {"generic": 0, "vector": 1, "wide": 2}


def bag_route(D: int, H: int, *arrays: torch.Tensor) -> str:
    """K1's route for a width ``D``, ``H`` lookups per bag and the arrays
    it reads and writes (pool, indices, output, and the weights and cache
    where given): ``"vector"`` for D=16, H=4 (4 lanes per bag, float4 row
    pieces, one int4 of indices), ``"wide"`` for D=1, H=4 (a bag per
    thread, one int4 of indices), both only when every array starts on 16
    bytes; ``"generic"`` otherwise."""
    if H == BAG_H and D in (16, 1) and all(a.data_ptr() % 16 == 0
                                           for a in arrays):
        return "vector" if D == 16 else "wide"
    return "generic"


def bag_plan(n_bags: int, route: str) -> int:
    """Blocks of ``BAG_THREADS[route]`` threads for K1 over ``n_bags``
    bags: the grid covers the work, ``BAG_LANES[route]`` threads a bag, one
    launch. A function of the shape alone; 0 when there is nothing to do."""
    if n_bags <= 0:
        return 0
    return -(-n_bags * BAG_LANES[route] // BAG_THREADS[route])


def embedding_bag_cuda(pool: torch.Tensor, enc: torch.Tensor,
                       weights: Optional[torch.Tensor],
                       cache: Optional[torch.Tensor],
                       combiner: str) -> torch.Tensor:
    """Launch K1 (``csrc/fused_embedding.cu``) on CUDA tensors.

    Replaces the TPU kernel ``_fused_kernel`` of
    ``repro/kernels/fused_embedding.py``. Bound by bytes: a full-width
    Wide&Deep batch reads ~23,400 distinct cold rows of the D=16 pool, the
    hot rows and the indices and writes the output, 2.57 MB, 0.766 us at
    3.35 TB/s; in practice by the latency of two dependent loads (index,
    then row). ``bag_route`` picks the route: at D=16 4 lanes per bag with
    float4 row pieces, at D=1 a bag per thread, each with the bag's 4
    indices in one int4 and all its row loads in flight before the first
    combine; any other shape a bag per thread. ``bag_plan`` sizes the grid.
    One launch per call with bags; none for ``B * T = 0``.

    Same contract as ``embedding_bag_plain`` (a negative index with no
    cache reads pool row 0, an index ``>= R`` reads row ``R-1``); f32 pool,
    int32 indices, all operands contiguous on one CUDA device. Raises on
    anything else, or if the launch fails.
    """
    if combiner not in _COMBINER_CODE:
        raise ValueError(f"unknown combiner: {combiner!r}")
    if not pool.is_cuda or pool.dtype != torch.float32 or pool.dim() != 2 \
            or not pool.is_contiguous():
        raise ValueError("K1: pool must be a contiguous (R, D) float32 CUDA "
                         f"tensor, got {pool.dtype} {tuple(pool.shape)} on "
                         f"{pool.device}")
    if enc.device != pool.device or enc.dtype != torch.int32 \
            or enc.dim() != 3 or not enc.is_contiguous():
        raise ValueError("K1: indices must be contiguous (B, T, H) int32 on "
                         f"the pool's device, got {enc.dtype} "
                         f"{tuple(enc.shape)} on {enc.device}")
    B, T, H = enc.shape
    R, D = pool.shape
    if weights is not None and (
            weights.device != pool.device or weights.dtype != torch.float32
            or tuple(weights.shape) != (B, T, H)
            or not weights.is_contiguous()):
        raise ValueError("K1: weights must be contiguous (B, T, H) float32 "
                         "on the pool's device")
    K = 0 if cache is None else cache.shape[0]
    if cache is not None and (
            cache.device != pool.device or cache.dtype != torch.float32
            or cache.dim() != 2 or cache.shape[1] != D or K == 0
            or not cache.is_contiguous()):
        raise ValueError("K1: cache must be a contiguous non-empty (K, D) "
                         "float32 tensor on the pool's device")
    out = torch.empty((B, T, D), dtype=pool.dtype, device=pool.device)
    if out.numel() == 0:
        return out
    route = bag_route(D, H, pool, enc, out,
                      *(x for x in (weights, cache) if x is not None))
    lib = cuda_lib.load()
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    status = lib.repro_fused_embedding_bag_f32(
        pool.data_ptr(), R, enc.data_ptr(),
        None if weights is None else weights.data_ptr(),
        None if cache is None else cache.data_ptr(), K,
        out.data_ptr(), B * T, H, D, _COMBINER_CODE[combiner],
        _ROUTE_CODE[route], bag_plan(B * T, route), stream)
    cuda_lib.check(status, "fused_embedding_bag")
    cuda_lib.LAUNCHES["fused_embedding_bag"] += 1
    return out


def embedding_bag_forward(pool, enc, weights, cache, combiner):
    """K1 on CUDA tensors, its plain version on CPU and meta tensors."""
    if pool.is_cuda:
        return embedding_bag_cuda(pool, enc, weights, cache, combiner)
    if pool.device.type in cuda_lib.PLAIN_DEVICES:
        return embedding_bag_plain(pool, enc, weights, cache, combiner)
    raise ValueError(f"fused_embedding_bag: unsupported device {pool.device}")


# ---------------------------------------------------------------------------
# sparse-gradient aggregation shared by both backward paths
# ---------------------------------------------------------------------------
def dedupe_rows(store_idx: torch.Tensor, g_rows: torch.Tensor,
                num_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deduplicate row cotangents: (N,) rows + (N, D) grads → COO row grads.

    Duplicate store rows are summed into one entry in a deterministic order:
    a stable sort keeps equal rows in their original order, and
    ``torch.segment_reduce`` sums each segment sequentially, on the CPU and
    on CUDA alike. (An ``index_add_`` over duplicate rows would accumulate
    with atomics in an order that changes from run to run on CUDA, and two
    identical steps would no longer give bit-identical pools.) Entry ``j``
    of the result is the ``j``-th distinct row with its summed gradient; the
    tail is the sentinel row ``num_rows`` with zero values, which every
    consumer masks out explicitly. Adds the distinct rows to
    ``cuda_lib.ROW_COUNTS["rows_deduped"]``.

    Returns ``(rows, vals)``: (N,) rows in the dtype of ``store_idx``, (N, D)
    f32 values.
    """
    n = store_idx.shape[0]
    sorted_rows, order = torch.sort(store_idx, stable=True)
    uniq, counts = torch.unique_consecutive(sorted_rows, return_counts=True)
    cuda_lib.ROW_COUNTS["rows_deduped"] += uniq.shape[0]
    summed = torch.segment_reduce(g_rows[order], "sum", lengths=counts,
                                  axis=0)
    rows = store_idx.new_full((n,), num_rows)
    rows[:uniq.shape[0]] = uniq
    vals = g_rows.new_zeros((n, g_rows.shape[1]))
    vals[:uniq.shape[0]] = summed
    return rows, vals


def scatter_rows(rows: torch.Tensor, vals: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    """Deduped COO rows → the dense (num_rows, D) gradient.

    Sentinel rows (``>= num_rows``) are masked out here: JAX's scatter drops
    them silently, while ``index_add_`` raises on them on the CPU and
    device-asserts on CUDA. The live rows are unique, so the add is
    deterministic.
    """
    live = rows < num_rows
    out = vals.new_zeros((num_rows, vals.shape[-1]))
    return out.index_add_(0, rows[live].long(), vals[live])


def _row_cotangents(pool, store_idx, w, g, *, combiner: str, B: int, T: int,
                    H: int):
    """Per-lookup row cotangents of one pooled bag output cotangent ``g``.

    Returns ``(g_rows, dw)``: (B, T, H, D) f32 cotangent per looked-up row
    and the (B, T, H) weight cotangent (None when unweighted).
    """
    D = pool.shape[1]
    if combiner == "max":
        rows = pool.index_select(0, store_idx).reshape(B, T, H, D).float()
        v = rows if w is None else rows * w[..., None]
        m = v.amax(dim=2)                                  # (B, T, D)
        # split the cotangent evenly among tied argmaxes, as jax.grad of
        # jnp.max does (duplicate indices inside a bag are the usual ties)
        tie = (v == m[:, :, None, :]).float()
        tie = tie / tie.sum(dim=2, keepdim=True)
        g_v = g[:, :, None, :] * tie
        dw = None if w is None else (g_v * rows).sum(dim=-1)
        g_rows = g_v if w is None else g_v * w[..., None]
        return g_rows, dw
    g_v = g[:, :, None, :].expand(B, T, H, D)
    if combiner == "mean":
        g_v = g_v / H
    if w is None:
        return g_v, None
    rows = pool.index_select(0, store_idx).reshape(B, T, H, D).float()
    dw = (g_v * rows).sum(dim=-1)
    return g_v * w[..., None], dw


def _flat_lookups(indices: torch.Tensor, offsets) -> torch.Tensor:
    """(B, T, H) local ids + static offsets → (B*T*H,) int32 flat rows."""
    idx = indices.to(torch.int32)
    if offsets is not None:
        idx = idx + torch.as_tensor(offsets, dtype=torch.int32,
                                    device=idx.device)[None, :, None]
    return idx.reshape(-1)


def sparse_row_grads(pool: torch.Tensor, indices: torch.Tensor,
                     g: torch.Tensor, weights: Optional[torch.Tensor] = None,
                     *, plan):
    """Fused sparse backward: bag cotangents → deduped COO row gradients.

    Stops at the deduped ``(rows, vals)`` pair that the row-wise optimizer
    update consumes; ``scatter_rows(rows, vals, R)`` reproduces the dense
    gradient of the autograd path bit for bit (same dedupe, same order).

    Args:
      pool:    (R, D) store (flat, or the padded view under ``plan.layout``).
      indices: (B, T, H) per-table-local lookup rows.
      g:       (B, T, D) cotangent of the fused bag output.
      weights: optional (B, T, H) per-lookup scalars.
      plan:    the ``EmbeddingPlan`` of the forward.

    Returns ``(rows, vals, dweights)``: (B*T*H,) int32 deduped store rows
    with sentinel tail, (B*T*H, D) f32 summed row grads, and the weights
    cotangent (None when unweighted).
    """
    B, T, H = indices.shape
    R = pool.shape[0]
    flat_idx = _flat_lookups(indices, plan.offsets)
    store_idx = flat_idx if plan.layout is None else \
        translate_rows(flat_idx, plan.layout)
    w = None if weights is None else weights.float().reshape(B, T, H)
    g_rows, dw = _row_cotangents(pool, store_idx, w, g.float(),
                                 combiner=plan.combiner, B=B, T=T, H=H)
    rows, vals = dedupe_rows(store_idx, g_rows.reshape(B * T * H, -1), R)
    dweights = None if dw is None else dw.reshape(weights.shape).to(
        weights.dtype)
    return rows, vals, dweights


# ---------------------------------------------------------------------------
# autograd Function: forward launches K1, backward is dedupe + one scatter
# ---------------------------------------------------------------------------
class _Meta(NamedTuple):
    combiner: str
    B: int
    T: int
    H: int
    hot: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]  # offsets, table_hot
    layout: object


def _encode(pool: torch.Tensor, flat_idx: torch.Tensor, meta: _Meta):
    """Encoded (B, T, H) int32 lookups in the store's row space + the cache.

    The cache is gathered from ``pool`` inside the Function's forward, so
    gradients of cached rows reach the pool like those of any other row
    (row ids are preserved). Hot detection speaks FLAT local ids: encode
    first, then translate only the cold entries into the padded space.
    """
    idx = flat_idx.reshape(meta.B, meta.T, meta.H)
    layout = meta.layout
    if meta.hot is None:
        enc = idx if layout is None else translate_rows(idx, layout)
        return enc.contiguous(), None
    offsets, table_hot = meta.hot
    ids = hot_row_ids(offsets, table_hot)
    if layout is not None:      # a table's prefix may straddle two shards
        ids = layout.flat_to_padded(ids)
    cache = pool.index_select(0, torch.as_tensor(ids, device=pool.device))
    enc, _ = encode_hot_indices(idx, offsets, table_hot)
    if layout is not None:
        enc = torch.where(enc < 0, enc,
                          translate_rows(enc.clamp(min=0), layout))
    return enc.contiguous(), cache.contiguous()


class _FusedEmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pool, flat_idx, weights, meta):
        ctx.meta = meta
        ctx.save_for_backward(pool, flat_idx, weights)
        enc, cache = _encode(pool, flat_idx, meta)
        return embedding_bag_forward(pool.contiguous(), enc, weights, cache,
                                     meta.combiner)

    @staticmethod
    def backward(ctx, g):
        meta = ctx.meta
        pool, flat_idx, weights = ctx.saved_tensors
        B, T, H = meta.B, meta.T, meta.H
        R, D = pool.shape
        # gradients land in the store's row space: padded rows under a
        # layout, whose padding slots are never addressed (exactly zero)
        store_idx = flat_idx if meta.layout is None else \
            translate_rows(flat_idx, meta.layout)
        w = None if weights is None else weights.reshape(B, T, H)
        g_rows, dw = _row_cotangents(pool, store_idx, w, g.float(),
                                     combiner=meta.combiner, B=B, T=T, H=H)
        # the dedupe shared with sparse_row_grads makes the dense gradient
        # the bit-exact oracle of the fused row-wise update
        rows, vals = dedupe_rows(store_idx, g_rows.reshape(B * T * H, D), R)
        dpool = scatter_rows(rows, vals, R).to(pool.dtype)
        dweights = None if dw is None else dw.reshape(weights.shape).to(
            weights.dtype)
        return dpool, None, dweights, None


def _meta_for(pool: torch.Tensor, indices: torch.Tensor, plan) -> _Meta:
    """Validate one call against its plan; the Function's static metadata."""
    combiner, offsets, layout = plan.combiner, plan.offsets, plan.layout
    assert combiner in COMBINERS, combiner
    assert indices.dim() == 3, f"indices must be (B, T, H), got {indices.shape}"
    B, T, H = indices.shape
    if layout is not None:
        assert pool.shape[0] == layout.padded_rows, \
            (pool.shape, layout.padded_rows)
    if offsets is not None:
        assert len(offsets) == T, (len(offsets), T)
    hot = None
    if plan.table_hot is not None and sum(plan.table_hot) > 0:
        assert len(plan.table_hot) == T, (len(plan.table_hot), T)
        assert offsets is not None or T == 1, \
            "table_hot with T > 1 requires offsets"
        hot = (tuple(offsets) if offsets is not None else (0,) * T,
               tuple(plan.table_hot))
    return _Meta(combiner, B, T, H, hot, layout)


def kernel_inputs(pool: torch.Tensor, indices: torch.Tensor, plan):
    """The ``(encoded indices, cache)`` that K1 receives for
    ``fused_embedding_bag(pool, indices, plan=plan)``."""
    meta = _meta_for(pool, indices, plan)
    return _encode(pool, _flat_lookups(indices, plan.offsets), meta)


def fused_embedding_bag(pool: torch.Tensor, indices: torch.Tensor,
                        weights: Optional[torch.Tensor] = None, *,
                        plan) -> torch.Tensor:
    """Pool per-table embedding bags for all tables in one call.

    Args:
      pool:    flat (R, D) row-concatenation of all tables, or under
               ``plan.layout`` the (n_ps * max_range, D) padded view.
      indices: (B, T, H) per-table-local (or, with ``plan.offsets=None``,
               global flat) rows, always in the FLAT id space.
      weights: optional (B, T, H) per-lookup scalars, applied before the
               combiner.
      plan:    the ``EmbeddingPlan`` (offsets, combiner, table_hot, layout).

    Returns (B, T, D) in the pool dtype; gradients flow to ``pool`` and
    ``weights``. Numerics are identical for every cache plan and layout.
    """
    meta = _meta_for(pool, indices, plan)
    flat_idx = _flat_lookups(indices, plan.offsets)
    w = None if weights is None else weights.float().contiguous()
    return _FusedEmbeddingBag.apply(pool, flat_idx, w, meta)
