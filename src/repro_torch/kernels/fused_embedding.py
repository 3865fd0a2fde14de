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

Ragged bags (``plan.bag_sizes``): table ``t`` has ``H_t`` lookups a sample,
and the indices are sample-major ``(B, sum_t H_t)``, bag ``(b, t)`` at
``b * sum + sum(H[:t])`` (the fixed-length-per-feature form of TorchRec's
jagged tensor). When every ``H_t`` is equal the lookups are laid out as
``(B, T, H)`` indices are, and the call takes their path; otherwise K1
reads the bag starts (``bag_starts``) and the dedupe reads each lookup's
bag through the plan's column-to-table map (``lookup_tables``).

Forward: ``embedding_bag_forward`` launches K1 (``csrc/fused_embedding.cu``)
on CUDA tensors, on the route ``bag_route`` picks from the shape and the
arrays' alignment and the grid ``bag_plan`` sizes, and runs its plain
version, ``embedding_bag_plain``, on CPU tensors. Backward
(``torch.autograd.Function``): a deterministic dedupe (stable sort, then
each segment summed in order: the segment sum of ``csrc/segment_sum.cu``
on CUDA tensors, ``torch.segment_reduce`` on CPU tensors) of the bag
cotangents (unweighted ``sum``/``mean``) or the per-lookup row cotangents
(``max``, weighted), and one scatter into the unique rows, shared with
``sparse_row_grads``.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import cuda_lib

COMBINERS = ("sum", "mean", "max")
_COMBINER_CODE = {"sum": 0, "mean": 1, "max": 2}


# small tensors that depend only on the plan, one per (key, device): a host
# list copied to a CUDA device is a blocking copy that drains the stream, and
# the step would make 16 of them (offsets, shard starts, hot-row maps)
_STATIC: Dict[tuple, torch.Tensor] = {}
_STATIC_MAX = 1024


def static_tensor(key: tuple, device, make: Callable[[], object],
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.as_tensor(make(), dtype=dtype, device=device)``, made once
    for each ``(key, dtype, device)`` and kept: ``key`` must determine what
    ``make`` returns. Callers never write into the result."""
    k = (key, dtype, torch.device(device))
    t = _STATIC.get(k)
    if t is None:
        if len(_STATIC) >= _STATIC_MAX:
            _STATIC.clear()
        with torch.inference_mode(False):
            t = torch.as_tensor(make(), dtype=dtype, device=device)
        _STATIC[k] = t
    return t


def static_ints(values: Tuple[int, ...], dtype: torch.dtype,
                device) -> torch.Tensor:
    """The tuple ``values`` as a ``dtype`` tensor on ``device``, kept."""
    return static_tensor(values, device, lambda: values, dtype)


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
    starts = static_ints(layout.shard_starts, rows.dtype, rows.device)
    shard = (torch.searchsorted(starts, rows.contiguous(), right=True) - 1
             ).clamp_(0, layout.n_ps - 1)
    return (shard * layout.max_range + rows - starts[shard]).to(rows.dtype)


@functools.lru_cache(maxsize=64)
def bag_starts(sizes: Tuple[int, ...]) -> Tuple[int, ...]:
    """The ``T + 1`` column starts of ragged bags of ``sizes`` lookups: bag
    ``(b, t)`` is columns ``[starts[t], starts[t + 1])`` of sample ``b``."""
    return table_offsets(tuple(sizes) + (0,))


@functools.lru_cache(maxsize=64)
def lookup_tables(sizes: Tuple[int, ...]) -> Tuple[int, ...]:
    """The table of each of the ``sum(sizes)`` columns of ragged bags."""
    return tuple(t for t, h in enumerate(sizes) for _ in range(int(h)))


@functools.lru_cache(maxsize=256)
def per_column(values: Tuple[int, ...],
               sizes: Optional[Tuple[int, ...]]) -> Tuple[int, ...]:
    """Per-table ``values`` repeated for each column of ragged bags of
    ``sizes`` lookups (``values`` itself for ``sizes=None``); both
    tuples."""
    if sizes is None:
        return tuple(values)
    return tuple(int(values[t]) for t in lookup_tables(sizes))


def column_values(values: Sequence[int], ndim: int,
                  sizes: Optional[Sequence[int]] = None) -> np.ndarray:
    """Per-table int64 ``values`` broadcast against numpy ids of ``ndim``
    dimensions: ``(1, T, 1)`` for (B, T, H), ``(1, sum(sizes))`` for
    ragged bags of ``sizes`` lookups (``ndim`` 2)."""
    if ndim == 3:
        return np.asarray(values, np.int64)[None, :, None]
    return np.asarray(per_column(tuple(values), tuple(sizes)),
                      np.int64)[None, :]


def _columns(vals: Sequence[int], sizes: Optional[Sequence[int]],
             like: torch.Tensor) -> torch.Tensor:
    """Per-table ``vals`` broadcast against ``like``: ``(1, T, 1)`` for
    ``(B, T, H)`` indices, ``(1, sum(sizes))`` for ragged ones, kept."""
    if sizes is None:
        return static_ints(tuple(vals), like.dtype, like.device)[None, :, None]
    return static_ints(per_column(tuple(vals), tuple(sizes)), like.dtype,
                       like.device)[None, :]


def encode_hot_indices(idx: torch.Tensor, offsets: Sequence[int],
                       table_hot: Sequence[int],
                       sizes: Optional[Sequence[int]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route each lookup: hot rows -> ``-(cache_slot+1)``, cold -> flat row.

    Encoding always happens in the FLAT id space; under a padded layout
    only the cold entries are rebased afterwards.

    Args:
      idx:       (B, T, H) flat global index tensor (offsets applied), or
                 (B, sum(sizes)) for ragged bags of ``sizes`` lookups.
      offsets:   per-table flat-pool start rows.
      table_hot: per-table hot-prefix sizes.
      sizes:     per-table lookups of ragged bags, or None.

    Returns ``(encoded, hit)``.
    """
    def col(vals):
        return _columns(vals, sizes, idx)

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
                        combiner: str,
                        sizes: Optional[Sequence[int]] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of K1, with the kernel's operation order.

    Args:
      pool:     (R, D) store.
      enc:      (B, T, H) int encoded lookups, or (B, sum(sizes)) ragged
                bags of ``sizes`` lookups: with a cache, ``v < 0`` reads
                cache slot ``-v-1`` clamped to ``K-1``; ``v >= 0`` reads pool
                row ``v`` clamped to ``R-1``. With no cache (``None`` or
                ``K = 0``) a negative ``v`` reads pool row 0, as the
                reference's Pallas kernel does (``jnp.clip(v, 0, R - 1)``).
      weights:  optional f32 per-lookup weights shaped like ``enc``,
                applied first.
      cache:    optional (K, D) hot-row cache.
      combiner: "sum" | "mean" (sum / H) | "max".

    Returns (B, T, D) in the pool dtype. Lookups are combined one after the
    other in order ``j = 0..H-1``, as K1 does, so the two agree bit for bit.
    """
    R, D = pool.shape
    flat = enc.reshape(-1).long()
    rows = pool.index_select(0, flat.clamp(0, R - 1))
    if cache is not None and cache.shape[0] > 0:
        slot = (-flat - 1).clamp(0, cache.shape[0] - 1)
        rows = torch.where((flat < 0)[:, None], cache.index_select(0, slot),
                           rows)
    rows = rows.reshape(*enc.shape, D).float()
    if weights is not None:
        rows = rows * weights.reshape(*enc.shape, 1).float()
    if sizes is None:
        return _combine_plain(rows, combiner).to(pool.dtype)
    starts = bag_starts(tuple(sizes))
    return torch.stack(
        [_combine_plain(rows[:, a:b], combiner)
         for a, b in zip(starts, starts[1:])], dim=1).to(pool.dtype)


def _combine_plain(rows: torch.Tensor, combiner: str) -> torch.Tensor:
    """(..., H, D) looked-up rows -> (..., D), combined in order."""
    H = rows.shape[-2]
    out = rows[..., 0, :]
    for j in range(1, H):
        x = rows[..., j, :]
        out = torch.where(x > out, x, out) if combiner == "max" else out + x
    if combiner == "mean":
        # a tensor divisor: PyTorch's CUDA division by a Python number
        # multiplies by its reciprocal, which for an H that is no power of
        # two is not the correctly rounded quotient that K1 computes
        out = out / torch.full((), H, dtype=out.dtype, device=out.device)
    return out


# K1's routes and launch geometry (csrc/fused_embedding.cu): Wide&Deep's
# and xDeepFM's shapes have H = 4 lookups per bag on the deep D=16 pool and
# the wide D=1 pool; DLRM-DCNv2's have ragged bags of 1 to 100 lookups at
# D=128.
BAG_H = 4
BAG_D128 = 128
BAG_THREADS = {"vector": 256, "wide": 64, "generic": 256,   # per block
               "d128": 256}
BAG_LANES = {"vector": 4, "wide": 1, "generic": 1,          # threads per bag
             "d128": 32}
_ROUTE_CODE = {"generic": 0, "vector": 1, "wide": 2, "d128": 3}


def bag_route(D: int, H: int, *arrays: torch.Tensor) -> str:
    """K1's route for a width ``D``, ``H`` lookups per bag (0: ragged bags)
    and the arrays it reads and writes (pool, indices, output, and the
    weights and cache where given): ``"vector"`` for D=16, H=4 (4 lanes
    per bag, float4 row pieces, one int4 of indices), ``"wide"`` for D=1,
    H=4 (a bag per thread, one int4 of indices), ``"d128"`` for D=128 and
    any bags (a warp per bag, a float4 a lane, 8 rows in flight), each only
    when every array starts on 16 bytes; ``"generic"`` otherwise."""
    aligned = all(a.data_ptr() % 16 == 0 for a in arrays)
    if H == BAG_H and D in (16, 1) and aligned:
        return "vector" if D == 16 else "wide"
    if D == BAG_D128 and aligned:
        return "d128"
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
                       combiner: str,
                       sizes: Optional[Sequence[int]] = None
                       ) -> torch.Tensor:
    """Launch K1 (``csrc/fused_embedding.cu``) on CUDA tensors.

    Replaces the TPU kernel ``_fused_kernel`` of
    ``repro/kernels/fused_embedding.py``. Bound by bytes: a full-width
    Wide&Deep batch reads ~23,400 distinct cold rows of the D=16 pool, the
    hot rows and the indices and writes the output, 2.57 MB, 0.766 us at
    3.35 TB/s; in practice by the latency of two dependent loads (index,
    then row). ``bag_route`` picks the route: at D=16 4 lanes per bag with
    float4 row pieces, at D=1 a bag per thread, each with the bag's 4
    indices in one int4 and all its row loads in flight before the first
    combine; at D=128 (DLRM-DCNv2) a warp per bag, a float4 of the row a
    lane, the bag's indices loaded 32 at a time and handed out by shuffles,
    8 rows in flight before they are combined in order; any other shape a
    bag per thread. Ragged bags (``sizes``, ``enc`` (B, sum(sizes))) read
    each bag's start and length from the plan's ``bag_starts``, kept on the
    card; they take the D=128 route or the generic one. ``bag_plan`` sizes
    the grid. One launch per call with bags; none for ``B * T = 0``. Adds
    one to ``LAUNCHES["fused_embedding_bag"]``, and to
    ``["embedding_bag_d128"]`` or ``["embedding_bag_ragged"]`` (ragged
    bags on the generic route) on those routes.

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
    want = 3 if sizes is None else 2
    if enc.device != pool.device or enc.dtype != torch.int32 \
            or enc.dim() != want or not enc.is_contiguous() \
            or (sizes is not None and enc.shape[1] != sum(sizes)):
        raise ValueError("K1: indices must be contiguous (B, T, H) int32 on "
                         "the pool's device ((B, sum(sizes)) for ragged "
                         f"bags), got {enc.dtype} "
                         f"{tuple(enc.shape)} on {enc.device}")
    if sizes is None:
        B, T, H = enc.shape
        L = T * H
    else:
        (B, L), T, H = enc.shape, len(sizes), 0
    R, D = pool.shape
    if weights is not None and (
            weights.device != pool.device or weights.dtype != torch.float32
            or weights.shape != enc.shape or not weights.is_contiguous()):
        raise ValueError("K1: weights must be contiguous float32 shaped "
                         "like the indices on the pool's device")
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
    starts = None if sizes is None else static_ints(
        bag_starts(tuple(sizes)), torch.int32, pool.device)
    lib = cuda_lib.load()
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    status = lib.repro_fused_embedding_bag_f32(
        pool.data_ptr(), R, enc.data_ptr(),
        None if weights is None else weights.data_ptr(),
        None if cache is None else cache.data_ptr(), K,
        out.data_ptr(), B * T, H, D, _COMBINER_CODE[combiner],
        _ROUTE_CODE[route], bag_plan(B * T, route),
        None if starts is None else starts.data_ptr(), T, L, stream)
    cuda_lib.check(status, "fused_embedding_bag")
    cuda_lib.LAUNCHES["fused_embedding_bag"] += 1
    if route == "d128":
        cuda_lib.LAUNCHES["embedding_bag_d128"] += 1
    elif sizes is not None:
        cuda_lib.LAUNCHES["embedding_bag_ragged"] += 1
    return out


def embedding_bag_forward(pool, enc, weights, cache, combiner, sizes=None):
    """K1 on CUDA tensors, its plain version on CPU and meta tensors."""
    if pool.is_cuda:
        return embedding_bag_cuda(pool, enc, weights, cache, combiner, sizes)
    if pool.device.type in cuda_lib.PLAIN_DEVICES:
        return embedding_bag_plain(pool, enc, weights, cache, combiner, sizes)
    raise ValueError(f"fused_embedding_bag: unsupported device {pool.device}")


# ---------------------------------------------------------------------------
# sparse-gradient aggregation shared by both backward paths
# ---------------------------------------------------------------------------
# the widest row the segment sum takes (one stage of its ring holds a row)
SEGMENT_MAX_D = 16384


def segment_sum_cuda(order: torch.Tensor, counts: torch.Tensor,
                     src: torch.Tensor, H: int, vals: torch.Tensor,
                     route: str, sizes: Optional[Sequence[int]] = None
                     ) -> None:
    """Launch the segment sum (``csrc/segment_sum.cu``) on CUDA tensors.

    Row ``j < n_uniq`` of ``vals`` becomes ``0 + src[bag(order[k])] + ...``
    over segment ``j``'s sorted entries ``k`` in order: the bits of
    ``torch.segment_reduce(src[bag(order)], "sum", lengths=counts)``, where
    ``bag(o) = o // H``, or for ragged bags of ``sizes`` lookups (``H`` 0)
    ``(o // L) * T + lookup_tables(sizes)[o % L]`` with ``L = sum(sizes)``,
    read through the plan's column-to-table map kept on the card.
    ``order`` is the (N,) int64 stable-sort permutation, ``counts`` the
    (n_uniq,) int64 segment lengths, ``src`` a contiguous (rows, D) f32
    tensor, ``vals`` the zeroed contiguous (N, D) f32 output. Replaces no
    TPU kernel (the reference sums in XLA); bound by the longest segment's
    add chain (~146 k adds a column on Wide&Deep, ~0.3 ms), then bytes.
    A thread per (segment, 4 columns) sums short segments; blocks of a
    fixed grid stream the long ones through shared memory. Two launches
    and no host sync; adds one to ``LAUNCHES[f"segment_sum_{route}"]``.
    Raises on anything else, or if a launch fails.
    """
    n_uniq, D = counts.shape[0], src.shape[1]
    dev = src.device
    if not src.is_cuda or src.dtype != torch.float32 or src.dim() != 2 \
            or not src.is_contiguous() or D > SEGMENT_MAX_D:
        raise ValueError("segment_sum: src must be a contiguous (rows, D) "
                         f"float32 CUDA tensor with D <= {SEGMENT_MAX_D}, "
                         f"got {src.dtype} {tuple(src.shape)} on {dev}")
    if order.device != dev or order.dtype != torch.int64 \
            or order.dim() != 1 or not order.is_contiguous() \
            or order.shape[0] >= 2 ** 31:
        raise ValueError("segment_sum: order must be a contiguous (N,) int64 "
                         "tensor on src's device, N < 2**31")
    N = order.shape[0]
    if sizes is None:
        T, L = 0, 0
        if src.shape[0] * H != N:
            raise ValueError(f"segment_sum: {N} lookups are not {H} for "
                             f"each of src's {src.shape[0]} rows")
    else:
        T, L = len(sizes), sum(sizes)
        if N % L or src.shape[0] != N // L * T:
            raise ValueError(f"segment_sum: {N} lookups are not whole "
                             f"samples of {L} for src's {src.shape[0]} bags")
    if counts.device != dev or counts.dtype != torch.int64:
        raise ValueError("segment_sum: counts must be int64 on src's device")
    if vals.device != dev or vals.dtype != torch.float32 \
            or tuple(vals.shape) != (N, D) or not vals.is_contiguous():
        raise ValueError("segment_sum: vals must be a contiguous (N, D) "
                         "float32 tensor on src's device")
    if n_uniq == 0 or D == 0:
        return
    cols = None if sizes is None else static_ints(
        lookup_tables(tuple(sizes)), torch.int32, dev)
    ends = counts.cumsum(0)
    work = torch.zeros(3, dtype=torch.int32, device=dev)
    long_ids = torch.empty(n_uniq, dtype=torch.int32, device=dev)
    vec = D % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in (src, vals))
    lib = cuda_lib.load()
    status = lib.repro_segment_sum_f32(
        order.data_ptr(), ends.data_ptr(), src.data_ptr(), n_uniq, D,
        max(H, 1), None if cols is None else cols.data_ptr(), L, T,
        vals.data_ptr(), work.data_ptr(), long_ids.data_ptr(), int(vec),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "segment_sum")
    cuda_lib.LAUNCHES[f"segment_sum_{route}"] += 1


def lookup_bags(lookups: torch.Tensor, H: int,
                sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The bag of each flat lookup index: ``lookups // H``, or for ragged
    bags of ``sizes`` lookups ``(o // L) * T + lookup_tables(sizes)[o % L]``
    (``L = sum(sizes)``)."""
    if sizes is None:
        return lookups if H == 1 else lookups // H
    L = sum(sizes)
    cols = static_ints(lookup_tables(tuple(sizes)), lookups.dtype,
                       lookups.device)
    return lookups // L * len(sizes) + cols[lookups % L]


def _dedupe(store_idx: torch.Tensor, src: torch.Tensor, H: int,
            num_rows: int, route: str,
            sizes: Optional[Sequence[int]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dedupe of ``dedupe_rows`` (H = 1) and ``dedupe_bags`` (H > 1,
    or ragged bags of ``sizes``): lookup ``i`` carries
    ``src[lookup_bags(i)]``."""
    n = store_idx.shape[0]
    src = src.contiguous()
    sorted_rows, order = torch.sort(store_idx, stable=True)
    uniq, counts = torch.unique_consecutive(sorted_rows, return_counts=True)
    n_uniq = uniq.shape[0]
    cuda_lib.ROW_COUNTS["rows_deduped"] += n_uniq
    rows = store_idx.new_full((n,), num_rows)
    rows[:n_uniq] = uniq
    vals = src.new_zeros((n, src.shape[1]))
    if src.is_cuda:
        segment_sum_cuda(order, counts, src, H, vals, route, sizes)
    else:
        vals[:n_uniq] = torch.segment_reduce(
            src[lookup_bags(order, H, sizes)], "sum", lengths=counts, axis=0)
    return rows, vals


def dedupe_rows(store_idx: torch.Tensor, g_rows: torch.Tensor,
                num_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deduplicate row cotangents: (N,) rows + (N, D) grads → COO row grads.

    Duplicate store rows are summed into one entry in a deterministic order:
    a stable sort keeps equal rows in their original order, and each
    segment is summed in that order from zero, one add after another: by
    the segment sum (``segment_sum_cuda``) on CUDA tensors and by
    ``torch.segment_reduce`` on the CPU, bit for bit alike. (An
    ``index_add_`` over duplicate rows would accumulate with atomics in an
    order that changes from run to run on CUDA, and two identical steps
    would no longer give bit-identical pools.) Entry ``j`` of the result is
    the ``j``-th distinct row with its summed gradient; the tail is the
    sentinel row ``num_rows`` with zero values, which every consumer masks
    out explicitly. Adds the distinct rows to
    ``cuda_lib.ROW_COUNTS["rows_deduped"]``.

    Returns ``(rows, vals)``: (N,) rows in the dtype of ``store_idx``, (N, D)
    f32 values.
    """
    return _dedupe(store_idx, g_rows, 1, num_rows, "rows")


def dedupe_bags(store_idx: torch.Tensor, g_bags: torch.Tensor, H: int,
                num_rows: int, sizes: Optional[Sequence[int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dedupe_rows`` for lookups that share their bag's cotangent.

    Lookup ``i`` of the (N,) ``store_idx`` (N = B*T*H, bag-major) carries
    row ``i // H`` of the (B*T, D) ``g_bags``, as every lookup of an
    unweighted ``sum`` or ``mean`` bag does; the result equals
    ``dedupe_rows(store_idx, g_bags.repeat_interleave(H, 0), num_rows)``
    bit for bit, without that (N, D) copy. For ragged bags of ``sizes``
    lookups (sample-major, N = B*sum(sizes); ``H`` is not read) lookup
    ``i`` carries its bag's row, ``lookup_bags(i, H, sizes)``. The segment
    sum counts under ``LAUNCHES["segment_sum_bags"]``, or
    ``["segment_sum_ragged"]`` for ragged bags.
    """
    if sizes is None:
        return _dedupe(store_idx, g_bags, H, num_rows, "bags")
    return _dedupe(store_idx, g_bags, 0, num_rows, "ragged", sizes)


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
                    H: int, sizes: Optional[Sequence[int]] = None):
    """Per-lookup row cotangents of one pooled bag output cotangent ``g``,
    for a ``max`` or a weighted bag.

    Returns ``(g_rows, dw)``: (B, T, H, D) f32 cotangent per looked-up row
    and the (B, T, H) weight cotangent (None when unweighted); for ragged
    bags of ``sizes`` lookups (``w`` (N,)) (N, D) and (N,).
    """
    D = pool.shape[1]
    if sizes is not None:
        return _ragged_row_cotangents(pool, store_idx, w, g, combiner, sizes)
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
    g_v = _bag_cotangents(g, combiner, H)[:, :, None, :].expand(B, T, H, D)
    rows = pool.index_select(0, store_idx).reshape(B, T, H, D).float()
    dw = (g_v * rows).sum(dim=-1)
    return g_v * w[..., None], dw


def _ragged_row_cotangents(pool, store_idx, w, g, combiner: str, sizes):
    """``_row_cotangents`` of ragged bags, each lookup reading its bag's
    row through ``lookup_bags``."""
    D = pool.shape[1]
    n = store_idx.shape[0]
    bag = lookup_bags(torch.arange(n, device=store_idx.device), 0, sizes)
    g_bags = _bag_cotangents(g, combiner, 0, sizes).reshape(-1, D)
    rows = pool.index_select(0, store_idx).float()         # (N, D)
    if combiner == "max":
        v = rows if w is None else rows * w[:, None]
        at = bag[:, None].expand(n, D)
        m = v.new_full(g_bags.shape, float("-inf")).scatter_reduce(
            0, at, v, "amax")
        tie = (v == m[bag]).float()
        tie = tie / tie.new_zeros(g_bags.shape).index_add_(0, bag, tie)[bag]
        g_v = g_bags[bag] * tie
        dw = None if w is None else (g_v * rows).sum(dim=-1)
        return (g_v if w is None else g_v * w[:, None]), dw
    g_v = g_bags[bag]
    return g_v * w[:, None], (g_v * rows).sum(dim=-1)


def _bag_cotangents(g, combiner: str, H: int,
                    sizes: Optional[Sequence[int]] = None):
    """The cotangent every lookup of a ``sum`` or ``mean`` bag shares:
    (B, T, D) ``g``, divided by ``H`` (by each table's size for ragged
    bags of ``sizes``) for ``mean``."""
    if combiner != "mean":
        return g
    if sizes is None:
        return g / H
    return g / static_tensor(("bag_sizes", tuple(sizes)), g.device,
                             lambda: sizes, g.dtype)[None, :, None]


def _sparse_grads(pool, store_idx, w, g, *, combiner: str, B: int, T: int,
                  H: int, sizes: Optional[Sequence[int]] = None):
    """Deduped COO row gradients of one pooled bag output cotangent ``g``:
    ``(rows, vals, dw)``, shared by both backward paths. Unweighted ``sum``
    and ``mean`` bags dedupe their (B*T, D) bag cotangents (``dedupe_bags``);
    ``max`` and weighted bags their per-lookup ones (``dedupe_rows``).
    ``sizes``: per-table lookups of ragged bags (``H`` 0), or None."""
    R, D = pool.shape
    if w is None and combiner != "max":
        g_bags = _bag_cotangents(g, combiner, H, sizes).reshape(B * T, D)
        return (*dedupe_bags(store_idx, g_bags, H, R, sizes), None)
    g_rows, dw = _row_cotangents(pool, store_idx, w, g, combiner=combiner,
                                 B=B, T=T, H=H, sizes=sizes)
    return (*dedupe_rows(store_idx, g_rows.reshape(-1, D), R), dw)


def _flat_lookups(indices: torch.Tensor, offsets,
                  sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """(B, T, H) local ids, or (B, sum(sizes)) ragged ones, + static
    offsets → flat int32 pooled rows, in the indices' order."""
    idx = indices.to(torch.int32)
    if offsets is not None:
        idx = idx + _columns(offsets, sizes if idx.dim() == 2 else None, idx)
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
      indices: (B, T, H) per-table-local lookup rows, or (B, sum(sizes))
               ragged ones under ``plan.bag_sizes``.
      g:       (B, T, D) cotangent of the fused bag output.
      weights: optional per-lookup scalars shaped like ``indices``.
      plan:    the ``EmbeddingPlan`` of the forward.

    Returns ``(rows, vals, dweights)``: (N,) int32 deduped store rows
    with sentinel tail (N lookups), (N, D) f32 summed row grads, and the
    weights cotangent (None when unweighted).
    """
    meta = _meta_for(pool, indices, plan)
    flat_idx = _flat_lookups(indices, plan.offsets, plan.bag_sizes)
    store_idx = flat_idx if plan.layout is None else \
        translate_rows(flat_idx, plan.layout)
    w = None if weights is None else _lookup_weights(weights.float(), meta)
    rows, vals, dw = _sparse_grads(pool, store_idx, w, g.float(),
                                   combiner=plan.combiner, B=meta.B,
                                   T=meta.T, H=meta.H, sizes=meta.sizes)
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
    H: int                  # lookups of every bag; 0 for ragged bags
    hot: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]  # offsets, table_hot
    layout: object
    sizes: Optional[Tuple[int, ...]] = None   # ragged bags' lookups a table

    @property
    def shape(self) -> Tuple[int, ...]:
        """The shape of the encoded indices K1 reads."""
        if self.sizes is None:
            return (self.B, self.T, self.H)
        return (self.B, sum(self.sizes))


def _lookup_weights(weights: torch.Tensor, meta: _Meta) -> torch.Tensor:
    """Per-lookup weights in the backward's form: (B, T, H), or (N,) for
    ragged bags."""
    return weights.reshape(meta.shape if meta.sizes is None else (-1,))


def _encode(pool: torch.Tensor, flat_idx: torch.Tensor, meta: _Meta):
    """Encoded int32 lookups (``meta.shape``) in the store's row space +
    the cache.

    The cache is gathered from ``pool`` inside the Function's forward, so
    gradients of cached rows reach the pool like those of any other row
    (row ids are preserved). Hot detection speaks FLAT local ids: encode
    first, then translate only the cold entries into the padded space.
    """
    idx = flat_idx.reshape(meta.shape)
    layout = meta.layout
    if meta.hot is None:
        enc = idx if layout is None else translate_rows(idx, layout)
        return enc.contiguous(), None
    offsets, table_hot = meta.hot

    def cache_rows():
        ids = hot_row_ids(offsets, table_hot)
        # a table's prefix may straddle two shards
        return ids if layout is None else layout.flat_to_padded(ids)

    ids = static_tensor(("hot_rows", offsets, table_hot, layout),
                        pool.device, cache_rows)
    cache = pool.index_select(0, ids)
    enc, _ = encode_hot_indices(idx, offsets, table_hot, meta.sizes)
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
        w = None if weights is None else weights.reshape(meta.shape)
        return embedding_bag_forward(pool.contiguous(), enc, w, cache,
                                     meta.combiner, meta.sizes)

    @staticmethod
    def backward(ctx, g):
        meta = ctx.meta
        pool, flat_idx, weights = ctx.saved_tensors
        R = pool.shape[0]
        # gradients land in the store's row space: padded rows under a
        # layout, whose padding slots are never addressed (exactly zero)
        store_idx = flat_idx if meta.layout is None else \
            translate_rows(flat_idx, meta.layout)
        w = None if weights is None else _lookup_weights(weights, meta)
        # the dedupe shared with sparse_row_grads makes the dense gradient
        # the bit-exact oracle of the fused row-wise update
        rows, vals, dw = _sparse_grads(pool, store_idx, w, g.float(),
                                       combiner=meta.combiner, B=meta.B,
                                       T=meta.T, H=meta.H, sizes=meta.sizes)
        dpool = scatter_rows(rows, vals, R).to(pool.dtype)
        dweights = None if dw is None else dw.reshape(weights.shape).to(
            weights.dtype)
        return dpool, None, dweights, None


def _meta_for(pool: torch.Tensor, indices: torch.Tensor, plan) -> _Meta:
    """Validate one call against its plan; the Function's static metadata.
    Ragged bags whose sizes are all equal take the ``(B, T, H)`` path: the
    flat lookups are the same."""
    combiner, offsets, layout = plan.combiner, plan.offsets, plan.layout
    assert combiner in COMBINERS, combiner
    sizes = plan.bag_sizes
    if sizes is None:
        assert indices.dim() == 3, \
            f"indices must be (B, T, H), got {indices.shape}"
        B, T, H = indices.shape
    else:
        assert indices.dim() == 2 and indices.shape[1] == sum(sizes), \
            f"ragged indices must be (B, {sum(sizes)}), got {indices.shape}"
        B, T = indices.shape[0], len(sizes)
        H = sizes[0] if len(set(sizes)) == 1 else 0
        sizes = None if H else tuple(sizes)
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
    return _Meta(combiner, B, T, H, hot, layout, sizes)


def kernel_inputs(pool: torch.Tensor, indices: torch.Tensor, plan):
    """The ``(encoded indices, cache)`` that K1 receives for
    ``fused_embedding_bag(pool, indices, plan=plan)``."""
    meta = _meta_for(pool, indices, plan)
    return _encode(pool, _flat_lookups(indices, plan.offsets,
                                       plan.bag_sizes), meta)


def fused_embedding_bag(pool: torch.Tensor, indices: torch.Tensor,
                        weights: Optional[torch.Tensor] = None, *,
                        plan) -> torch.Tensor:
    """Pool per-table embedding bags for all tables in one call.

    Args:
      pool:    flat (R, D) row-concatenation of all tables, or under
               ``plan.layout`` the (n_ps * max_range, D) padded view.
      indices: (B, T, H) per-table-local (or, with ``plan.offsets=None``,
               global flat) rows, always in the FLAT id space; under
               ``plan.bag_sizes`` the ragged (B, sum(bag_sizes)).
      weights: optional per-lookup scalars shaped like ``indices``,
               applied before the combiner.
      plan:    the ``EmbeddingPlan`` (offsets, combiner, table_hot, layout,
               bag_sizes).

    Returns (B, T, D) in the pool dtype; gradients flow to ``pool`` and
    ``weights``. Numerics are identical for every cache plan and layout.
    """
    meta = _meta_for(pool, indices, plan)
    flat_idx = _flat_lookups(indices, plan.offsets, plan.bag_sizes)
    w = None if weights is None else weights.float().contiguous()
    return _FusedEmbeddingBag.apply(pool, flat_idx, w, meta)
