"""Placement values and planners for the pooled embedding store.

Port of the numpy planners and plan values of ``repro/sharding/policy.py``:
``uniform_vocab_ranges``, ``balanced_vocab_ranges``,
``frequency_permutation``, ``pack_hot_ranges``, ``placement_imbalance``,
``PaddedLayout``, ``EmbeddingPlan``, ``padded_layout_for_ranges`` and
``make_dlrm_policy``. On one GPU nothing is placed by a mesh: ``constrain``
is the identity, ``ShardingPolicy`` is a placement-free value that carries
the balanced ``vocab_ranges`` plan, and ``n_ps`` only shapes the padded
physical layout of the pool. The GSPMD-only pieces of the reference
(``spec``, ``sharding``, ``axis_size``, ``make_policy``, ``logical_spec``,
``use_policy``, ``current_policy``) have no meaning here and are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def constrain(x: torch.Tensor, names: Sequence[Optional[str]]) -> torch.Tensor:
    """Sharding constraint on logical axes: the identity on one GPU."""
    del names
    return x


@dataclass(frozen=True)
class ShardingPolicy:
    """The placement plan of the PS ("vocab") axis, without a mesh.

    ``vocab_ranges``, when set, is the frequency-balanced contiguous
    pooled-row plan (``balanced_vocab_ranges`` or a ``ReplanDecision``);
    ``None`` means uniform striping. On one GPU every other axis is
    replicated, so the policy holds nothing else.
    """
    vocab_ranges: Optional[Tuple[Tuple[int, int], ...]] = None

    def with_vocab_ranges(
            self, ranges: Optional[Sequence[Tuple[int, int]]]
    ) -> "ShardingPolicy":
        """Copy carrying ``ranges`` (None drops back to uniform striping)."""
        if ranges is None:
            return replace(self, vocab_ranges=None)
        return replace(self, vocab_ranges=tuple(
            (int(s), int(e)) for s, e in ranges))

    def ps_row_ranges(self, total_rows: int) -> List[Tuple[int, int]]:
        """Pooled-row range each PS shard owns: the balanced plan when one is
        attached, otherwise the one range a replicated "vocab" axis implies
        (the reference's ``axis_size("vocab")`` is 1 without a mesh)."""
        if self.vocab_ranges is not None:
            return list(self.vocab_ranges)
        return uniform_vocab_ranges(total_rows, 1)


NULL_POLICY = ShardingPolicy()


def make_dlrm_policy(mesh, vocab_ranges: Optional[Sequence[Tuple[int, int]]]
                     = None) -> ShardingPolicy:
    """Policy of the DLRM workloads: the balanced ``vocab_ranges`` plan (or
    uniform striping). Only ``mesh=None`` exists on one GPU; a mesh raises."""
    if mesh is not None:
        raise ValueError("make_dlrm_policy: device meshes are GSPMD-only; "
                         "the port places nothing by a mesh (mesh=None)")
    return NULL_POLICY.with_vocab_ranges(vocab_ranges)


def pack_hot_ranges(counts: np.ndarray, table_rows: Sequence[int],
                    budget: int) -> Tuple[int, ...]:
    """Per-table hot-prefix sizes from pooled row-access counts.

    Picks the globally most-frequent ``budget`` rows and returns how many of
    them land in each table (the ``table_hot`` of the fused embedding
    engine). Never caches rows that were never touched, so the sizes may sum
    to less than ``budget``.
    """
    counts = np.asarray(counts)
    table_rows = tuple(int(r) for r in table_rows)
    assert counts.shape == (sum(table_rows),), (counts.shape, sum(table_rows))
    budget = min(int(budget), counts.size)
    if budget <= 0:
        return (0,) * len(table_rows)
    top = np.argpartition(counts, -budget)[-budget:]
    top = top[counts[top] > 0]              # never cache rows never touched
    bounds = np.cumsum((0,) + table_rows)
    per_table = np.histogram(top, bins=bounds)[0]
    return tuple(int(k) for k in per_table)


def frequency_permutation(counts: np.ndarray,
                          table_rows: Sequence[int]) -> np.ndarray:
    """Per-table remap old row -> frequency rank (hot rows first).

    ``perm[global_row] = new_global_row`` keeps every row inside its own
    table and orders each table by descending count, stable within ties.
    """
    counts = np.asarray(counts)
    perm = np.empty((counts.size,), np.int64)
    off = 0
    for rows in table_rows:
        rows = int(rows)
        order = np.argsort(-counts[off:off + rows], kind="stable")
        perm[off + order] = off + np.arange(rows)
        off += rows
    return perm


def uniform_vocab_ranges(total_rows: int, n_shards: int) -> List[Tuple[int, int]]:
    """Equal-size contiguous pooled-row range per PS shard (blind striping)."""
    n = max(1, int(n_shards))
    return [(i * total_rows // n, (i + 1) * total_rows // n) for i in range(n)]


def balanced_vocab_ranges(counts: np.ndarray,
                          n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous pooled-row ranges with ~equal access mass per PS shard.

    Equal-mass boundaries on the access histogram's cumulative sum; a
    boundary row goes to whichever side leaves the left shard's mass closer
    to its target. All-zero counts give the uniform split.
    """
    counts = np.asarray(counts, np.float64)
    n_shards = max(1, int(n_shards))
    total = counts.sum()
    if total <= 0:                           # no signal: uniform striping
        edges = np.linspace(0, counts.size, n_shards + 1).astype(np.int64)
    else:
        cum = np.cumsum(counts)
        targets = total * np.arange(1, n_shards) / n_shards
        idx = np.searchsorted(cum, targets)
        left = np.where(idx > 0, cum[np.maximum(idx - 1, 0)], 0.0)
        inner = np.where(np.abs(left - targets) <= np.abs(cum[idx] - targets),
                         idx, idx + 1)
        edges = np.concatenate(([0], inner, [counts.size]))
        edges = np.maximum.accumulate(np.clip(edges, 0, counts.size))
    return [(int(edges[i]), int(edges[i + 1])) for i in range(n_shards)]


def placement_imbalance(counts: np.ndarray,
                        ranges: Sequence[Tuple[int, int]]) -> float:
    """max/mean per-shard access mass (1.0 = balanced, or no mass seen):
    the hot-PS metric and the re-plan trigger quantity."""
    counts = np.asarray(counts, np.float64)
    loads = np.array([counts[s:e].sum() for s, e in ranges])
    mean = loads.mean()
    return float(loads.max() / mean) if mean > 0 else 1.0


@dataclass(frozen=True)
class PaddedLayout:
    """Physical padded ``(n_ps, max_range, D)`` placement of a range plan.

    Shard ``p`` owns exactly ``ranges[p]``'s rows, stored at
    ``padded[p, 0:size_p]`` and tail-padded with zero rows to ``max_range``.
    A flat pooled row ``g`` in ``ranges[p] = (start, end)`` lives at padded
    row ``p * max_range + (g - start)`` of the ``(n_ps * max_range, D)``
    view the fused embedding engine consumes. Padding rows are never
    addressed, so they add nothing to pooling and receive zero gradient.
    """
    ranges: Tuple[Tuple[int, int], ...]

    @property
    def n_ps(self) -> int:
        """PS shard count (leading axis of the padded pool)."""
        return len(self.ranges)

    @property
    def max_range(self) -> int:
        """Rows per physical shard (the largest range, floor 1)."""
        return max(1, max(e - s for s, e in self.ranges))

    @property
    def total_rows(self) -> int:
        """Real pooled rows covered (``sum(table_rows)`` of the job)."""
        return self.ranges[-1][1]

    @property
    def padded_rows(self) -> int:
        """Rows of the ``(n_ps * max_range, D)`` flattened padded pool."""
        return self.n_ps * self.max_range

    @property
    def shard_starts(self) -> Tuple[int, ...]:
        """Flat pooled row where each shard's range begins."""
        return tuple(s for s, _ in self.ranges)

    @property
    def shard_sizes(self) -> Tuple[int, ...]:
        """Real (unpadded) rows each shard physically owns."""
        return tuple(e - s for s, e in self.ranges)

    def shard_slot(self, rows) -> Tuple[np.ndarray, np.ndarray]:
        """Flat pooled rows → ``(shard, slot)``; the rightmost matching
        shard start wins, so empty shards are never selected."""
        rows = np.asarray(rows, np.int64)
        starts = np.asarray(self.shard_starts, np.int64)
        shard = np.clip(np.searchsorted(starts, rows, side="right") - 1,
                        0, self.n_ps - 1)
        return shard, rows - starts[shard]

    def flat_to_padded(self, rows) -> np.ndarray:
        """Flat pooled rows → rows of the flattened padded pool."""
        shard, slot = self.shard_slot(rows)
        return shard * self.max_range + slot

    def padded_to_flat(self, padded) -> np.ndarray:
        """Rows of the flattened padded pool → flat pooled rows (real rows
        only: a padding slot maps wherever the arithmetic lands)."""
        padded = np.asarray(padded, np.int64)
        shard, slot = padded // self.max_range, padded % self.max_range
        starts = np.asarray(self.shard_starts, np.int64)
        return starts[shard] + slot

    def row_translation(self) -> np.ndarray:
        """The full ``(total_rows,)`` flat → padded row map (int64),
        memoized on the instance outside the dataclass fields."""
        cached = self.__dict__.get("_row_translation")
        if cached is None:
            cached = self.flat_to_padded(
                np.arange(self.total_rows, dtype=np.int64))
            cached.setflags(write=False)
            object.__setattr__(self, "_row_translation", cached)
        return cached

    def padding_mask(self) -> np.ndarray:
        """(n_ps, max_range) bool mask, True where a real row lives;
        ``mask.sum(axis=1)`` equals ``shard_sizes``."""
        sizes = np.asarray(self.shard_sizes, np.int64)[:, None]
        return np.arange(self.max_range, dtype=np.int64)[None, :] < sizes

    def pad_rows(self, flat: torch.Tensor) -> torch.Tensor:
        """(total_rows, ...) flat rows → (n_ps, max_range, ...) padded store;
        padding slots are zeros, values move bit-exactly."""
        assert flat.shape[0] == self.total_rows, (flat.shape, self.total_rows)
        out = flat.new_zeros((self.padded_rows,) + tuple(flat.shape[1:]))
        dest = torch.tensor(self.row_translation(), device=flat.device)
        out[dest] = flat
        return out.reshape((self.n_ps, self.max_range) + tuple(flat.shape[1:]))

    def unpad_rows(self, padded: torch.Tensor) -> torch.Tensor:
        """(n_ps, max_range, ...) padded store → (total_rows, ...) flat."""
        assert tuple(padded.shape[:2]) == (self.n_ps, self.max_range), \
            padded.shape
        flat2d = padded.reshape((self.padded_rows,) + tuple(padded.shape[2:]))
        src = torch.tensor(self.row_translation(), device=padded.device)
        return flat2d[src]


@dataclass(frozen=True)
class EmbeddingPlan:
    """The complete static plan of one fused embedding call.

    Fields:
      offsets:       per-table flat-pool row offsets; ``None`` means the
                     indices are already global flat rows.
      combiner:      "sum" | "mean" | "max" bag pooling.
      table_hot:     per-table hot-prefix sizes of the hot-row cache;
                     ``None``/all-zero disables the cache.
      layout:        optional ``PaddedLayout`` of the pool.
      sparse_update: run the fused sparse backward + row-wise optimizer
                     update in the training step.
      bag_sizes:     per-table lookups of ragged bags: the indices are then
                     sample-major ``(B, sum(bag_sizes))``, bag ``(b, t)`` at
                     ``b * sum + sum(bag_sizes[:t])``; ``None`` means
                     ``(B, T, H)`` indices, ``H`` lookups in every bag.
    """
    offsets: Optional[Tuple[int, ...]] = None
    combiner: str = "sum"
    table_hot: Optional[Tuple[int, ...]] = None
    layout: Optional[PaddedLayout] = None
    sparse_update: bool = False
    bag_sizes: Optional[Tuple[int, ...]] = None

    def __post_init__(self) -> None:
        if self.combiner not in ("sum", "mean", "max"):
            raise ValueError(f"unknown combiner: {self.combiner!r}")
        if self.offsets is not None:
            object.__setattr__(
                self, "offsets", tuple(int(o) for o in self.offsets))
        if self.table_hot is not None:
            object.__setattr__(
                self, "table_hot", tuple(int(k) for k in self.table_hot))
        if self.bag_sizes is not None:
            object.__setattr__(
                self, "bag_sizes", tuple(int(h) for h in self.bag_sizes))

    def with_combiner(self, combiner: str) -> "EmbeddingPlan":
        """Same plan, different bag pooling (the wide tower's sum view)."""
        return replace(self, combiner=combiner)

    def with_replan(self, table_hot: Optional[Sequence[int]],
                    layout: Optional[PaddedLayout]) -> "EmbeddingPlan":
        """The plan a live re-plan rebuilds the step with: new cache plan and
        placement, every other knob carried over."""
        hot = None if table_hot is None else tuple(int(k) for k in table_hot)
        return replace(self, table_hot=hot, layout=layout)


def padded_layout_for_ranges(
        ranges: Sequence[Tuple[int, int]]) -> PaddedLayout:
    """The validated physical padded layout of a contiguous range plan."""
    rs = tuple((int(s), int(e)) for s, e in ranges)
    assert rs, "at least one shard range required"
    assert rs[0][0] == 0, f"ranges must start at 0, got {rs[0]}"
    for (s, e), (s2, _) in zip(rs, rs[1:]):
        assert e >= s and s2 == e, f"ranges must be contiguous: {rs}"
    assert rs[-1][1] >= rs[-1][0], rs[-1]
    return PaddedLayout(ranges=rs)
