"""Placement values and planners for the pooled embedding store.

Port of the numpy planners and plan values of ``repro/sharding/policy.py``:
``uniform_vocab_ranges``, ``pack_hot_ranges``, ``PaddedLayout``,
``EmbeddingPlan`` and ``padded_layout_for_ranges``. GSPMD placement
(``ShardingPolicy``) has no counterpart on one GPU: ``constrain`` is the
identity, and ``n_ps`` only shapes the padded physical layout of the pool.
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


def uniform_vocab_ranges(total_rows: int, n_shards: int) -> List[Tuple[int, int]]:
    """Equal-size contiguous pooled-row range per PS shard (blind striping)."""
    n = max(1, int(n_shards))
    return [(i * total_rows // n, (i + 1) * total_rows // n) for i in range(n)]


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
    """
    offsets: Optional[Tuple[int, ...]] = None
    combiner: str = "sum"
    table_hot: Optional[Tuple[int, ...]] = None
    layout: Optional[PaddedLayout] = None
    sparse_update: bool = False

    def __post_init__(self) -> None:
        if self.combiner not in ("sum", "mean", "max"):
            raise ValueError(f"unknown combiner: {self.combiner!r}")
        if self.offsets is not None:
            object.__setattr__(
                self, "offsets", tuple(int(o) for o in self.offsets))
        if self.table_hot is not None:
            object.__setattr__(
                self, "table_hot", tuple(int(k) for k in self.table_hot))

    def with_combiner(self, combiner: str) -> "EmbeddingPlan":
        """Same plan, different bag pooling (the wide tower's sum view)."""
        return replace(self, combiner=combiner)


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
