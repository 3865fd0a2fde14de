"""Dynamic data sharding (paper §5.1) + frequency-aware parameter placement.

Port of ``repro/core/sharding_service.py`` (numpy with locks, as there).
Its helpers from the planning layer are imported where they are used, as
there, so the brain and the simulator import no torch.

The job master splits the dataset into numerous small, variably-sized shards
kept in a *shards queue*. Workers fetch shards on demand, send periodic
heartbeats carrying *progress offsets*, and report completion. The service:

* requeues the unfinished shard(s) of failed workers (no omission),
* hands stragglers smaller shards (workload rebalancing, consistent quality),
* lets new/restarted workers pull work immediately (fast elasticity),
* guarantees exactly-once *completion* coverage of the sample range.

``ParameterPlacementService`` is the job master's second planning duty: it
aggregates the per-row embedding access counts workers piggyback on their
heartbeats and serves RecShard-style placement plans — hot-row cache prefixes
for the fused embedding engine and balanced contiguous PS row ranges instead
of uniform vocab striping (the paper's hot-PS problem, §2.1/Fig 12, attacked
at placement time).

``HotTableTracker`` is the *live* evolution of that service: exponentially
decayed rolling counts that follow drifting access skew, and a hysteresis
trigger that turns "the current placement has gone hot" into a
``ReplanDecision`` — the input of ``repro_torch.train.replan``'s mid-job
re-plan/re-shard cycle (the paper's §4–§5 *dynamic adjustment* loop applied
to embedding placement).

All methods take an explicit ``now`` timestamp so the service runs identically
under the simulator's virtual clock and a wall clock.
"""
from __future__ import annotations

import collections
import threading
from dataclasses import dataclass, replace
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Shard:
    """Half-open sample range [start, end) with a unique index."""
    index: int
    start: int
    end: int
    epoch: int = 0

    @property
    def size(self) -> int:
        return self.end - self.start


@dataclass
class WorkerView:
    shard: Optional[Shard] = None
    progress: int = 0                  # samples processed within current shard
    last_heartbeat: float = 0.0
    samples_done: int = 0              # lifetime samples (for straggler detection)
    first_seen: float = 0.0
    is_straggler: bool = False


class ShardingService:
    def __init__(self, total_samples: int, shard_size: int = 256 * 64, *,
                 num_epochs: int = 1, min_shard: int = 64,
                 heartbeat_timeout: float = 30.0,
                 straggler_ratio: float = 0.5):
        assert total_samples > 0 and shard_size > 0
        self.total = total_samples
        self.shard_size = shard_size
        self.min_shard = min_shard
        self.heartbeat_timeout = heartbeat_timeout
        self.straggler_ratio = straggler_ratio
        self.num_epochs = num_epochs
        self._lock = threading.Lock()
        self._queue: Deque[Shard] = collections.deque()
        self._next_index = 0
        self._epoch = 0
        self._workers: Dict[str, WorkerView] = {}
        self._completed: List[Shard] = []
        self._fill_epoch(0)

    # ------------------------------------------------------------------ fill
    def _fill_epoch(self, epoch: int) -> None:
        start = 0
        while start < self.total:
            end = min(start + self.shard_size, self.total)
            self._queue.append(Shard(self._next_index, start, end, epoch))
            self._next_index += 1
            start = end

    # --------------------------------------------------------------- workers
    def _view(self, worker: str, now: float) -> WorkerView:
        if worker not in self._workers:
            self._workers[worker] = WorkerView(first_seen=now, last_heartbeat=now)
        return self._workers[worker]

    def request_shard(self, worker: str, now: float) -> Optional[Shard]:
        """Hand the next shard; stragglers receive a split (smaller) shard.

        Implements the paper's workload-rebalancing pull model (§5.1): workers
        fetch on demand, so a slow worker naturally takes fewer samples, and a
        flagged straggler gets its shard halved (down to ``min_shard``).

        Args:
          worker: caller's worker id (registered on first contact).
          now:    current (virtual or wall) time, also counts as a heartbeat.

        Returns the worker's current ``Shard`` (a new one if it held none), or
        ``None`` when the queue is drained and all epochs are exhausted.
        """
        with self._lock:
            self._reap_failures(now)
            w = self._view(worker, now)
            w.last_heartbeat = now
            if w.shard is not None:
                return w.shard                      # already holding one
            if not self._queue:
                if self._epoch + 1 < self.num_epochs:
                    self._epoch += 1
                    self._fill_epoch(self._epoch)
                else:
                    return None
            shard = self._queue.popleft()
            if w.is_straggler and shard.size > self.min_shard:
                half = shard.size // 2
                first = replace(shard, end=shard.start + half)
                second = Shard(self._next_index, shard.start + half, shard.end,
                               shard.epoch)
                self._next_index += 1
                self._queue.appendleft(second)
                shard = first
            w.shard = shard
            w.progress = 0
            return shard

    def heartbeat(self, worker: str, progress: int, now: float) -> None:
        """Record a progress-offset heartbeat (§5.1 liveness + straggler input).

        Args:
          worker:   reporting worker id.
          progress: samples processed within the worker's *current* shard
                    (monotonic within a shard; resets on a new shard).
          now:      current time; missing heartbeats past
                    ``heartbeat_timeout`` mark the worker failed.
        """
        with self._lock:
            w = self._view(worker, now)
            delta = max(0, progress - w.progress)
            w.progress = progress
            w.samples_done += delta
            w.last_heartbeat = now

    def report_done(self, worker: str, shard_index: int, now: float) -> None:
        """Mark the worker's current shard complete (exactly-once accounting).

        Args:
          worker:      reporting worker id.
          shard_index: index of the shard being completed; ignored if it does
                       not match the shard the worker actually holds (stale
                       completion after a requeue cannot double-count).
          now:         current time (counts as a heartbeat).
        """
        with self._lock:
            w = self._view(worker, now)
            if w.shard is not None and w.shard.index == shard_index:
                w.samples_done += max(0, w.shard.size - w.progress)
                self._completed.append(w.shard)
                w.shard = None
                w.progress = 0
            w.last_heartbeat = now

    def report_failure(self, worker: str, now: float) -> None:
        """Explicit failure notification (e.g. pod eviction callback)."""
        with self._lock:
            self._fail_worker(worker)

    # ------------------------------------------------------------- liveness
    def _fail_worker(self, worker: str) -> None:
        w = self._workers.get(worker)
        if w is None:
            return
        if w.shard is not None:
            self._queue.appendleft(w.shard)        # requeue unfinished shard
        del self._workers[worker]

    def _reap_failures(self, now: float) -> List[str]:
        dead = [name for name, w in self._workers.items()
                if now - w.last_heartbeat > self.heartbeat_timeout]
        for name in dead:
            self._fail_worker(name)
        return dead

    def check_failures(self, now: float) -> List[str]:
        """Reap workers whose last heartbeat is older than the timeout.

        Their unfinished shards go back to the *front* of the queue (§5.1 "no
        data omission"). Returns the list of reaped worker ids.
        """
        with self._lock:
            return self._reap_failures(now)

    # ------------------------------------------------------------ stragglers
    def detect_stragglers(self, now: float) -> List[str]:
        """Progress-offset comparison: rate < ratio × median peer rate.

        The paper's straggler mitigation (§5.1): flagged workers keep running
        but receive split shards from ``request_shard``, so one slow pod
        stops gating the barrier without being evicted.

        Args:
          now: current time (rates are lifetime samples / lifetime seconds).

        Returns worker ids *newly* flagged as stragglers by this call.
        """
        with self._lock:
            rates = {}
            for name, w in self._workers.items():
                dt = max(now - w.first_seen, 1e-9)
                rates[name] = (w.samples_done + w.progress) / dt
            if len(rates) < 2:
                return []
            vals = sorted(rates.values())
            median = vals[len(vals) // 2]
            out = []
            for name, rate in rates.items():
                w = self._workers[name]
                was = w.is_straggler
                w.is_straggler = median > 0 and rate < self.straggler_ratio * median
                if w.is_straggler and not was:
                    out.append(name)
            return out

    # ------------------------------------------------------------- accounting
    @property
    def epochs_completed(self) -> int:
        return self._epoch

    def pending_count(self) -> int:
        """Number of shards waiting in the queue (not held by any worker)."""
        with self._lock:
            return len(self._queue)

    def completed_samples(self, epoch: Optional[int] = None) -> int:
        """Total samples in completed shards (optionally for one epoch)."""
        with self._lock:
            return sum(s.size for s in self._completed
                       if epoch is None or s.epoch == epoch)

    def coverage(self, epoch: int = 0) -> Tuple[bool, int, int]:
        """Exactly-once check: (is_exact, covered, duplicated) for an epoch."""
        with self._lock:
            seen = {}
            dup = 0
            for s in self._completed:
                if s.epoch != epoch:
                    continue
                for key in range(s.start, s.end):
                    if key in seen:
                        dup += 1
                    seen[key] = True
            covered = len(seen)
            in_flight = any(w.shard is not None and w.shard.epoch == epoch
                            for w in self._workers.values())
            pending = any(s.epoch == epoch for s in self._queue)
            complete = (covered == self.total and dup == 0
                        and not in_flight and not pending)
            return complete, covered, dup


# ---------------------------------------------------------------------------
# Frequency-aware parameter placement (job-master side, RecShard-style)
# ---------------------------------------------------------------------------
class ParameterPlacementService:
    """Aggregates worker row-access reports into placement plans.

    Workers attach per-row embedding lookup *count deltas* (or raw (B, T, H)
    index tensors) to their heartbeats; the job master accumulates them into
    one pooled histogram and answers two planning queries:

    * ``hot_plan(budget)`` — per-table hot-prefix sizes for the fused
      embedding engine's hot-row cache (``pack_hot_ranges``),
    * ``ps_ranges(n_ps)`` — contiguous pooled-row ranges with balanced
      access mass for the PS shards (``balanced_vocab_ranges``), replacing
      uniform vocab striping that funnels skewed traffic onto one hot PS.

    Thread-safe like ``ShardingService``; plans are cheap enough to recompute
    on demand, so there is no cached/stale state to invalidate.
    """

    def __init__(self, table_rows: Sequence[int]):
        from repro_torch.data.synthetic import RowFreqCounter
        self._ctr = RowFreqCounter(table_rows)   # owns the pooled histogram
        self.table_rows = self._ctr.table_rows
        self.offsets = self._ctr.offsets
        self.total_rows = self._ctr.total_rows
        self._lock = threading.Lock()
        self._reports: Dict[str, int] = {}

    def report_counts(self, worker: str, counts: np.ndarray) -> None:
        """Merge a worker's per-row lookup count *delta* (pooled layout)."""
        counts = np.asarray(counts)
        assert counts.shape == (self.total_rows,), counts.shape
        with self._lock:
            self._ctr.counts += counts
            self._ctr.n_lookups += int(counts.sum())
            self._reports[worker] = self._reports.get(worker, 0) + 1

    def report_batch(self, worker: str, sparse: np.ndarray) -> None:
        """Merge one batch of (B, T, H) per-table-local indices directly."""
        with self._lock:
            self._ctr.update(sparse)
            self._reports[worker] = self._reports.get(worker, 0) + 1

    @property
    def counts(self) -> np.ndarray:
        with self._lock:
            return self._ctr.counts.copy()

    def hot_plan(self, budget: int) -> Tuple[int, ...]:
        """Per-table hot-prefix sizes for ``budget`` hot-row cache rows.

        The measured ``table_hot`` plan for the fused embedding engine
        (``pack_hot_ranges`` on the aggregated counts).
        """
        from repro_torch.sharding.policy import pack_hot_ranges
        return pack_hot_ranges(self.counts, self.table_rows, budget)

    def ps_ranges(self, n_ps: int) -> List[Tuple[int, int]]:
        """Balanced contiguous pooled-row range per PS shard.

        ``balanced_vocab_ranges`` on the aggregated counts — the hot-PS fix
        of §2.1/Fig 12, applied at placement time.
        """
        from repro_torch.sharding.policy import balanced_vocab_ranges
        return balanced_vocab_ranges(self.counts, n_ps)

    def imbalance(self, n_ps: int) -> float:
        """max/mean PS load under the current balanced plan (1.0 = ideal)."""
        from repro_torch.sharding.policy import placement_imbalance
        return placement_imbalance(self.counts, self.ps_ranges(n_ps))


# ---------------------------------------------------------------------------
# Live re-planning: decayed rolling counts + hysteresis trigger (paper §4–§5
# dynamic adjustment applied to embedding placement)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ReplanDecision:
    """One accepted live re-plan, ready for ``repro_torch.train.replan`` to apply.

    The decision is expressed in the *current* pooled-row layout ("layout
    space"): ``permutation[row] = new_row`` keeps every row inside its own
    table but frequency-packs each table (hot rows first), after which
    ``table_hot`` prefixes feed the fused engine's hot-row cache and
    ``vocab_ranges`` are the balanced contiguous PS ranges for the new
    layout. ``imbalance_before``/``after`` are max/mean PS load under the
    old and new plans — the quantities the Fig 12 hot-PS rows report.
    """
    observed_at: int                        # tracker batch count at decision
    table_hot: Tuple[int, ...]              # per-table hot-prefix sizes
    vocab_ranges: Tuple[Tuple[int, int], ...]
    permutation: np.ndarray                 # layout row -> new layout row
    imbalance_before: float
    imbalance_after: float


class HotTableTracker:
    """Rolling-count hot/placement tracker with a hysteresis re-plan trigger.

    The static ``ParameterPlacementService`` answers "what is the best plan
    for everything seen so far"; this tracker answers the live question "has
    the access distribution drifted far enough from the *applied* plan to be
    worth a mid-job re-shard". Two mechanisms make that safe to wire into a
    training loop:

    * **Decayed rolling counts** — every ``observe`` first multiplies the
      pooled histogram by ``decay``, so the counts are an exponential moving
      window over recent batches (half-life ``ln 2 / ln(1/decay)`` observes)
      and track drifting zipf skew instead of averaging it away.
    * **Hysteresis** — ``maybe_replan`` only fires when (a) the imbalance of
      the decayed counts under the *currently applied* ranges exceeds
      ``trigger``, (b) the candidate plan improves it by at least
      ``min_gain`` (noise near the threshold cannot thrash), (c) at least
      ``cooldown`` observes have passed since the last applied re-plan, and
      (d) at least ``min_lookups`` of decayed mass has accumulated.

    The caller applies an accepted decision (permute state, recompile — see
    ``repro_torch.train.replan``) and then calls ``mark_applied``, which permutes
    the tracker's own counts into the new layout so observation continues
    seamlessly in the post-replan id space.
    """

    def __init__(self, table_rows: Sequence[int], *, n_ps: int = 4,
                 hot_budget: int = 0, decay: float = 0.9,
                 trigger: float = 1.2, min_gain: float = 0.05,
                 cooldown: int = 8, min_lookups: int = 1024,
                 initial_ranges: Optional[Sequence[Tuple[int, int]]] = None,
                 initial_hot: Optional[Sequence[int]] = None,
                 bag_sizes: Optional[Sequence[int]] = None):
        """Args:
          table_rows:  per-table row counts (pooled layout, like the config's
                       ``table_rows``).
          n_ps:        PS shard count the vocab ranges are planned for.
          hot_budget:  total rows of hot-row cache to plan
                       (``pack_hot_ranges`` budget; 0 plans no cache).
          decay:       per-observe multiplier on the rolling counts.
          trigger:     imbalance (max/mean PS load) that arms a re-plan.
          min_gain:    minimum imbalance improvement a candidate plan must
                       deliver (the hysteresis band).
          cooldown:    minimum observes between applied re-plans.
          min_lookups: minimum decayed lookup mass before any decision.
          initial_ranges: the placement plan already in effect — e.g. from a
                       layout-stamped checkpoint on resume; default = uniform
                       striping (no plan applied yet).
          initial_hot: the cache plan already in effect (same provenance).
          bag_sizes:   per-table lookups of ragged (B, sum) batches, or
                       None for (B, T, H) ones.
        """
        from repro_torch.kernels.fused_embedding import table_offsets
        from repro_torch.sharding.policy import uniform_vocab_ranges
        self.table_rows = tuple(int(r) for r in table_rows)
        self.offsets = np.asarray(table_offsets(self.table_rows), np.int64)
        self.total_rows = int(sum(self.table_rows))
        self.bag_sizes = bag_sizes
        self.n_ps = int(n_ps)
        self.hot_budget = int(hot_budget)
        self.decay = float(decay)
        self.trigger = float(trigger)
        self.min_gain = float(min_gain)
        self.cooldown = int(cooldown)
        self.min_lookups = float(min_lookups)
        self._lock = threading.Lock()
        self.counts = np.zeros((self.total_rows,), np.float64)
        self._observes = 0
        self._last_replan = -self.cooldown      # first decision is not gated
        self.n_replans = 0
        # the plan currently in effect (default: uniform striping, no cache)
        self.current_ranges: Tuple[Tuple[int, int], ...] = tuple(
            (int(s), int(e)) for s, e in (
                initial_ranges if initial_ranges is not None
                else uniform_vocab_ranges(self.total_rows, self.n_ps)))
        self.current_hot: Optional[Tuple[int, ...]] = (
            None if initial_hot is None
            else tuple(int(k) for k in initial_hot))

    # ------------------------------------------------------------- observing
    def observe(self, sparse: np.ndarray) -> None:
        """Fold one batch of (B, T, H) per-table-local ids (or ragged (B,
        sum(bag_sizes)) ones) into the window.

        Ids are in the *current layout* space — i.e. whatever the training
        step actually looks up (post-remap after earlier re-plans), which is
        exactly what workers see and report.
        """
        from repro_torch.kernels.fused_embedding import column_values
        sparse = np.asarray(sparse)
        flat = (sparse.astype(np.int64) + column_values(
            self.offsets, sparse.ndim, self.bag_sizes)).reshape(-1)
        with self._lock:
            self.counts *= self.decay
            self.counts += np.bincount(flat, minlength=self.total_rows)
            self._observes += 1

    def observe_counts(self, delta: np.ndarray) -> None:
        """Fold a pre-binned pooled count delta (heartbeat payload form)."""
        delta = np.asarray(delta, np.float64)
        assert delta.shape == (self.total_rows,), delta.shape
        with self._lock:
            self.counts *= self.decay
            self.counts += delta
            self._observes += 1

    # -------------------------------------------------------------- queries
    @property
    def observes(self) -> int:
        """Number of batches folded into the rolling window so far."""
        return self._observes

    def snapshot(self) -> np.ndarray:
        """Copy of the decayed pooled counts (layout space)."""
        with self._lock:
            return self.counts.copy()

    def imbalance(self) -> float:
        """max/mean PS load of the decayed counts under the APPLIED ranges."""
        from repro_torch.sharding.policy import placement_imbalance
        with self._lock:
            return placement_imbalance(self.counts, self.current_ranges)

    # ------------------------------------------------------------- decisions
    def maybe_replan(self) -> Optional[ReplanDecision]:
        """Return a ``ReplanDecision`` if the drift trigger fires, else None.

        Pure planning — nothing is applied; the tracker keeps suggesting the
        same decision until the caller commits it with ``mark_applied``.
        """
        from repro_torch.sharding.policy import (
            balanced_vocab_ranges, frequency_permutation, pack_hot_ranges,
            placement_imbalance,
        )
        with self._lock:
            if self._observes - self._last_replan < self.cooldown:
                return None
            if self.counts.sum() < self.min_lookups:
                return None
            imb_now = placement_imbalance(self.counts, self.current_ranges)
            if imb_now < self.trigger:
                return None
            perm = frequency_permutation(self.counts, self.table_rows)
            packed = np.empty_like(self.counts)
            packed[perm] = self.counts
            ranges = tuple(balanced_vocab_ranges(packed, self.n_ps))
            imb_after = placement_imbalance(packed, ranges)
            if imb_now - imb_after < self.min_gain:
                return None                     # not worth a migration
            hot = pack_hot_ranges(packed, self.table_rows, self.hot_budget)
            return ReplanDecision(
                observed_at=self._observes, table_hot=hot,
                vocab_ranges=ranges, permutation=perm,
                imbalance_before=float(imb_now),
                imbalance_after=float(imb_after))

    def mark_applied(self, decision: ReplanDecision) -> None:
        """Commit a decision: rotate counts into the new layout, arm cooldown.

        Must be called exactly when the training side has permuted its state
        and started remapping ids — from then on ``observe`` receives ids in
        the new layout, and the rolling window is permuted to match.
        """
        with self._lock:
            packed = np.empty_like(self.counts)
            packed[decision.permutation] = self.counts
            self.counts = packed
            self.current_ranges = tuple(decision.vocab_ranges)
            self.current_hot = tuple(decision.table_hot)
            self._last_replan = self._observes
            self.n_replans += 1
