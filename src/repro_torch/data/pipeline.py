"""Shard-queue-driven input pipeline (worker side of dynamic data sharding).

Port of ``repro/data/pipeline.py``.

A ``ShardDataLoader`` belongs to one (possibly elastic) worker: it requests
shards from the job master's ``ShardingService``, generates the shard's
samples deterministically, emits fixed-size batches, and reports heartbeats
with progress offsets. If the worker dies, the master requeues its shard and
any replacement worker reproduces exactly the same samples.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from repro_torch.core.sharding_service import Shard, ShardingService


class ShardDataLoader:
    """``fault_hook(batch_index)`` — if given — runs before each batch is
    built; it is the data-pipeline injection point of a fault injector's
    ``on_batch`` (straggler delays land on the ingestion path, where real
    host-side stalls live)."""

    def __init__(self, service: ShardingService, worker_id: str,
                 batch_fn: Callable[[np.ndarray], Dict[str, np.ndarray]],
                 batch_size: int, *, clock: Callable[[], float] = time.monotonic,
                 heartbeat_every: int = 1,
                 fault_hook: Optional[Callable[[int], None]] = None):
        self.service = service
        self.worker_id = worker_id
        self.batch_fn = batch_fn
        self.batch_size = batch_size
        self.clock = clock
        self.heartbeat_every = heartbeat_every
        self.fault_hook = fault_hook
        self._shard: Optional[Shard] = None
        self._cursor = 0
        self._batches_since_hb = 0
        self._batches_emitted = 0

    # ------------------------------------------------------------------
    def _ensure_shard(self) -> bool:
        if self._shard is not None and self._cursor < self._shard.size:
            return True
        if self._shard is not None:
            self.service.report_done(self.worker_id, self._shard.index, self.clock())
            self._shard = None
        shard = self.service.request_shard(self.worker_id, self.clock())
        if shard is None:
            return False
        self._shard = shard
        self._cursor = 0
        return True

    def next_batch(self) -> Optional[Dict[str, np.ndarray]]:
        """Next batch or None when the dataset is exhausted.

        Batches never span shards; a short tail is padded by wrapping within
        the shard (training-only semantics, keeps batch shapes fixed).
        """
        if not self._ensure_shard():
            return None
        if self.fault_hook is not None:
            self.fault_hook(self._batches_emitted)
        self._batches_emitted += 1
        shard = self._shard
        lo = shard.start + self._cursor
        hi = min(lo + self.batch_size, shard.end)
        idx = np.arange(lo, hi)
        if len(idx) < self.batch_size:                    # pad by wrapping
            extra = np.arange(shard.start,
                              shard.start + self.batch_size - len(idx))
            idx = np.concatenate([idx, extra % max(shard.size, 1) + shard.start])
        self._cursor += self.batch_size
        self._batches_since_hb += 1
        if self._batches_since_hb >= self.heartbeat_every:
            progress = min(self._cursor, shard.size)
            self.service.heartbeat(self.worker_id, progress, self.clock())
            self._batches_since_hb = 0
        return self.batch_fn(idx)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            b = self.next_batch()
            if b is None:
                return
            yield b
