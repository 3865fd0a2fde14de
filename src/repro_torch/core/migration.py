"""Seamless migration (paper §5.2): overlap provisioning with training.

Copy of ``repro/core/migration.py`` (stdlib only).

Stop-and-restart (baseline):   pause → ckpt→RDS → provision → load → resume
Seamless (DLRover-RM):         provision ∥ training → pause → flash-ckpt →
                               flash-load → resume

Downtime = only the flash-ckpt save+load window (sub-second for in-memory
tier) instead of the full provision+RDS round trip. The state machine is
clock-driven so the simulator and real integrations share it; real hooks
(save/restore callbacks) plug into ``on_sync``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional


class Phase(enum.Enum):
    RUNNING = "running"
    PROVISIONING = "provisioning"      # new pods starting; training continues
    SYNC = "sync"                      # paused: checkpoint save + load
    DONE = "done"


@dataclass(frozen=True)
class MigrationTimings:
    """Calibrated from the paper §2.2/§5.2 and Fig 12."""
    provision_s: float = 300.0         # new pod request+image pull+launch (5 min)
    rds_ckpt_save_s: float = 120.0     # checkpoint to remote disk storage
    rds_ckpt_load_s: float = 90.0
    flash_ckpt_save_s: float = 1.0     # in-memory tier (<1 s for 20 GB, §5.2)
    flash_ckpt_load_s: float = 2.0
    # process re-exec on a still-live pod (job-master kill/re-exec path).
    # None = fall back to provision_s (the pre-measurement behavior); the
    # kill-matrix harness fills it with JobMasterReport.measured_timings()
    worker_reexec_s: Optional[float] = None

    def reexec_s(self) -> float:
        """Worker-replacement horizon: measured re-exec when available,
        else the conservative full pod provision."""
        return self.provision_s if self.worker_reexec_s is None \
            else self.worker_reexec_s


@dataclass
class MigrationPlan:
    seamless: bool = True
    use_flash_ckpt: bool = True
    timings: MigrationTimings = MigrationTimings()

    def downtime_seconds(self) -> float:
        t = self.timings
        save = t.flash_ckpt_save_s if self.use_flash_ckpt else t.rds_ckpt_save_s
        load = t.flash_ckpt_load_s if self.use_flash_ckpt else t.rds_ckpt_load_s
        if self.seamless:
            return save + load
        return save + t.provision_s + load

    def total_seconds(self) -> float:
        t = self.timings
        return t.provision_s + self.downtime_seconds() if self.seamless \
            else self.downtime_seconds()


@dataclass
class MigrationSession:
    """Clock-driven migration of one job; training continues in PROVISIONING."""
    plan: MigrationPlan
    started_at: float
    on_sync: Optional[Callable[[], None]] = None     # real ckpt hook
    phase: Phase = Phase.RUNNING
    _sync_started: Optional[float] = None
    downtime_accum: float = 0.0

    def start(self) -> None:
        self.phase = Phase.PROVISIONING if self.plan.seamless else Phase.SYNC
        if self.phase is Phase.SYNC:
            self._sync_started = self.started_at

    def tick(self, now: float) -> Phase:
        t = self.plan.timings
        if self.phase is Phase.PROVISIONING:
            if now - self.started_at >= t.provision_s:
                self.phase = Phase.SYNC
                self._sync_started = now
                if self.on_sync:
                    self.on_sync()
        if self.phase is Phase.SYNC:
            dt = self.plan.downtime_seconds() if self.plan.seamless else \
                self.plan.downtime_seconds()
            assert self._sync_started is not None
            if now - self._sync_started >= dt:
                self.downtime_accum = dt
                self.phase = Phase.DONE
        return self.phase

    @property
    def training_blocked(self) -> bool:
        return self.phase is Phase.SYNC
