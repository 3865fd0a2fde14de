"""Scheduler strategies for the cloud simulator.

Copy of ``repro/sim/schedulers.py`` (numpy only): the same five
strategies over the port's control plane.

* ``dlrover_rm`` — the paper's system: warm-start + NNLS/NSGA-II/greedy
  auto-scaling + dynamic data sharding + seamless migration + flash-ckpt +
  OOM prediction.
* ``es``       — Elastic Scheduler (Or et al. [42]): workers-only heuristic
  hill-climbing, fixed ±step, stop-and-restart transitions.
* ``optimus``  — Optimus [44]: marginal-gain greedy adding/removing one
  worker OR one PS per round, ignores transition cost, stop-and-restart.
* ``static_tuned`` / ``static_user`` — fixed allocations (oracle / user guess).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.autoscaler import ClusterCapacity, JobState
from repro_torch.core.brain import ClusterBrain
from repro_torch.core.perf_model import JobResources, JobStatics, PerfModel
from repro_torch.core.warm_start import ConfigDB, ConfigRecord
from repro_torch.sim.workload import SimJob


@dataclass
class SchedulerTraits:
    name: str
    elastic: bool = True
    warm_start: bool = False
    dynamic_sharding: bool = False      # straggler mitigation + no-restart recovery
    seamless_migration: bool = False
    flash_ckpt: bool = False
    oom_prevention: bool = False
    interval_s: float = 180.0           # decision cadence (paper §6.2: 3 min)


@dataclass
class JobRuntimeView:
    """What the scheduler can observe about a running job."""
    job: SimJob
    resources: JobResources
    samples_done: float
    observations: List[Tuple[JobResources, JobStatics, float]]
    mem_used_gb: float = 0.0
    obs_since_plan: int = 0     # fresh measurements under the current plan
    model: PerfModel = field(default_factory=PerfModel)

    def refit(self) -> None:
        if len(self.observations) >= 4:
            self.model.fit(self.observations[-128:])


class Scheduler:
    traits = SchedulerTraits(name="base", elastic=False)

    def __init__(self, capacity: ClusterCapacity, seed: int = 0):
        self.capacity = capacity
        self.rng = np.random.default_rng(seed)
        self.config_db = ConfigDB()

    # -------------------------------------------------------------- initial
    def initial_allocation(self, job: SimJob) -> JobResources:
        return job.user_request

    # -------------------------------------------------------------- periodic
    def decide(self, views: Sequence[JobRuntimeView], now: float = 0.0
               ) -> Dict[str, JobResources]:
        return {}

    # -------------------------------------------------------------- events
    def on_event(self, job_id: str, kind: str, now: float) -> None:
        """Instability signal (failure/straggler/hot_ps/oom) from the engine.

        Baselines ignore it; DLRover-RM feeds it to the brain's stage-3
        degradation ledger so the next ``decide`` prioritizes the victim."""

    def on_complete(self, view: JobRuntimeView, throughput: float) -> None:
        self.config_db.add(ConfigRecord(
            meta=view.job.meta, final_config=view.resources,
            throughput=throughput))


class StaticUser(Scheduler):
    traits = SchedulerTraits(name="static_user", elastic=False)


class StaticTuned(Scheduler):
    traits = SchedulerTraits(name="static_tuned", elastic=False)

    def initial_allocation(self, job: SimJob) -> JobResources:
        return job.oracle


class DLRoverRM(Scheduler):
    """The paper's system, driven end-to-end by the real ``ClusterBrain``:
    the simulator exercises stage 1 (similarity warm start + kind-model
    refinement) on admission, stage 2 (NSGA-II + weighted greedy) every
    decision interval, and stage 3 (degradation feedback into the WG
    weights) through ``on_event`` — the same controller object the
    launcher-side ``JobMaster`` path uses."""

    traits = SchedulerTraits(
        name="dlrover_rm", elastic=True, warm_start=True, dynamic_sharding=True,
        seamless_migration=True, flash_ckpt=True, oom_prevention=True)

    def __init__(self, capacity: ClusterCapacity, seed: int = 0):
        super().__init__(capacity, seed)
        self.brain = ClusterBrain(capacity, idle_penalty=1.0, trust_factor=2.0)
        # one config DB: completions recorded by the engine feed stage 1
        self.config_db = self.brain.config_db

    def initial_allocation(self, job: SimJob) -> JobResources:
        # stage 1: warm start from history, refined by the kind-level model.
        # Cold-start default matches the baselines' (fair comparison): the
        # advantage must come from the three-stage loop, not a better guess.
        return self.brain.allocate(
            job.meta, job.statics,
            default=JobResources(w=4, p=2, cpu_w=8, cpu_p=8))

    def on_event(self, job_id: str, kind: str, now: float) -> None:
        self.brain.report_degradation(job_id, kind, now)      # stage 3

    def on_complete(self, view: JobRuntimeView, throughput: float) -> None:
        self.brain.record_history(
            view.job.meta, view.job.statics, view.observations,
            final_config=view.resources, throughput=throughput)

    def decide(self, views: Sequence[JobRuntimeView], now: float = 0.0
               ) -> Dict[str, JobResources]:
        jobs: List[JobState] = []
        for v in views:
            v.refit()
            if not v.model.fitted:
                continue
            jobs.append(JobState(
                job_id=v.job.job_id, statics=v.job.statics, current=v.resources,
                model=v.model,
                remaining_samples=max(v.job.total_samples - v.samples_done, 0.0)))
        if not jobs:
            return {}
        plans = self.brain.adjust(jobs, now=now)              # stage 2
        # memory right-sizing: PS memory tracks observed usage + headroom
        vmap = {v.job.job_id: v for v in views}
        for jid, plan in list(plans.items()):
            v = vmap.get(jid)
            if v is not None and v.mem_used_gb > 0:
                need = max(v.mem_used_gb * 1.3 / max(plan.p, 1), 4.0)
                plans[jid] = dataclasses.replace(plan, mem_p=need)
        return plans


_BASELINE_DEFAULT = JobResources(w=4, p=2, cpu_w=8, cpu_p=8, mem_p=16.0)


class ElasticScheduler(Scheduler):
    """ES [42]: measurement-driven worker hill-climbing (workers only).

    Explores upward while per-worker scaling efficiency holds, then settles;
    re-opens exploration only if throughput later degrades ≥20 % from its
    best. Every change is a stop-and-restart transition (the engine charges
    it), which is exactly the paper's critique.
    """
    traits = SchedulerTraits(name="es", elastic=True)

    def __init__(self, capacity: ClusterCapacity, seed: int = 0):
        super().__init__(capacity, seed)
        self._last: Dict[str, Tuple[int, float]] = {}
        self._settled: Dict[str, bool] = {}
        self._best_thp: Dict[str, float] = {}

    def initial_allocation(self, job: SimJob) -> JobResources:
        return _BASELINE_DEFAULT                # sane scheduler default

    def decide(self, views: Sequence[JobRuntimeView], now: float = 0.0
               ) -> Dict[str, JobResources]:
        plans: Dict[str, JobResources] = {}
        for v in views:
            if not v.observations:
                continue
            jid = v.job.job_id
            r, s, t_iter = v.observations[-1]
            thp = s.batch_size * r.w / max(t_iter, 1e-9)
            best = self._best_thp.get(jid, 0.0)
            self._best_thp[jid] = max(best, thp)
            if self._settled.get(jid):
                if best > 0 and thp < 0.8 * best:
                    self._settled[jid] = False       # regression: re-explore
                else:
                    continue
            w = v.resources.w
            prev = self._last.get(jid)
            if prev is None:
                new_w = w + 1
            else:
                prev_w, prev_thp = prev
                gain = (thp - prev_thp) / max(prev_thp, 1e-9)
                if w > prev_w and gain > 0.05 * (w - prev_w):
                    new_w = w + 1                    # still scaling well
                elif w > prev_w:
                    new_w = prev_w                   # step back and settle
                    self._settled[jid] = True
                else:
                    new_w = w + 1
            new_w = int(np.clip(new_w, 1, 32))
            self._last[jid] = (w, thp)
            if new_w != w:
                plans[jid] = dataclasses.replace(v.resources, w=new_w)
        return plans


class Optimus(Scheduler):
    """Optimus [44]: marginal-gain greedy, ±1 worker or PS, no transition cost."""
    traits = SchedulerTraits(name="optimus", elastic=True)

    def initial_allocation(self, job: SimJob) -> JobResources:
        return _BASELINE_DEFAULT                # sane scheduler default

    def decide(self, views: Sequence[JobRuntimeView], now: float = 0.0
               ) -> Dict[str, JobResources]:
        plans: Dict[str, JobResources] = {}
        for v in views:
            v.refit()
            if not v.model.fitted:
                continue
            base = v.model.throughput(v.resources, v.job.statics)
            best, best_gain = None, 0.0
            moves = [
                dataclasses.replace(v.resources, w=v.resources.w + 1),
                dataclasses.replace(v.resources, p=v.resources.p + 1),
            ]
            if v.resources.w > 1:
                moves.append(dataclasses.replace(v.resources, w=v.resources.w - 1))
            if v.resources.p > 1:
                moves.append(dataclasses.replace(v.resources, p=v.resources.p - 1))
            for cand in moves:
                gain = (v.model.throughput(cand, v.job.statics) - base) \
                    / max(cand.total_cpu(), 1.0)
                if gain > best_gain:
                    best, best_gain = cand, gain
            # require a ≥5 % predicted throughput gain to move at all
            if best is not None and \
               v.model.throughput(best, v.job.statics) > 1.05 * base:
                plans[v.job.job_id] = best
        return plans


SCHEDULERS = {
    "dlrover_rm": DLRoverRM,
    "es": ElasticScheduler,
    "optimus": Optimus,
    "static_tuned": StaticTuned,
    "static_user": StaticUser,
}


def make_scheduler(name: str, capacity: ClusterCapacity, seed: int = 0) -> Scheduler:
    return SCHEDULERS[name](capacity, seed)
