"""Cluster brain + job master: the three-stage controller (paper §3–§4, Fig 4).

Copy of ``repro/core/brain.py`` (numpy only): the same three stages in
the same order, so a sequence of calls gives the same decisions in either
package.

ClusterBrain = optimizer + config DB (cluster level). JobMaster = profiler +
executor (job level). The three stages:

  ① **allocate** — a new job's ``JobResources`` is warm-started from the
     config-DB similarity search (Eqn 10) and then *refined* against the
     kind-level performance model fitted on completed-job history: a small
     deterministic grid around the warm-start plan keeps the allocation only
     if the model predicts better throughput per dollar (§4.3 Algorithm 1).
  ② **adjust** — periodic profiles → online NNLS fit (Eqns 1–6) → per-job
     NSGA-II over (RC, 1/TG) (Eqns 7–9) → cluster-level weighted greedy
     selection under the shared capacity vector (Eqns 11–14). Pareto fronts
     are re-searched on a staggered cadence and cached in between.
  ③ **guarantee** — instability signals (pod failures, stragglers, hot
     PSes, OOMs) reported by the supervisor/simulator feed an exponentially
     decayed per-job degradation penalty Φ_sp that boosts the job's WG
     weight (Eqn 14), plus predictive PS-memory scale-ups (§5.3).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.autoscaler import (
    BOUNDS, MAX_JOB_CPU, ClusterCapacity, JobState, PlanCandidate, Prices,
    ScalingOverheads, generate_candidates, get_scaler, job_seed, resource_cost,
    weighted_greedy_select,
)
from repro_torch.core.oom import OOMPredictor
from repro_torch.core.perf_model import JobResources, JobStatics, PerfModel
from repro_torch.core.sharding_service import ShardingService
from repro_torch.core.warm_start import ConfigDB, ConfigRecord, JobMeta, warm_start

Observation = Tuple[JobResources, JobStatics, float]

DEFAULT_RESOURCES = JobResources(w=2, p=1, cpu_w=4, cpu_p=4)

#: Relative severity of stage-3 instability events (OOM restarts lose the
#: most progress; stragglers/hot-PSes degrade but do not restart).
DEGRADATION_WEIGHTS: Dict[str, float] = {
    "oom": 2.0,
    "failure": 1.0,
    "straggler": 0.5,
    "hot_ps": 0.5,
}


@dataclass
class Profiler:
    """Job-level runtime collection (reported to the brain periodically)."""
    statics: JobStatics
    observations: List[Observation] = field(default_factory=list)
    oom: OOMPredictor = field(default_factory=OOMPredictor)
    max_obs: int = 256

    def record_iteration(self, resources: JobResources, t_iter: float) -> None:
        self.observations.append((resources, self.statics, t_iter))
        if len(self.observations) > self.max_obs:
            self.observations.pop(0)

    def record_memory(self, samples_consumed: float, mem_bytes: float) -> None:
        self.oom.observe(samples_consumed, mem_bytes)


@dataclass
class JobMaster:
    """One per job: owns the shard queue, profiler and executor hook."""
    job_id: str
    meta: JobMeta
    statics: JobStatics
    resources: JobResources
    total_samples: float
    sharding: ShardingService
    profiler: Profiler
    apply_plan: Optional[Callable[[JobResources], None]] = None
    samples_done: float = 0.0
    model: PerfModel = field(default_factory=PerfModel)

    def refit(self) -> None:
        if len(self.profiler.observations) >= 4:
            self.model.fit(self.profiler.observations)

    def job_state(self, rho: float = 2.5, degradation: float = 0.0) -> JobState:
        return JobState(
            job_id=self.job_id, statics=self.statics, current=self.resources,
            model=self.model,
            remaining_samples=max(self.total_samples - self.samples_done, 0.0),
            priority_rho=rho, degradation=degradation)

    def execute(self, plan: JobResources) -> None:
        self.resources = plan
        if self.apply_plan:
            self.apply_plan(plan)


@dataclass
class DegradationState:
    """Stage-3 per-job penalty Φ_sp: exponentially decayed event mass."""
    penalty: float = 0.0
    events: int = 0
    last_event_s: float = 0.0


def refine_allocation(plan: JobResources, statics: JobStatics,
                      model: PerfModel, *, prices: Prices = Prices(),
                      min_gain: float = 1.10) -> JobResources:
    """Stage-1 model refinement: deterministic grid around the warm start.

    Evaluates ×½/×1/×2 steps of each decision variable against the fitted
    kind-level model and moves only if predicted throughput-per-dollar
    improves by ≥ ``min_gain`` (the warm start already encodes history; the
    model earns overrides, it doesn't get them for free).
    """
    def score(r: JobResources) -> float:
        return model.throughput(r, statics) / max(resource_cost(r, prices), 1e-9)

    def clip(v: float, lo_hi: Tuple[float, float]) -> float:
        return min(max(v, lo_hi[0]), lo_hi[1])

    best, best_score = plan, score(plan) * min_gain
    for fw in (0.5, 1.0, 2.0):
        for fp in (0.5, 1.0, 2.0):
            for fcw in (0.5, 1.0, 2.0):
                for fcp in (0.5, 1.0, 2.0):
                    cand = dataclasses.replace(
                        plan,
                        w=int(round(clip(plan.w * fw, BOUNDS["w"]))),
                        p=int(round(clip(plan.p * fp, BOUNDS["p"]))),
                        cpu_w=clip(plan.cpu_w * fcw, BOUNDS["cpu_w"]),
                        cpu_p=clip(plan.cpu_p * fcp, BOUNDS["cpu_p"]))
                    if cand.total_cpu() > MAX_JOB_CPU:
                        continue
                    s = score(cand)
                    if s > best_score:
                        best, best_score = cand, s
    return best


def reclaim_allocation(plan: JobResources, statics: JobStatics,
                       model: PerfModel, *, prices: Prices = Prices(),
                       slack: float = 0.03, min_cut: float = 0.15
                       ) -> Optional[JobResources]:
    """Stage-2 right-sizing: the cheapest nearby config that keeps throughput.

    The weighted greedy only *grows* jobs (it requires a positive throughput
    gain), so over-provisioned allocations — the §2.2 regime the paper's
    +15 % CPU-utilization claim comes from — would never shrink without this
    pass. A deterministic shrink grid (fractional steps of each decision
    variable) is scored against the fitted model; a config is returned only
    if it cuts resource cost by ≥ ``min_cut`` while predicted throughput
    stays within ``slack`` of the current plan's.
    """
    base_thp = model.throughput(plan, statics)
    if base_thp <= 0.0:
        return None
    best: Optional[JobResources] = None
    best_cost = resource_cost(plan, prices) * (1.0 - min_cut)

    def clip(v: float, lo_hi: Tuple[float, float]) -> float:
        return min(max(v, lo_hi[0]), lo_hi[1])

    for fw in (0.75, 1.0):
        for fp in (0.5, 1.0):
            for fcw in (0.25, 0.5, 0.75, 1.0):
                for fcp in (0.5, 0.75, 1.0):
                    cand = dataclasses.replace(
                        plan,
                        w=max(int(round(clip(plan.w * fw, BOUNDS["w"]))), 1),
                        p=max(int(round(clip(plan.p * fp, BOUNDS["p"]))), 1),
                        cpu_w=clip(plan.cpu_w * fcw, BOUNDS["cpu_w"]),
                        cpu_p=clip(plan.cpu_p * fcp, BOUNDS["cpu_p"]))
                    cost = resource_cost(cand, prices)
                    if cost >= best_cost:
                        continue
                    if model.throughput(cand, statics) >= (1.0 - slack) * base_thp:
                        best, best_cost = cand, cost
    return best


class ClusterBrain:
    """The cluster-level controller; all three stages are methods here."""

    def __init__(self, capacity: ClusterCapacity, *,
                 scaler: str = "dlrover_rm",
                 prices: Prices = Prices(),
                 overheads: ScalingOverheads = ScalingOverheads(),
                 degradation_halflife_s: float = 1800.0,
                 reoptimize_every: int = 2,
                 nsga_pop: int = 24, nsga_generations: int = 12,
                 reclaim_slack: float = 0.03, reclaim_min_cut: float = 0.15,
                 reclaim_cooldown: int = 3, idle_penalty: float = 1.0,
                 trust_factor: float = 2.0):
        self.capacity = capacity
        self.config_db = ConfigDB()
        self.scaler_name = scaler
        self.prices = prices
        self.overheads = overheads
        self.masters: Dict[str, JobMaster] = {}
        # stage-1 history: pooled observations + fitted model per model kind
        self.kind_models: Dict[str, PerfModel] = {}
        self._kind_obs: Dict[str, List[Observation]] = {}
        # stage-2 staggered NSGA-II cache
        self.reoptimize_every = reoptimize_every
        self.nsga_pop = nsga_pop
        self.nsga_generations = nsga_generations
        self._round = 0
        self._optimized_at: Dict[str, int] = {}
        self._cached: Dict[str, List[PlanCandidate]] = {}
        # stage-2 right-sizing (reclaim) knobs + anti-thrash ledger
        self.reclaim_slack = reclaim_slack
        self.reclaim_min_cut = reclaim_min_cut
        self.reclaim_cooldown = reclaim_cooldown
        self.idle_penalty = idle_penalty
        self.trust_factor = trust_factor
        self._last_plan_round: Dict[str, int] = {}
        # stage-3 degradation ledger
        self.degradation_halflife_s = degradation_halflife_s
        self._degradation: Dict[str, DegradationState] = {}

    # ---------------------------------------------------------- stage 1
    def allocate(self, meta: JobMeta, statics: Optional[JobStatics] = None, *,
                 default: Optional[JobResources] = None,
                 k: int = 5, mu: float = 0.5) -> JobResources:
        """Warm-start a new job's resources, refined by the kind model."""
        plan = warm_start(meta, self.config_db, k=k, mu=mu,
                          default=default or DEFAULT_RESOURCES)
        model = self.kind_models.get(meta.model_kind)
        if model is not None and model.fitted and statics is not None:
            plan = refine_allocation(plan, statics, model, prices=self.prices)
        return plan

    def admit(self, master: JobMaster, *, k: int = 5, mu: float = 0.5
              ) -> JobResources:
        plan = self.allocate(master.meta, master.statics,
                             default=master.resources, k=k, mu=mu)
        master.execute(plan)
        self.masters[master.job_id] = master
        return plan

    # ---------------------------------------------------------- stage 2
    def adjust(self, jobs: Sequence[JobState], *, now: float = 0.0
               ) -> Dict[str, JobResources]:
        """Per-job NSGA-II (staggered, cached) + cluster weighted greedy.

        Mutates each ``JobState.degradation`` to the current stage-3 penalty
        before selection so Eqn 14's WG weights see it.
        """
        self._round += 1
        for j in jobs:
            j.degradation = self.degradation_penalty(j.job_id, now)
        candidates: Dict[str, List[PlanCandidate]] = {}
        for j in jobs:
            if not j.model.fitted:
                continue
            last = self._optimized_at.get(j.job_id)
            if last is None or self._round - last >= self.reoptimize_every:
                self._cached[j.job_id] = generate_candidates(
                    j, seed=job_seed(j.job_id), prices=self.prices,
                    overheads=self.overheads,
                    pop_size=self.nsga_pop, generations=self.nsga_generations,
                    trust_factor=self.trust_factor)
                self._optimized_at[j.job_id] = self._round
            candidates[j.job_id] = self._cached.get(j.job_id, [])
        plans = weighted_greedy_select(jobs, candidates, self.capacity,
                                       idle_penalty=self.idle_penalty)
        # right-sizing reclaim: jobs the greedy left alone give back resources
        # the model says they cannot convert into throughput (a cooldown keeps
        # shrink/regrow cycles from thrashing the same job every round)
        for j in jobs:
            jid = j.job_id
            if jid in plans:
                self._last_plan_round[jid] = self._round
                continue
            if not j.model.fitted:
                continue
            last = self._last_plan_round.get(jid)
            if last is not None and self._round - last < self.reclaim_cooldown:
                continue
            cand = reclaim_allocation(
                j.current, j.statics, j.model, prices=self.prices,
                slack=self.reclaim_slack, min_cut=self.reclaim_min_cut)
            if cand is not None:
                plans[jid] = cand
                self._last_plan_round[jid] = self._round
        return plans

    def optimize(self, now: float = 0.0) -> Dict[str, JobResources]:
        for m in self.masters.values():
            m.refit()
        jobs = [m.job_state(degradation=self.degradation_penalty(m.job_id, now))
                for m in self.masters.values()]
        if self.scaler_name == "dlrover_rm":
            plans = self.adjust(jobs, now=now)
        else:
            plans = get_scaler(self.scaler_name)(jobs, self.capacity)
        for jid, plan in plans.items():
            self.masters[jid].execute(plan)
        return plans

    # ---------------------------------------------------------- stage 3
    def report_degradation(self, job_id: str, kind: str,
                           now: float = 0.0) -> float:
        """Fold one instability event into the job's penalty Φ_sp."""
        weight = DEGRADATION_WEIGHTS.get(kind, 1.0)
        st = self._degradation.setdefault(job_id, DegradationState())
        st.penalty = self._decayed(st, now) + weight
        st.events += 1
        st.last_event_s = now
        return st.penalty

    def degradation_penalty(self, job_id: str, now: float = 0.0) -> float:
        st = self._degradation.get(job_id)
        return 0.0 if st is None else self._decayed(st, now)

    def _decayed(self, st: DegradationState, now: float) -> float:
        age = max(now - st.last_event_s, 0.0)
        return st.penalty * 0.5 ** (age / max(self.degradation_halflife_s, 1e-9))

    def check_oom(self, now: float = 0.0) -> Dict[str, float]:
        """Predictive PS memory scale-ups (GB) per job."""
        out: Dict[str, float] = {}
        for jid, m in self.masters.items():
            remaining = max(m.total_samples - m.samples_done, 0.0)
            capacity_bytes = m.resources.p * m.resources.mem_p * 1e9
            hit, peak = m.profiler.oom.will_oom(capacity_bytes, remaining)
            if hit and peak is not None:
                rec = m.profiler.oom.recommended_capacity(remaining)
                new_mem_p = max(rec / m.resources.p / 1e9, m.resources.mem_p)
                m.execute(dataclasses.replace(m.resources, mem_p=new_mem_p))
                self.report_degradation(jid, "oom", now)
                out[jid] = new_mem_p
        return out

    # ---------------------------------------------------------- completion
    def record_history(self, meta: JobMeta, statics: JobStatics,
                       observations: Sequence[Observation],
                       final_config: Optional[JobResources] = None,
                       throughput: float = 0.0) -> None:
        """Feed one finished job into stage-1 history: the config DB for the
        similarity warm start and the pooled kind-level perf-model fit."""
        if final_config is not None:
            self.config_db.add(ConfigRecord(
                meta=meta, final_config=final_config, throughput=throughput))
        pool = self._kind_obs.setdefault(meta.model_kind, [])
        pool.extend(observations[-32:])
        del pool[:-256]
        if len(pool) >= 8:
            self.kind_models[meta.model_kind] = PerfModel().fit(pool)

    def complete(self, job_id: str, throughput: float) -> None:
        m = self.masters.pop(job_id, None)
        self._degradation.pop(job_id, None)
        self._optimized_at.pop(job_id, None)
        self._cached.pop(job_id, None)
        self._last_plan_round.pop(job_id, None)
        if m is not None:
            self.record_history(m.meta, m.statics, m.profiler.observations,
                                final_config=m.resources, throughput=throughput)
