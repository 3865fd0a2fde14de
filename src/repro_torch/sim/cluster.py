"""Discrete-time cloud-cluster simulator (shared, unstable environment of §2).

Copy of ``repro/sim/cluster.py`` (numpy only): the same event loop and the
same seeded streams, so a run gives the same ``event_log()`` byte for byte
in either package. It prices recovery with the port's ``MigrationTimings``,
which the port's ``SupervisorReport`` and ``JobMasterReport`` measure.

Models: capacity-limited job admission (pending queues), per-pod failures
(1.5 %/pod/day, §2.2), worker stragglers and hot PSes (resource contention),
embedding-memory growth → OOM, checkpoint/restart losses, and the transition
costs of scaling (stop-and-restart vs seamless migration + flash-checkpoint).

The same engine runs every scheduler strategy; behavioral differences come
only from ``SchedulerTraits`` — exactly the paper's ablation axes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.migration import MigrationTimings
from repro_torch.core.oom import OOMPredictor
from repro_torch.core.perf_model import JobResources, feature_vector
from repro_torch.sim.schedulers import JobRuntimeView, make_scheduler
from repro_torch.sim.workload import SimJob

TIMINGS = MigrationTimings()


@dataclass
class JobRecord:
    job_id: str
    kind: str
    arrival_s: float
    started_s: Optional[float] = None
    finished_s: Optional[float] = None
    completed: bool = False
    failures: int = 0
    ooms: int = 0
    stragglers: int = 0
    hot_pses: int = 0
    downtime_s: float = 0.0
    pending_s: float = 0.0

    @property
    def jct_s(self) -> Optional[float]:
        if self.finished_s is None:
            return None
        return self.finished_s - self.arrival_s


@dataclass
class _Running:
    job: SimJob
    view: JobRuntimeView
    record: JobRecord
    resources: JobResources
    samples_done: float = 0.0
    last_ckpt_samples: float = 0.0
    last_ckpt_at: float = 0.0
    blocked_until: float = 0.0
    straggler_until: float = 0.0
    hotps_until: float = 0.0
    capacity_loss_until: float = 0.0        # failed worker awaiting replacement
    pending_plan: Optional[JobResources] = None
    plan_apply_at: float = 0.0
    oom_pred: OOMPredictor = field(default_factory=OOMPredictor)

    def mem_used_gb(self) -> float:
        return self.job.mem_static_gb + \
            self.job.mem_growth_gb_per_msample * self.samples_done / 1e6

    def mem_capacity_gb(self) -> float:
        return self.resources.p * self.resources.mem_p


@dataclass
class SimResult:
    scheduler: str
    records: List[JobRecord]
    ts_time: List[float] = field(default_factory=list)
    ts_alloc_cpu: List[float] = field(default_factory=list)
    ts_used_cpu: List[float] = field(default_factory=list)
    ts_alloc_mem: List[float] = field(default_factory=list)
    ts_used_mem: List[float] = field(default_factory=list)
    ts_capacity_cpu: List[float] = field(default_factory=list)
    #: chronological (time_s, job_id, event) triples; see :meth:`event_log`
    events: List[Tuple[float, str, str]] = field(default_factory=list)

    def event_log(self) -> str:
        """Canonical one-line-per-event serialization; byte-identical for
        identical ``(scheduler seed, failure_seed, workload, config)`` —
        the determinism contract tests and benches pin."""
        return "\n".join(f"{t:.1f} {jid} {kind}"
                         for t, jid, kind in self.events)

    # ----------------------------------------------------------------- stats
    def jcr(self) -> float:
        done = sum(r.completed for r in self.records)
        return done / max(len(self.records), 1)

    def jct_percentile(self, q: float) -> float:
        vals = [r.jct_s for r in self.records if r.jct_s is not None]
        return float(np.percentile(vals, q)) if vals else float("nan")

    def mean_cpu_util(self) -> float:
        pairs = [(u, a) for u, a in zip(self.ts_used_cpu, self.ts_alloc_cpu) if a > 0]
        if not pairs:
            return 0.0
        return float(np.mean([u / a for u, a in pairs]))

    def mean_mem_util(self) -> float:
        pairs = [(u, a) for u, a in zip(self.ts_used_mem, self.ts_alloc_mem) if a > 0]
        if not pairs:
            return 0.0
        return float(np.mean([u / a for u, a in pairs]))

    def event_rates(self) -> Dict[str, float]:
        n = max(len(self.records), 1)
        return {
            "oom_failure": sum(r.ooms for r in self.records) / n,
            "other_failure": sum(r.failures for r in self.records) / n,
            "straggler": sum(r.stragglers for r in self.records) / n,
            "hot_ps": sum(r.hot_pses for r in self.records) / n,
        }


class CloudSim:
    """``failure_seed`` draws the failure/straggler/hot-PS RNG independently
    of the scheduler's ``seed`` (default preserves the historical
    ``seed + 1`` stream, so existing runs reproduce bit-for-bit);
    ``timings`` sets the recovery-time model — pass measured latencies
    (e.g. ``SupervisorReport.measured_timings()``) so the sim's failure
    model agrees with the real system's recovery costs.
    ``straggler_rebalance_s`` / ``unmitigated_s`` are the previously
    hardcoded recovery horizons of dynamic-sharding rebalance and
    no-intervention strategies. ``capacity_profile`` makes the usable
    cluster capacity time-varying (e.g. ``repro_torch.sim.trace.CapacityWave``):
    called as ``profile(now) -> (total_cpu, total_mem_gb)`` each step, it
    moves the shared ``ClusterCapacity`` the scheduler also sees — already
    admitted jobs keep running through a dip, but admission and scale-up
    decisions are bounded by the shrunken envelope."""

    def __init__(self, scheduler_name: str, *, total_cpu: float = 2048.0,
                 total_mem_gb: float = 16384.0, seed: int = 0, dt: float = 15.0,
                 pod_failure_rate_per_day: float = 0.015,
                 straggler_rate_per_pod_per_day: float = 0.05,
                 hotps_rate_per_pod_per_day: float = 0.04,
                 ckpt_interval_s: float = 1800.0,
                 enable_failures: bool = True,
                 failure_seed: Optional[int] = None,
                 timings: MigrationTimings = TIMINGS,
                 straggler_rebalance_s: float = 60.0,
                 unmitigated_s: float = 1800.0,
                 capacity_profile: Optional[
                     Callable[[float], Tuple[float, float]]] = None):
        from repro_torch.core.autoscaler import ClusterCapacity
        self.capacity = ClusterCapacity(total_cpu, total_mem_gb)
        self.capacity_profile = capacity_profile
        self.scheduler = make_scheduler(scheduler_name, self.capacity, seed)
        self.traits = self.scheduler.traits
        self.failure_seed = (seed + 1) if failure_seed is None else failure_seed
        self.rng = np.random.default_rng(self.failure_seed)
        self.dt = dt
        self.pod_failure_rate = pod_failure_rate_per_day
        self.straggler_rate = straggler_rate_per_pod_per_day
        self.hotps_rate = hotps_rate_per_pod_per_day
        self.ckpt_interval_s = ckpt_interval_s
        self.enable_failures = enable_failures
        self.timings = timings
        self.straggler_rebalance_s = straggler_rebalance_s
        self.unmitigated_s = unmitigated_s

    # ------------------------------------------------------------------
    def _true_t_iter(self, rj: _Running, r_eff: JobResources) -> float:
        x = feature_vector(r_eff, rj.job.statics)
        coef = np.concatenate([np.asarray(rj.job.true_alpha), [rj.job.true_beta]])
        return max(float(x @ coef), 1e-6)

    def _throughput(self, rj: _Running, now: float) -> Tuple[float, float, float]:
        """Effective throughput under the current disruptions.

        Hot PS: one PS at 3 % speed gates *every* worker's pull/lookup (the
        iteration waits for the slowest PS), inflating T_upd/T_emb by
        ≈ (1/0.03)/p relative to a balanced PS fleet. Worker straggler:
        async PS softens the barrier but embedding-row locking and staleness
        control still couple workers — modelled as a 50 % barrier fraction,
        throughput → (1-γ) + γ·s with γ=0.5, s=0.03 (≈ 0.515×).
        """
        r = rj.resources
        w_eff = float(r.w)
        if now < rj.capacity_loss_until:
            w_eff = max(w_eff - 1, 1.0)               # failed worker missing
        from repro_torch.sim.workload import ps_contention
        coef = np.concatenate([np.asarray(rj.job.true_alpha), [rj.job.true_beta]])
        m = rj.job.statics.batch_size
        p = float(r.p)
        cont = ps_contention(w_eff, p, r.cpu_p)
        feats = np.array([
            m / max(r.cpu_w, 1e-9),
            w_eff / max(p * r.cpu_p, 1e-9),
            (rj.job.statics.model_size / max(p, 1e-9))
            / (rj.job.statics.bandwidth / max(w_eff, 1e-9)),
            m * rj.job.statics.emb_dim / max(p, 1e-9) * cont,
            1.0])
        terms = coef * feats                          # grad, upd, sync, emb, β
        if now < rj.hotps_until:
            hot = max(1.0, (1.0 / 0.03) / max(p, 1.0))
            terms[1] *= hot
            terms[3] *= hot
        coord = rj.job.true_serial * m * (1.0 + (w_eff / 8.0) ** 2)
        t_iter = max(float(terms.sum()) + coord, 1e-6)
        thp = m * w_eff / t_iter
        if now < rj.straggler_until:
            thp *= (0.5 + 0.5 * 0.03)                 # partial sync barrier
        # busy fractions for utilization accounting
        fw = min(terms[0] / t_iter, 1.0)
        fp = min((terms[1] + terms[3]) / t_iter, 1.0)
        return thp, fw, fp

    # ------------------------------------------------------------------
    def run(self, jobs: Sequence[SimJob], horizon_s: float,
            sample_every_s: float = 300.0) -> SimResult:
        result = SimResult(self.traits.name, [])
        pending: List[SimJob] = []
        running: Dict[str, _Running] = {}
        arrivals = sorted(jobs, key=lambda j: j.arrival_s)
        ai = 0
        used_cpu_alloc = 0.0
        used_mem_alloc = 0.0
        next_decide = self.traits.interval_s
        next_sample = 0.0
        now = 0.0

        def alloc_of(r: JobResources) -> Tuple[float, float]:
            return r.total_cpu(), r.total_mem()

        def try_start(job: SimJob) -> bool:
            nonlocal used_cpu_alloc, used_mem_alloc
            r = self.scheduler.initial_allocation(job)
            cpu, mem = alloc_of(r)
            if used_cpu_alloc + cpu > self.capacity.total_cpu or \
               used_mem_alloc + mem > self.capacity.total_mem_gb:
                return False
            rec = JobRecord(job.job_id, job.kind, job.arrival_s, started_s=now)
            rec.pending_s = now - job.arrival_s
            view = JobRuntimeView(job, r, 0.0, [])
            running[job.job_id] = _Running(job, view, rec, r)
            result.records.append(rec)
            result.events.append((now, job.job_id, "start"))
            used_cpu_alloc += cpu
            used_mem_alloc += mem
            return True

        def emit(job_id: str, kind: str) -> None:
            result.events.append((now, job_id, kind))
            self.scheduler.on_event(job_id, kind, now)

        while now < horizon_s and (ai < len(arrivals) or pending or running):
            # --- time-varying capacity (trace replay) ---------------------
            if self.capacity_profile is not None:
                cap_cpu, cap_mem = self.capacity_profile(now)
                self.capacity.total_cpu = cap_cpu
                self.capacity.total_mem_gb = cap_mem
            # --- arrivals -> pending queue --------------------------------
            while ai < len(arrivals) and arrivals[ai].arrival_s <= now:
                pending.append(arrivals[ai])
                ai += 1
            still = []
            for job in pending:
                if not try_start(job):
                    still.append(job)
            pending = still

            # --- per-job progress ------------------------------------------
            for rj in list(running.values()):
                job_id = rj.job.job_id
                if now < rj.blocked_until:
                    rj.record.downtime_s += self.dt
                    continue
                # apply deferred (seamless) plan
                if rj.pending_plan is not None and now >= rj.plan_apply_at:
                    used_cpu_alloc -= rj.resources.total_cpu()
                    used_mem_alloc -= rj.resources.total_mem()
                    rj.resources = rj.pending_plan
                    rj.view.resources = rj.pending_plan
                    used_cpu_alloc += rj.resources.total_cpu()
                    used_mem_alloc += rj.resources.total_mem()
                    rj.pending_plan = None
                    rj.view.obs_since_plan = 0
                    # flash sync downtime (seamless) already tiny
                    dtime = (self.timings.flash_ckpt_save_s + self.timings.flash_ckpt_load_s
                             if self.traits.flash_ckpt else
                             self.timings.rds_ckpt_save_s + self.timings.rds_ckpt_load_s)
                    rj.blocked_until = now + dtime
                    rj.record.downtime_s += dtime
                    continue

                thp, fw, fp = self._throughput(rj, now)
                t_iter_obs = rj.job.statics.batch_size * rj.resources.w / max(thp, 1e-9)
                t_iter_obs *= float(self.rng.lognormal(0.0, 0.03))
                rj.view.observations.append(
                    (rj.resources, rj.job.statics, t_iter_obs))
                rj.view.obs_since_plan += 1
                if len(rj.view.observations) > 256:
                    rj.view.observations.pop(0)
                rj.samples_done += thp * self.dt
                rj.view.samples_done = rj.samples_done
                rj.view.mem_used_gb = rj.mem_used_gb()
                rj.oom_pred.observe(rj.samples_done, rj.mem_used_gb() * 1e9)

                # --- checkpoint cadence ------------------------------------
                if now - rj.last_ckpt_at >= self.ckpt_interval_s:
                    rj.last_ckpt_at = now
                    rj.last_ckpt_samples = rj.samples_done

                # --- OOM ----------------------------------------------------
                cap = rj.mem_capacity_gb()
                if self.traits.oom_prevention:
                    remaining = max(rj.job.total_samples - rj.samples_done, 0.0)
                    hit, peak = rj.oom_pred.will_oom(cap * 1e9, remaining)
                    if hit and rj.mem_used_gb() > 0.7 * cap:
                        need = rj.oom_pred.recommended_capacity(remaining)
                        new_mem_p = max(need / 1e9 / rj.resources.p,
                                        rj.resources.mem_p)
                        dmem = (new_mem_p - rj.resources.mem_p) * rj.resources.p
                        if used_mem_alloc + dmem <= self.capacity.total_mem_gb:
                            used_mem_alloc += dmem
                            rj.resources = dataclasses.replace(
                                rj.resources, mem_p=new_mem_p)
                            rj.view.resources = rj.resources
                if rj.mem_used_gb() > rj.mem_capacity_gb():
                    rj.record.ooms += 1
                    emit(job_id, "oom")
                    # restart with doubled PS memory from last checkpoint
                    new_mem_p = rj.resources.mem_p * 2
                    dmem = (new_mem_p - rj.resources.mem_p) * rj.resources.p
                    used_mem_alloc += dmem
                    rj.resources = dataclasses.replace(rj.resources, mem_p=new_mem_p)
                    rj.view.resources = rj.resources
                    rj.samples_done = rj.last_ckpt_samples
                    dtime = self.timings.provision_s + self.timings.rds_ckpt_load_s
                    rj.blocked_until = now + dtime
                    rj.record.downtime_s += dtime
                    continue

                # --- random instability -------------------------------------
                if self.enable_failures:
                    pods = rj.resources.w + rj.resources.p
                    p_fail = pods * self.pod_failure_rate * self.dt / 86400.0
                    if self.rng.random() < p_fail:
                        rj.record.failures += 1
                        emit(job_id, "failure")
                        if self.traits.dynamic_sharding:
                            # shard requeued; worker replaced in background.
                            # the replacement horizon is the measured re-exec
                            # latency when the job-master harness supplied one
                            # (timings.worker_reexec_s), else pod provisioning
                            rj.capacity_loss_until = now + self.timings.reexec_s()
                        else:
                            rj.samples_done = rj.last_ckpt_samples
                            dtime = self.timings.provision_s + self.timings.rds_ckpt_load_s
                            rj.blocked_until = now + dtime
                            rj.record.downtime_s += dtime
                            continue
                    p_str = rj.resources.w * self.straggler_rate * self.dt / 86400.0
                    if now >= rj.straggler_until and self.rng.random() < p_str:
                        rj.record.stragglers += 1
                        emit(job_id, "straggler")
                        if self.traits.dynamic_sharding:
                            rj.straggler_until = now + self.straggler_rebalance_s  # rebalanced
                        elif self.traits.elastic:
                            # stop-and-restart replacement at next decision
                            rj.straggler_until = now + self.traits.interval_s
                            dtime = (self.timings.rds_ckpt_save_s + self.timings.provision_s
                                     + self.timings.rds_ckpt_load_s)
                            rj.blocked_until = now + self.traits.interval_s + dtime
                            rj.record.downtime_s += dtime
                        else:
                            rj.straggler_until = now + self.unmitigated_s  # no intervention
                    p_hot = rj.resources.p * self.hotps_rate * self.dt / 86400.0
                    if now >= rj.hotps_until and self.rng.random() < p_hot:
                        rj.record.hot_pses += 1
                        emit(job_id, "hot_ps")
                        if self.traits.seamless_migration:
                            # provisioning overlaps training; flash sync at end
                            rj.hotps_until = now + self.timings.provision_s
                            sync = (self.timings.flash_ckpt_save_s
                                    + self.timings.flash_ckpt_load_s)
                            rj.record.downtime_s += sync
                        elif self.traits.elastic:
                            rj.hotps_until = now + self.traits.interval_s
                            dtime = (self.timings.rds_ckpt_save_s + self.timings.provision_s
                                     + self.timings.rds_ckpt_load_s)
                            rj.blocked_until = now + self.traits.interval_s + dtime
                            rj.record.downtime_s += dtime
                        else:
                            rj.hotps_until = now + self.unmitigated_s

                # --- completion ----------------------------------------------
                if rj.samples_done >= rj.job.total_samples:
                    rj.record.completed = True
                    rj.record.finished_s = now
                    result.events.append((now, job_id, "complete"))
                    thp_final, _, _ = self._throughput(rj, now)
                    self.scheduler.on_complete(rj.view, thp_final)
                    used_cpu_alloc -= rj.resources.total_cpu()
                    used_mem_alloc -= rj.resources.total_mem()
                    del running[job_id]

            # --- scheduler decisions ---------------------------------------
            if self.traits.elastic and now >= next_decide and running:
                # only jobs with ≥5 fresh measurements under their current
                # plan are eligible (no decisions on stale/blocked state)
                views = [rj.view for rj in running.values()
                         if rj.view.obs_since_plan >= 5]
                plans = self.scheduler.decide(views, now) if views else {}
                for jid, plan in plans.items():
                    rj = running.get(jid)
                    if rj is None or rj.pending_plan is not None:
                        continue
                    dcpu = plan.total_cpu() - rj.resources.total_cpu()
                    dmem = plan.total_mem() - rj.resources.total_mem()
                    if used_cpu_alloc + dcpu > self.capacity.total_cpu or \
                       used_mem_alloc + dmem > self.capacity.total_mem_gb:
                        continue
                    result.events.append((now, jid, "plan"))
                    if self.traits.seamless_migration:
                        rj.pending_plan = plan
                        rj.plan_apply_at = now + self.timings.provision_s
                    else:
                        dtime = (self.timings.rds_ckpt_save_s + self.timings.provision_s
                                 + self.timings.rds_ckpt_load_s)
                        used_cpu_alloc += dcpu
                        used_mem_alloc += dmem
                        rj.resources = plan
                        rj.view.resources = plan
                        rj.view.obs_since_plan = 0
                        rj.blocked_until = now + dtime
                        rj.record.downtime_s += dtime
                next_decide = now + self.traits.interval_s

            # --- cluster sampling --------------------------------------------
            if now >= next_sample:
                used_cpu = 0.0
                used_mem = 0.0
                for rj in running.values():
                    if now < rj.blocked_until:
                        pass
                    else:
                        _, fw, fp = self._throughput(rj, now)
                        used_cpu += (rj.resources.w * rj.resources.cpu_w * fw
                                     + rj.resources.p * rj.resources.cpu_p * fp)
                    used_mem += min(rj.mem_used_gb() + rj.resources.w
                                    * rj.resources.mem_w * 0.4,
                                    rj.resources.total_mem())
                result.ts_time.append(now)
                result.ts_alloc_cpu.append(used_cpu_alloc)
                result.ts_used_cpu.append(used_cpu)
                result.ts_alloc_mem.append(used_mem_alloc)
                result.ts_used_mem.append(used_mem)
                result.ts_capacity_cpu.append(self.capacity.total_cpu)
                next_sample = now + sample_every_s

            now += self.dt
            if now >= horizon_s:
                break
        return result
