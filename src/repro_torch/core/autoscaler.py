"""Scaling stage (paper §4.2–4.3): RC/TG objectives, NSGA-II candidate
generation, and cluster-level weighted greedy selection.

Copy of ``repro/core/autoscaler.py`` (numpy only): the same candidates,
the same seeds (crc32 of the job id) and the same greedy order. The scaler
registry is the port's own: a scaler registered here is not registered in
the reference, nor the reverse.

    RC(A)  = Σ_r a_r · Money(a_r)                            (Eqn 7)
    TG(A)  = ΔΨ_thp − Overhead(A)                            (Eqn 8)
    argmin_A (RC(A), 1/TG(A))                                (Eqn 9)
    RE(Aʲ) = TG(Aʲ)/RC(Aʲ)                                   (Eqn 11)
    argmax Σ_j RE(Aʲ)·WG(Aʲ)  s.t. Σ_j Aʲ ≤ S                (Eqn 12–13)
    WG(Aʲ) = 1 / (Φ_sp/Ψ_thp + ε)^ρ                          (Eqn 14)
"""
from __future__ import annotations

import dataclasses
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.nsga2 import nsga2
from repro_torch.core.perf_model import JobResources, JobStatics, PerfModel


@dataclass(frozen=True)
class Prices:
    """Money(a_r): unit prices (AWS-style $/h per unit, Table 1 spirit)."""
    cpu: float = 0.02
    mem_gb: float = 0.005


@dataclass(frozen=True)
class ScalingOverheads:
    """Historical scaling-cost statistics (the Overhead(A) estimator, Eqn 8)."""
    worker_start_s: float = 30.0
    ps_start_s: float = 90.0
    per_cpu_s: float = 0.2

    def overhead_seconds(self, old: JobResources, new: JobResources) -> float:
        dw = max(0, new.w - old.w)
        dp = max(0, new.p - old.p)
        dcpu = max(0.0, new.total_cpu() - old.total_cpu())
        return dw * self.worker_start_s + dp * self.ps_start_s + dcpu * self.per_cpu_s


def resource_cost(r: JobResources, prices: Prices) -> float:
    return r.total_cpu() * prices.cpu + r.total_mem() * prices.mem_gb   # Eqn 7


@dataclass
class PlanCandidate:
    job_id: str
    resources: JobResources
    rc: float                 # resource cost of the new allocation
    tg: float                 # throughput gain net of scaling overhead
    thp: float                # predicted absolute throughput

    @property
    def re(self) -> float:                                            # Eqn 11
        return self.tg / max(self.rc, 1e-9)


@dataclass
class JobState:
    """What the cluster brain knows about one running job.

    ``degradation`` is the stage-3 penalty signal Φ_sp (Eqn 14): an
    exponentially-decayed count of recent instability events (failures,
    stragglers, hot PSes, OOMs) reported back by the supervisor/simulator.
    Degraded jobs get a larger WG weight so the weighted greedy rescues
    them first — the deliverable-guarantee feedback loop of §4.3.
    """
    job_id: str
    statics: JobStatics
    current: JobResources
    model: PerfModel
    remaining_samples: float
    priority_rho: float = 2.5
    degradation: float = 0.0


def job_seed(job_id: str) -> int:
    """Process-stable per-job RNG seed (``hash(str)`` is salted per process,
    which silently broke cross-run reproducibility of the NSGA-II search)."""
    return zlib.crc32(job_id.encode()) % 2**31


BOUNDS = dict(w=(1, 32), p=(1, 16), cpu_w=(1, 32), cpu_p=(1, 32))
MAX_JOB_CPU = 256.0        # per-job quota (matches cluster policy)


def _vec_to_resources(x: np.ndarray, like: JobResources) -> JobResources:
    return dataclasses.replace(
        like, w=int(x[0]), p=int(x[1]), cpu_w=float(x[2]), cpu_p=float(x[3]))


def generate_candidates(job: JobState, *, prices: Prices = Prices(),
                        overheads: ScalingOverheads = ScalingOverheads(),
                        horizon_s: float = 600.0,
                        pop_size: int = 40, generations: int = 25,
                        seed: int = 0,
                        trust_factor: float = 0.0) -> List[PlanCandidate]:
    """Job-level NSGA-II over (RC, 1/TG) — the Pareto frontier of Eqn 9.

    ``trust_factor`` > 1 restricts the search box to a multiplicative trust
    region around the current allocation (each variable within
    ``[v/trust_factor, v·trust_factor]``): the NNLS model is fitted on
    observations near the operating point, so a plan far outside it rides on
    pure extrapolation — gradual re-centered steps are how the controller
    stays inside the region the model has earned.
    """
    base_thp = job.model.throughput(job.current, job.statics)

    def objectives(x: np.ndarray) -> Tuple[float, float]:
        r = _vec_to_resources(x, job.current)
        rc = resource_cost(r, prices)
        if r.total_cpu() > MAX_JOB_CPU:                   # per-job quota
            return rc * 100.0, 1e9
        thp = job.model.throughput(r, job.statics)
        # Overhead converted to samples over the decision horizon (Eqn 8)
        ovh = overheads.overhead_seconds(job.current, r) * base_thp / horizon_s
        tg = (thp - base_thp) - ovh
        return rc, 1.0 / max(tg, 1e-6)

    bounds = [BOUNDS["w"], BOUNDS["p"], BOUNDS["cpu_w"], BOUNDS["cpu_p"]]
    x0 = np.array([job.current.w, job.current.p, job.current.cpu_w,
                   job.current.cpu_p], float)
    if trust_factor > 1.0:
        bounds = [(max(lo, v / trust_factor), min(hi, v * trust_factor))
                  for (lo, hi), v in zip(bounds, x0)]
    seeds = [x0, x0 * 2, x0 * 0.5,
             x0 * np.array([2, 1, 1, 1]), x0 * np.array([1, 2, 1, 1]),
             x0 * np.array([1, 1, 2, 1]), x0 * np.array([1, 1, 1, 2]),
             x0 * np.array([2, 2, 1, 1]), x0 * np.array([4, 4, 1, 1])]
    front = nsga2(objectives, bounds, pop_size=pop_size,
                  generations=generations, seed=seed, init=seeds)
    out = []
    for x, f in front:
        r = _vec_to_resources(x, job.current)
        thp = job.model.throughput(r, job.statics)
        ovh = overheads.overhead_seconds(job.current, r) * base_thp / horizon_s
        out.append(PlanCandidate(job.job_id, r, rc=f[0],
                                 tg=(thp - base_thp) - ovh, thp=thp))
    return out


def weight_wg(job: JobState, thp: float, *, eps: float = 1e-6) -> float:
    """Eqn 14: prioritize shorter-remaining jobs (ρ=2.5 at AntGroup).

    The stage-3 degradation penalty Φ_sp enters multiplicatively: a job that
    recently lost pods / hit stragglers / OOMed has its weight boosted by
    ``1 + degradation`` so capacity flows to rescuing it before it misses
    its deliverable deadline.
    """
    remaining_time = job.remaining_samples / max(thp, 1e-9)
    boost = 1.0 + max(job.degradation, 0.0)
    return boost / ((remaining_time + eps) ** job.priority_rho)


@dataclass
class ClusterCapacity:
    total_cpu: float
    total_mem_gb: float


def predicted_idle_frac(job: JobState, r: JobResources) -> float:
    """Model-predicted fraction of a plan's CPU that would sit idle.

    Busy fractions follow the Eqn 2–5 decomposition: workers are busy for the
    T_grad share of an iteration, PSes for the T_upd + T_emb share. What's
    left is reserved-but-idle CPU — the §2.2 waste the utilization claim of
    Fig 14 is about."""
    br = job.model.term_breakdown(r, job.statics)
    t_iter = max(sum(br.values()), 1e-9)
    fw = min(br["grad"] / t_iter, 1.0)
    fp = min((br["upd"] + br["emb"]) / t_iter, 1.0)
    total = max(r.total_cpu(), 1e-9)
    busy = (r.w * r.cpu_w * fw + r.p * r.cpu_p * fp) / total
    return float(min(max(1.0 - busy, 0.0), 1.0))


def weighted_greedy_select(jobs: Sequence[JobState],
                           candidates: Dict[str, List[PlanCandidate]],
                           capacity: ClusterCapacity, *,
                           idle_penalty: float = 0.0
                           ) -> Dict[str, JobResources]:
    """Eqns 12–13: pick ≤1 plan per job maximizing Σ RE·WG within capacity.

    Greedy by score density; jobs keep their current allocation when no
    candidate fits (current allocations are charged against capacity first).
    ``idle_penalty`` > 0 inflates a candidate's effective resource cost by
    ``1 + idle_penalty · predicted_idle_frac`` — money prices alone make idle
    PS cores look cheap, so a utilization-aware operator charges reservations
    the model predicts will not be used.
    """
    jmap = {j.job_id: j for j in jobs}
    used_cpu = sum(j.current.total_cpu() for j in jobs)
    used_mem = sum(j.current.total_mem() for j in jobs)

    scored: List[Tuple[float, PlanCandidate]] = []
    for jid, cands in candidates.items():
        job = jmap[jid]
        for c in cands:
            if c.tg <= 0:
                continue
            re = c.re
            if idle_penalty > 0.0:
                re /= 1.0 + idle_penalty * predicted_idle_frac(job, c.resources)
            scored.append((re * weight_wg(job, c.thp), c))
    scored.sort(key=lambda t: -t[0])

    plans: Dict[str, JobResources] = {}
    for score, cand in scored:
        if cand.job_id in plans:
            continue
        job = jmap[cand.job_id]
        dcpu = cand.resources.total_cpu() - job.current.total_cpu()
        dmem = cand.resources.total_mem() - job.current.total_mem()
        if used_cpu + dcpu <= capacity.total_cpu and \
           used_mem + dmem <= capacity.total_mem_gb:
            plans[cand.job_id] = cand.resources
            used_cpu += dcpu
            used_mem += dmem
    return plans


# --- plug-in algorithm API (paper §4.3 "Plug-in Algorithm API") -----------------
ScalerFn = Callable[[Sequence[JobState], ClusterCapacity], Dict[str, JobResources]]
_REGISTRY: Dict[str, ScalerFn] = {}


def register_scaler(name: str):
    def deco(fn: ScalerFn) -> ScalerFn:
        _REGISTRY[name] = fn
        return fn
    return deco


def get_scaler(name: str) -> ScalerFn:
    return _REGISTRY[name]


def list_scalers() -> List[str]:
    return sorted(_REGISTRY)


@register_scaler("dlrover_rm")
def dlrover_rm_scaler(jobs: Sequence[JobState],
                      capacity: ClusterCapacity) -> Dict[str, JobResources]:
    """Stage-2 auto-scaling: per-job NSGA-II + cluster weighted greedy."""
    candidates = {j.job_id: generate_candidates(j, seed=job_seed(j.job_id))
                  for j in jobs if j.model.fitted}
    return weighted_greedy_select(jobs, candidates, capacity)
