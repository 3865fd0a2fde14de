"""Synthetic job-trace generator calibrated to the paper's workloads (§6).

Copy of ``repro/sim/workload.py`` (numpy only): the same seeded
generator, so a seed gives the same jobs in either package.

Three DLRM kinds (Wide&Deep / xDeepFM / DCN) with per-kind ground-truth
(α, β) performance coefficients around the paper's reported fit
(α_grad=3.48, α_upd=2.36, α_emb≈2.45·1e-4·scale, α_sync=0.68, Σβ=2.45),
heavy-tailed job sizes, Poisson arrivals, and embedding-memory growth rates
matching Fig 1(b) (≈2.3 TB / 15 h at production scale, scaled down here).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.perf_model import JobResources, JobStatics
from repro_torch.core.warm_start import JobMeta

KINDS = ("wide_deep", "xdeepfm", "dcn")

# Per-kind ground-truth coefficients. Ratios follow the paper's Fig 11 fit
# (α_grad=3.48, α_upd=2.36, α_sync=0.68, Σβ=2.45); the absolute scale is
# normalized so a well-tuned job runs T_iter ≈ 0.2 s at batch 512 — and,
# critically, embedding lookups take 30–48 % of T_iter (Fig 1a), which is
# what makes user CPU over-provisioning show up as low utilization.
BASE_ALPHA: Dict[str, Tuple[float, float, float, float]] = {
    "wide_deep": (3.48e-3, 2.36e-3, 0.68e-3, 2.2e-5),
    "xdeepfm": (4.80e-3, 2.80e-3, 0.80e-3, 2.6e-5),
    "dcn": (3.90e-3, 2.50e-3, 0.72e-3, 3.0e-5),
}
BASE_BETA = 2.45e-3


@dataclass
class SimJob:
    job_id: str
    kind: str
    arrival_s: float
    total_samples: float
    statics: JobStatics
    meta: JobMeta
    true_alpha: Tuple[float, float, float, float]
    true_beta: float
    mem_static_gb: float
    mem_growth_gb_per_msample: float     # embedding growth (what drives OOMs)
    user_request: JobResources           # what a user would manually configure
    oracle: JobResources                 # well-tuned configuration (grid search)
    true_serial: float = 5e-5   # Amdahl: per-sample serial seconds (CPU-count
                                # invariant) — the fitted Eqn-2 model omits it,
                                # so blind CPU over-provisioning hits a wall


JOB_CPU_QUOTA = 256.0     # per-job quota (cluster policy; bounds all searches)


def ps_contention(w: float, p: float, cpu_p: float) -> float:
    """Lookup/update latency inflation when w workers share p PSes.

    The paper's Eqn 5 is a single-worker view; in reality PS-side service
    time grows superlinearly with concurrent demand (queueing), so a finite
    throughput-optimal (w, p, λ) exists. The fitted model absorbs this
    through its w/(p·λ_p) term — imperfectly, which is the realistic regime."""
    return 1.0 + (w / max(p * cpu_p, 1e-9)) ** 2


def _true_t_iter(job: "SimJob", r: JobResources) -> float:
    from repro_torch.core.perf_model import feature_vector
    x = feature_vector(r, job.statics)
    a = np.asarray(job.true_alpha, float).copy()
    cont = ps_contention(r.w, r.p, r.cpu_p)
    coef = np.concatenate([a[:3], [a[3] * cont], [job.true_beta]])
    # coordination cost grows quadratically with workers (async staleness /
    # barrier effects): creates a finite throughput-optimal worker count
    coord = job.true_serial * job.statics.batch_size * (r.w / 8.0) ** 2
    return float(x @ coef) + job.true_serial * job.statics.batch_size + coord


def true_throughput(job: SimJob, r: JobResources) -> float:
    t = _true_t_iter(job, r)
    return job.statics.batch_size * r.w / max(t, 1e-9)


def oracle_config(job: SimJob, *, max_cpu: float = JOB_CPU_QUOTA) -> JobResources:
    """Grid-search the max-throughput config under the per-job quota — the
    'well-tuned' configuration a user reaches after ~10 trial-and-error runs
    (paper §6.1)."""
    best, best_thp = None, -1.0
    for w in (1, 2, 4, 8, 12, 16, 24, 32):
        for p in (1, 2, 4, 8, 12, 16):
            for cw in (2, 4, 8, 16, 32):
                for cp in (2, 4, 8, 16, 32):
                    r = JobResources(w=w, p=p, cpu_w=cw, cpu_p=cp, mem_p=32.0)
                    if r.total_cpu() > max_cpu:
                        continue
                    thp = true_throughput(job, r)
                    if thp > best_thp * 1.02:             # prefer smaller ties
                        best, best_thp = r, thp
    assert best is not None
    return best


def generate_jobs(n: int, seed: int = 0, *, arrival_rate_per_h: float = 30.0,
                  mean_msamples: float = 30.0) -> List[SimJob]:
    rng = np.random.default_rng(seed)
    jobs: List[SimJob] = []
    t = 0.0
    for i in range(n):
        t += rng.exponential(3600.0 / arrival_rate_per_h)
        kind = KINDS[int(rng.integers(len(KINDS)))]
        a = tuple(float(x * rng.lognormal(0, 0.15)) for x in BASE_ALPHA[kind])
        b = float(BASE_BETA * rng.lognormal(0, 0.15))
        samples = float(rng.lognormal(np.log(mean_msamples * 1e6), 0.8))
        emb_rows = float(rng.lognormal(np.log(5e6), 1.0))
        statics = JobStatics(batch_size=512, model_size=emb_rows * 16 * 4,
                             bandwidth=1e9, emb_dim=16)
        meta = JobMeta(kind, dense_params=1e6 * rng.lognormal(0, 0.5),
                       emb_rows=emb_rows, emb_dim=16, batch_size=512,
                       dataset_samples=samples, user=f"user{int(rng.integers(8))}")
        job = SimJob(
            job_id=f"job{i:04d}", kind=kind, arrival_s=t,
            total_samples=samples, statics=statics, meta=meta,
            true_alpha=a, true_beta=b,
            true_serial=float(5e-5 * rng.lognormal(0, 0.3)),
            mem_static_gb=float(rng.uniform(2, 8)),
            mem_growth_gb_per_msample=float(rng.lognormal(np.log(0.5), 0.7)),
            user_request=JobResources(w=1, p=1, cpu_w=1, cpu_p=1),  # placeholder
            oracle=JobResources(w=1, p=1, cpu_w=1, cpu_p=1),
        )
        job.oracle = oracle_config(job)
        # users misconfigure: roughly quota-sized but badly *balanced*
        # (over-provisioned worker CPU, starved PS side, guessed memory) —
        # the trial-and-error regime of §2.2
        w = int(rng.choice([2, 4, 8, 16, 24, 32]))
        p = int(rng.choice([1, 1, 2, 4]))
        cpu_w = float(rng.choice([8, 16, 32, 32]))
        cpu_p = float(rng.choice([2, 4, 8]))
        scale = min(1.0, JOB_CPU_QUOTA / (w * cpu_w + p * cpu_p))
        job.user_request = JobResources(
            w=max(1, int(round(w * scale))), p=p,
            cpu_w=cpu_w, cpu_p=cpu_p, mem_w=8.0,
            mem_p=float(rng.choice([8.0, 16.0, 32.0], p=[0.45, 0.4, 0.15])),
        )
        jobs.append(job)
    return jobs
