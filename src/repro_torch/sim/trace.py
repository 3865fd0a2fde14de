"""Cluster-trace ingestion: Alibaba ``cluster-trace-gpu-v2020``-shaped jobs.

Copy of ``repro/sim/trace.py`` (numpy only). ``default_trace_path()``
resolves next to this module, so the port reads its own byte-identical copy
of the fixture under ``repro_torch/sim/data/``.

The loader reads the merged per-job CSV shape used by the public PAI trace
(and by the litosly trace simulator built on it): one row per job with its
submission time, runtime, per-instance resource *plan* and instance count.
Units follow the original trace: ``plan_cpu``/``plan_gpu`` are in 1/100ths
of a core/device (``600`` = 6 cores), ``plan_mem`` is in GB, times are in
seconds.

    job_name,user,status,submit_time,duration,plan_cpu,plan_mem,plan_gpu,inst_num

A small fixture (``data/trace_v2020_sample.csv``, checked in — no network)
anchors tests and the ``--fast`` benchmark mode; ``synthesize_trace`` scales
it up deterministically by drawing from the fixture's fitted marginals
(exponential interarrivals, lognormal durations/CPU/memory, geometric
instance counts), so the fig-14/15 benches can replay thousands of jobs with
the same statistical shape. ``trace_to_jobs`` maps rows onto the simulator's
``SimJob``s: the trace's resource plan becomes the user-configured request
and ``total_samples`` is calibrated so each job's runtime under that request
reproduces the traced duration. ``CapacityWave`` models the trace's
time-varying usable capacity (the litosly simulator's pattern/period knob).
"""
from __future__ import annotations

import csv
import math
import os
import zlib
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.perf_model import JobResources, JobStatics
from repro_torch.core.warm_start import JobMeta
from repro_torch.sim.workload import (
    BASE_ALPHA, BASE_BETA, JOB_CPU_QUOTA, KINDS, SimJob, oracle_config,
    true_throughput,
)

TRACE_COLUMNS = ("job_name", "user", "status", "submit_time", "duration",
                 "plan_cpu", "plan_mem", "plan_gpu", "inst_num")

#: Terminal states whose rows describe a complete, replayable job.
REPLAYABLE_STATUSES = ("Terminated",)


@dataclass(frozen=True)
class TraceJob:
    """One job row of a v2020-shaped trace (units as in the original)."""
    job_name: str
    user: str
    status: str
    submit_time: float      # seconds (trace-relative)
    duration: float         # seconds of execution
    plan_cpu: float         # per-instance CPU plan, 1/100 cores (600 = 6)
    plan_mem: float         # per-instance memory plan, GB
    plan_gpu: float         # per-instance GPU plan, 1/100 devices
    inst_num: int           # requested instances


def default_trace_path() -> str:
    """The checked-in sample trace (40 jobs, seeded, no network needed)."""
    return os.path.join(os.path.dirname(__file__), "data",
                        "trace_v2020_sample.csv")


def load_trace(path: str) -> List[TraceJob]:
    """Parse a v2020-shaped CSV; validates the header and field types."""
    rows: List[TraceJob] = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        header = tuple(reader.fieldnames or ())
        if header != TRACE_COLUMNS:
            raise ValueError(
                f"bad trace header {header!r}; expected {TRACE_COLUMNS!r}")
        for ln, rec in enumerate(reader, start=2):
            try:
                rows.append(TraceJob(
                    job_name=rec["job_name"], user=rec["user"],
                    status=rec["status"],
                    submit_time=float(rec["submit_time"]),
                    duration=float(rec["duration"]),
                    plan_cpu=float(rec["plan_cpu"]),
                    plan_mem=float(rec["plan_mem"]),
                    plan_gpu=float(rec["plan_gpu"]),
                    inst_num=int(rec["inst_num"])))
            except (KeyError, ValueError) as e:
                raise ValueError(f"{path}:{ln}: bad trace row {rec!r}") from e
    return rows


def write_trace(path: str, rows: Iterable[TraceJob]) -> None:
    """Inverse of :func:`load_trace` (byte-stable field formatting)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(TRACE_COLUMNS)
        for r in rows:
            w.writerow([r.job_name, r.user, r.status,
                        f"{r.submit_time:g}", f"{r.duration:g}",
                        f"{r.plan_cpu:g}", f"{r.plan_mem:g}",
                        f"{r.plan_gpu:g}", r.inst_num])


# ---------------------------------------------------------------- marginals
@dataclass(frozen=True)
class TraceMarginals:
    """Sufficient statistics for the synthetic generator."""
    n_jobs: int
    interarrival_mean_s: float
    log_duration_mean: float
    log_duration_std: float
    log_cpu_mean: float          # over plan_cpu (1/100 cores)
    log_cpu_std: float
    log_mem_mean: float          # over plan_mem (GB)
    log_mem_std: float
    inst_mean: float             # mean requested instances (>= 1)
    users: Tuple[str, ...]


def trace_marginals(rows: Sequence[TraceJob]) -> TraceMarginals:
    if not rows:
        raise ValueError("cannot fit marginals on an empty trace")
    subs = sorted(r.submit_time for r in rows)
    gaps = np.diff(subs)
    inter = float(np.mean(gaps)) if len(gaps) else 600.0
    ld = np.log([max(r.duration, 1.0) for r in rows])
    lc = np.log([max(r.plan_cpu, 100.0) for r in rows])
    lm = np.log([max(r.plan_mem, 1.0) for r in rows])
    inst = np.array([max(r.inst_num, 1) for r in rows], float)
    return TraceMarginals(
        n_jobs=len(rows),
        interarrival_mean_s=max(inter, 1.0),
        log_duration_mean=float(ld.mean()),
        log_duration_std=float(ld.std()) or 0.1,
        log_cpu_mean=float(lc.mean()), log_cpu_std=float(lc.std()) or 0.1,
        log_mem_mean=float(lm.mean()), log_mem_std=float(lm.std()) or 0.1,
        inst_mean=float(inst.mean()),
        users=tuple(sorted({r.user for r in rows})))


def synthesize_trace(n: int, seed: int,
                     marginals: Optional[TraceMarginals] = None,
                     ) -> List[TraceJob]:
    """Deterministic, seeded generator matching the fixture's marginals.

    Same ``(n, seed, marginals)`` ⇒ identical rows. Durations/CPU/memory are
    lognormal, interarrivals exponential, instance counts geometric — the
    family the v2020 trace's heavy-tailed job population is usually
    summarized by.
    """
    m = marginals or trace_marginals(load_trace(default_trace_path()))
    rng = np.random.default_rng(seed)
    users = m.users or ("u0",)
    out: List[TraceJob] = []
    t = 0.0
    # geometric with mean inst_mean: p = 1/mean (support starts at 1)
    p_inst = min(1.0, 1.0 / max(m.inst_mean, 1.0))
    for i in range(n):
        t += float(rng.exponential(m.interarrival_mean_s))
        dur = float(np.exp(rng.normal(m.log_duration_mean, m.log_duration_std)))
        cpu = float(np.exp(rng.normal(m.log_cpu_mean, m.log_cpu_std)))
        mem = float(np.exp(rng.normal(m.log_mem_mean, m.log_mem_std)))
        inst = int(rng.geometric(p_inst))
        out.append(TraceJob(
            job_name=f"syn{i:05d}",
            user=str(users[int(rng.integers(len(users)))]),
            status="Terminated",
            submit_time=round(t, 1),
            duration=round(max(dur, 60.0), 1),
            plan_cpu=float(np.clip(round(cpu / 100) * 100, 100, 3200)),
            plan_mem=float(np.clip(round(mem, 1), 2.0, 128.0)),
            plan_gpu=0.0,
            inst_num=int(np.clip(inst, 1, 48))))
    return out


# ------------------------------------------------------------ SimJob mapping
def _kind_of(job_name: str) -> str:
    """Stable model-kind assignment (independent of the synthesis seed)."""
    return KINDS[zlib.crc32(job_name.encode()) % len(KINDS)]


def trace_to_jobs(rows: Sequence[TraceJob], seed: int = 0, *,
                  with_oracle: bool = False,
                  min_duration_s: float = 60.0) -> List[SimJob]:
    """Map replayable trace rows onto simulator jobs.

    The trace's per-instance plan becomes the user-configured request (the
    §2.2 trial-and-error regime: plan-CPU-sized workers, a thin PS fleet),
    and ``total_samples`` is calibrated so the job's runtime *under that
    request* equals the traced ``duration`` — replaying the trace with the
    ``static_user`` scheduler reproduces the original durations, and every
    improvement a smarter scheduler shows is earned against that anchor.
    ``with_oracle`` additionally grid-searches each job's well-tuned config
    (needed only by the ``static_tuned`` baseline; it is slow at scale).
    """
    rng = np.random.default_rng(seed)
    jobs: List[SimJob] = []
    usable = [r for r in rows
              if r.status in REPLAYABLE_STATUSES
              and r.duration >= min_duration_s and r.inst_num >= 1]
    usable.sort(key=lambda r: (r.submit_time, r.job_name))
    t0 = usable[0].submit_time if usable else 0.0
    for i, row in enumerate(usable):
        kind = _kind_of(row.job_name)
        a0, a1, a2, a3 = (float(x * rng.lognormal(0, 0.15))
                          for x in BASE_ALPHA[kind])
        alpha = (a0, a1, a2, a3)
        beta = float(BASE_BETA * rng.lognormal(0, 0.15))
        inst = int(np.clip(row.inst_num, 1, 48))
        n_ps = max(1, inst // 4)
        n_w = max(1, inst - n_ps)
        cores = float(np.clip(row.plan_cpu / 100.0, 1.0, 32.0))
        cpu_p = float(rng.choice([2.0, 4.0, 8.0]))
        scale = min(1.0, JOB_CPU_QUOTA / (n_w * cores + n_ps * cpu_p))
        request = JobResources(
            w=max(1, int(round(n_w * scale))), p=n_ps,
            cpu_w=cores, cpu_p=cpu_p, mem_w=8.0,
            mem_p=float(np.clip(row.plan_mem, 4.0, 64.0)))
        emb_rows = float(rng.lognormal(np.log(5e6), 1.0))
        statics = JobStatics(batch_size=512, model_size=emb_rows * 16 * 4,
                             bandwidth=1e9, emb_dim=16)
        job = SimJob(
            job_id=f"trace{i:05d}", kind=kind,
            arrival_s=row.submit_time - t0,
            total_samples=1.0,                      # calibrated just below
            statics=statics,
            meta=JobMeta(kind, dense_params=1e6 * rng.lognormal(0, 0.5),
                         emb_rows=emb_rows, emb_dim=16, batch_size=512,
                         dataset_samples=1.0, user=row.user),
            true_alpha=alpha, true_beta=beta,
            true_serial=float(5e-5 * rng.lognormal(0, 0.3)),
            mem_static_gb=float(rng.uniform(2, 8)),
            mem_growth_gb_per_msample=float(rng.lognormal(np.log(0.3), 0.7)),
            user_request=request,
            oracle=request)
        samples = true_throughput(job, request) * row.duration
        job.total_samples = max(samples, 1e4)
        # JobMeta is frozen: rebuild it with the calibrated dataset size
        job.meta = JobMeta(kind, dense_params=job.meta.dense_params,
                           emb_rows=emb_rows, emb_dim=16, batch_size=512,
                           dataset_samples=job.total_samples, user=row.user)
        if with_oracle:
            job.oracle = oracle_config(job)
        jobs.append(job)
    return jobs


# ------------------------------------------------------- time-varying capacity
@dataclass(frozen=True)
class CapacityWave:
    """Sinusoidal usable-capacity profile (litosly's pattern/period knob).

    The shared production cluster's capacity available to elastic training
    ebbs with the colocated serving tide; ``amplitude=0.2`` means usable
    CPU/memory swings ±20 % around the base over each ``period_s``.
    """
    base_cpu: float
    base_mem_gb: float
    amplitude: float = 0.0
    period_s: float = 6 * 3600.0
    phase: float = 0.0

    def __call__(self, t: float) -> Tuple[float, float]:
        factor = 1.0 + self.amplitude * math.sin(
            2.0 * math.pi * (t / self.period_s + self.phase))
        factor = max(factor, 0.05)
        return self.base_cpu * factor, self.base_mem_gb * factor
