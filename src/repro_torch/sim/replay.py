"""Trace-replay launcher: drive every scheduler over a replayed cluster trace.

Copy of ``repro/sim/replay.py``: the same flags, the same CSV rows and the
same ``--json`` output as the reference's launcher. ``replay`` also takes
the recovery costs to price (``timings``), so measured ones reach it.

The cluster-scale counterpart of ``repro_torch.launch.train``: loads (or scales up)
a v2020-shaped job trace, maps it onto simulator jobs, and replays it through
``CloudSim`` under each requested scheduler — the full three-stage
allocate/adjust/guarantee loop for ``dlrover_rm`` — printing one CSV row per
scheduler (JCT percentiles, completion rate, CPU/memory utilization, event
counts) and optionally a JSON artifact.

    PYTHONPATH=src python -m repro_torch.sim.replay --synthesize 2000 \\
        --schedulers dlrover_rm,static_user,es,optimus \\
        --capacity-cpu 16384 --capacity-amplitude 0.15 --json replay.json

Fully deterministic for a fixed ``(--seed, --failure-seed)`` pair: rows and
the per-run event log reproduce byte-for-byte.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from repro_torch.core.migration import MigrationTimings
from repro_torch.sim.cluster import TIMINGS, CloudSim, SimResult
from repro_torch.sim.trace import (
    CapacityWave, default_trace_path, load_trace, synthesize_trace,
    trace_marginals, trace_to_jobs, REPLAYABLE_STATUSES,
)


def summarize(res: SimResult) -> Dict[str, float]:
    ev = res.event_rates()
    return {
        "jobs": float(len(res.records)),
        "jcr": res.jcr(),
        "median_jct_s": res.jct_percentile(50),
        "p90_jct_s": res.jct_percentile(90),
        "cpu_util": res.mean_cpu_util(),
        "mem_util": res.mean_mem_util(),
        "oom_per_job": ev["oom_failure"],
        "failures_per_job": ev["other_failure"],
        "stragglers_per_job": ev["straggler"],
        "hot_ps_per_job": ev["hot_ps"],
    }


def replay(jobs: list, scheduler: str, *, total_cpu: float,
           total_mem_gb: float, horizon_s: float, seed: int,
           failure_seed: int, amplitude: float = 0.0,
           period_s: float = 6 * 3600.0,
           timings: MigrationTimings = TIMINGS) -> SimResult:
    """One scheduler over ``jobs``. ``timings`` prices recovery; measured
    ones come from ``SupervisorReport.measured_timings()`` and
    ``JobMasterReport.measured_timings()`` (the reference's ``replay``
    always uses ``TIMINGS``)."""
    profile: Optional[CapacityWave] = None
    if amplitude > 0.0:
        profile = CapacityWave(total_cpu, total_mem_gb, amplitude=amplitude,
                               period_s=period_s)
    sim = CloudSim(scheduler, total_cpu=total_cpu, total_mem_gb=total_mem_gb,
                   seed=seed, failure_seed=failure_seed,
                   straggler_rate_per_pod_per_day=0.3,
                   hotps_rate_per_pod_per_day=0.3,
                   capacity_profile=profile, timings=timings)
    return sim.run(jobs, horizon_s=horizon_s)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="replay a v2020-shaped cluster trace through CloudSim")
    ap.add_argument("--trace", default=None,
                    help="trace CSV (default: checked-in sample)")
    ap.add_argument("--synthesize", type=int, default=0, metavar="N",
                    help="scale up: N synthetic jobs from the trace marginals")
    ap.add_argument("--schedulers", default="dlrover_rm,static_user",
                    help="comma-separated scheduler names")
    ap.add_argument("--seed", type=int, default=0,
                    help="workload-mapping + scheduler seed")
    ap.add_argument("--failure-seed", type=int, default=77,
                    help="failure/straggler/hot-PS stream seed")
    ap.add_argument("--horizon-h", type=float, default=None,
                    help="simulated horizon (default: arrivals span + 12 h)")
    ap.add_argument("--capacity-cpu", type=float, default=4096.0)
    ap.add_argument("--capacity-mem-gb", type=float, default=32768.0)
    ap.add_argument("--capacity-amplitude", type=float, default=0.0,
                    help="sinusoidal usable-capacity swing (0.15 = ±15%%)")
    ap.add_argument("--capacity-period-h", type=float, default=6.0)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write per-scheduler summaries + event logs")
    args = ap.parse_args(argv)

    rows = load_trace(args.trace or default_trace_path())
    replayable = [r for r in rows if r.status in REPLAYABLE_STATUSES]
    if args.synthesize:
        rows = synthesize_trace(args.synthesize, args.seed,
                                trace_marginals(replayable))
    jobs = trace_to_jobs(rows, seed=args.seed)
    if not jobs:
        raise SystemExit("trace contains no replayable jobs")
    span = max(j.arrival_s for j in jobs)
    horizon_s = (args.horizon_h * 3600.0 if args.horizon_h is not None
                 else span + 12 * 3600.0)

    print("scheduler,metric,value")
    out: Dict[str, Dict[str, float]] = {}
    logs: Dict[str, str] = {}
    for name in args.schedulers.split(","):
        res = replay(jobs, name, total_cpu=args.capacity_cpu,
                     total_mem_gb=args.capacity_mem_gb, horizon_s=horizon_s,
                     seed=args.seed, failure_seed=args.failure_seed,
                     amplitude=args.capacity_amplitude,
                     period_s=args.capacity_period_h * 3600.0)
        out[name] = summarize(res)
        logs[name] = res.event_log()
        for metric, value in out[name].items():
            print(f"{name},{metric},{value:.6g}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"config": vars(args), "horizon_s": horizon_s,
                       "n_jobs": len(jobs), "summaries": out,
                       "event_logs": logs}, f, indent=2)


if __name__ == "__main__":
    main()
