"""Port parity: the cluster trace, the job generator and the replay launcher
of the cloud simulator (``repro_torch.sim.{trace,workload,replay}``).

Both packages run the same numpy code on the same host, so the comparisons
are exact: trace rows, written bytes, marginals, synthetic traces, mapped
``SimJob``s, capacity waves, generated jobs, replay summaries, event logs
byte for byte, and the replay CLI's stdout and ``--json`` file. The port
reads its own copy of the trace fixture, which holds the reference's bytes.
The runs are small (static schedulers on a 10-job slice, 6 h); the
schedulers' event logs, ``dlrover_rm`` included, are compared in
``tests/test_torch_sim_schedulers.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from _torch_parity import plain
from repro.sim import replay as jrep
from repro.sim import trace as jtr
from repro.sim import workload as jwl
from repro_torch.sim import replay as trep
from repro_torch.sim import trace as ttr
from repro_torch.sim import workload as twl

ROOT = Path(__file__).resolve().parent.parent


def test_trace_file_is_the_reference_bytes_in_the_port():
    port, ref = Path(ttr.default_trace_path()), Path(jtr.default_trace_path())
    assert port == ROOT / "src/repro_torch/sim/data/trace_v2020_sample.csv"
    assert ref == ROOT / "src/repro/sim/data/trace_v2020_sample.csv"
    assert port.read_bytes() == ref.read_bytes()


def test_trace_rows_and_schema_as_in_the_reference():
    rows_t = ttr.load_trace(ttr.default_trace_path())
    rows_j = jtr.load_trace(jtr.default_trace_path())
    assert plain(rows_t) == plain(rows_j)
    assert ttr.TRACE_COLUMNS == jtr.TRACE_COLUMNS
    assert ttr.REPLAYABLE_STATUSES == jtr.REPLAYABLE_STATUSES
    with pytest.raises(dataclasses.FrozenInstanceError):
        rows_t[0].duration = 1.0


def test_written_trace_is_byte_identical(tmp_path):
    rows_t = ttr.load_trace(ttr.default_trace_path())
    rows_j = jtr.load_trace(jtr.default_trace_path())
    ttr.write_trace(str(tmp_path / "t.csv"), rows_t)
    jtr.write_trace(str(tmp_path / "j.csv"), rows_j)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert ttr.load_trace(str(tmp_path / "t.csv")) == rows_t


@pytest.mark.parametrize("text,match", [
    ("job,user,status\nj0,u0,Terminated\n", "bad trace header"),
    (",".join(jtr.TRACE_COLUMNS) + "\nj0,u0,Terminated,0,600,800,16,0,4\n"
     "j1,u0,Terminated,60,not_a_number,800,16,0,4\n", r"bad\.csv:3")])
def test_bad_trace_rejected_as_in_the_reference(tmp_path, text, match):
    p = tmp_path / "bad.csv"
    p.write_text(text)
    errors = []
    for mod in (ttr, jtr):
        with pytest.raises(ValueError, match=match) as info:
            mod.load_trace(str(p))
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("n,seed", [(50, 7), (600, 0)])
def test_synthesis_and_marginals_as_in_the_reference(n, seed):
    rows_t = [r for r in ttr.load_trace(ttr.default_trace_path())
              if r.status in ttr.REPLAYABLE_STATUSES]
    rows_j = [r for r in jtr.load_trace(jtr.default_trace_path())
              if r.status in jtr.REPLAYABLE_STATUSES]
    m_t, m_j = ttr.trace_marginals(rows_t), jtr.trace_marginals(rows_j)
    assert plain(m_t) == plain(m_j)
    syn_t = ttr.synthesize_trace(n, seed, marginals=m_t)
    syn_j = jtr.synthesize_trace(n, seed, marginals=m_j)
    assert plain(syn_t) == plain(syn_j)
    assert plain(ttr.trace_marginals(syn_t)) == plain(jtr.trace_marginals(syn_j))
    assert plain(ttr.synthesize_trace(n, seed)) == \
        plain(jtr.synthesize_trace(n, seed))
    for mod in (ttr, jtr):
        with pytest.raises(ValueError, match="empty trace"):
            mod.trace_marginals([])


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_trace_to_jobs_as_in_the_reference(seed):
    jobs_t = ttr.trace_to_jobs(ttr.load_trace(ttr.default_trace_path()),
                               seed=seed)
    jobs_j = jtr.trace_to_jobs(jtr.load_trace(jtr.default_trace_path()),
                               seed=seed)
    assert len(jobs_t) >= 40
    assert plain(jobs_t) == plain(jobs_j)


@pytest.mark.parametrize("amplitude,period_h,phase", [
    (0.0, 6.0, 0.0), (0.15, 6.0, 0.0), (0.5, 2.0, 0.25), (0.97, 1.0, 0.0)])
def test_capacity_wave_as_in_the_reference(amplitude, period_h, phase):
    wt = ttr.CapacityWave(2048.0, 16384.0, amplitude=amplitude,
                          period_s=period_h * 3600.0, phase=phase)
    wj = jtr.CapacityWave(2048.0, 16384.0, amplitude=amplitude,
                          period_s=period_h * 3600.0, phase=phase)
    for t in (0.0, 900.0, 1234.5, 5400.0, 7200.0, 86400.0 * 1.7):
        assert wt(t) == wj(t)


@pytest.mark.parametrize("n,seed,rate,msamples", [
    (10, 2, 60.0, 20.0), (6, 4, 30.0, 20.0), (12, 6, 30.0, 30.0)])
def test_generate_jobs_as_in_the_reference(n, seed, rate, msamples):
    jobs_t = twl.generate_jobs(n, seed=seed, arrival_rate_per_h=rate,
                               mean_msamples=msamples)
    jobs_j = jwl.generate_jobs(n, seed=seed, arrival_rate_per_h=rate,
                               mean_msamples=msamples)
    assert plain(jobs_t) == plain(jobs_j)
    for jt, jj in zip(jobs_t, jobs_j):
        for r in (jt.user_request, jt.oracle):
            rj = jwl.JobResources(**dataclasses.asdict(r))
            assert twl.true_throughput(jt, r) == jwl.true_throughput(jj, rj)
        assert twl.true_throughput(jt, jt.oracle) >= \
            twl.true_throughput(jt, jt.user_request)
        for w, p, cpu_p in ((1, 1, 1.0), (24, 2, 4.0), (64, 8, 16.0)):
            assert twl.ps_contention(w, p, cpu_p) == \
                jwl.ps_contention(w, p, cpu_p)


# ------------------------------------------------------------- replay
def _slice(mod, n=10):
    return mod.trace_to_jobs(mod.load_trace(mod.default_trace_path()),
                             seed=3)[:n]


@pytest.mark.parametrize("scheduler", ["static_user", "static_tuned"])
def test_replay_summary_and_log_as_in_the_reference(scheduler):
    """The reference test's replay settings: the first 10 trace jobs, 6 h,
    seed 3, failure seed 77, amplitude 0.15."""
    kw = dict(total_cpu=2048.0, total_mem_gb=16384.0, horizon_s=6 * 3600.0,
              seed=3, failure_seed=77, amplitude=0.15)
    res_t = trep.replay(_slice(ttr), scheduler, **kw)
    res_j = jrep.replay(_slice(jtr), scheduler, **kw)
    assert res_t.event_log() == res_j.event_log()
    assert plain(trep.summarize(res_t)) == plain(jrep.summarize(res_j))
    assert plain(res_t.records) == plain(res_j.records)
    assert res_t.ts_capacity_cpu == res_j.ts_capacity_cpu
    again = trep.replay(_slice(ttr), scheduler, **kw)
    assert again.event_log() == res_t.event_log()
    assert plain(trep.summarize(again)) == plain(trep.summarize(res_t))


def test_replay_prices_recovery_with_the_given_timings():
    """The port's ``replay`` takes measured recovery costs: the default
    ``TIMINGS`` give the reference's run, slower ones more downtime."""
    from repro_torch.core.migration import MigrationTimings
    from repro_torch.sim.cluster import TIMINGS
    kw = dict(total_cpu=2048.0, total_mem_gb=16384.0, horizon_s=6 * 3600.0,
              seed=3, failure_seed=77, amplitude=0.15)
    base = trep.replay(_slice(ttr), "static_user", timings=TIMINGS, **kw)
    ref = jrep.replay(_slice(jtr), "static_user", **kw)
    assert base.event_log() == ref.event_log()
    assert plain(base.records) == plain(ref.records)
    slow = trep.replay(_slice(ttr), "static_user", timings=MigrationTimings(
        provision_s=1800.0, rds_ckpt_load_s=1800.0), **kw)
    assert sum(r.downtime_s for r in slow.records) > \
        sum(r.downtime_s for r in base.records)


def _cli(mod, argv, capsys):
    mod.main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    ["--schedulers", "static_user,static_tuned,es,optimus",
     "--horizon-h", "6", "--capacity-amplitude", "0.15"],
    ["--schedulers", "static_user", "--synthesize", "12", "--seed", "5",
     "--capacity-cpu", "2048", "--capacity-mem-gb", "16384"]],
    ids=["baselines", "synthesized"])
def test_replay_cli_stdout_and_json_as_in_the_reference(tmp_path, capsys,
                                                       extra):
    trace = tmp_path / "slice.csv"
    rows = jtr.load_trace(jtr.default_trace_path())
    jtr.write_trace(str(trace), [r for r in rows
                                 if r.status in jtr.REPLAYABLE_STATUSES][:10])
    argv = ["--trace", str(trace), "--json", str(tmp_path / "out.json")] + extra
    out_t = _cli(trep, argv, capsys)
    json_t = (tmp_path / "out.json").read_bytes()
    out_j = _cli(jrep, argv, capsys)
    json_j = (tmp_path / "out.json").read_bytes()
    assert out_t == out_j
    assert out_t.startswith("scheduler,metric,value\n")
    assert json_t == json_j
    doc = json.loads(json_t)
    assert set(doc["event_logs"]) == set(extra[1].split(","))


def test_replay_module_runs_from_src_on_the_ports_trace():
    """``python -m repro_torch.sim.replay`` from ``src/`` finds the port's
    trace copy and prints what ``python -m repro.sim.replay`` prints."""
    args = ["--schedulers", "static_user", "--horizon-h", "3"]
    env = dict(os.environ, PYTHONPATH="")
    outs = [subprocess.run([sys.executable, "-m", f"{pkg}.sim.replay", *args],
                           cwd=ROOT / "src", env=env, capture_output=True,
                           text=True, timeout=120, check=True).stdout
            for pkg in ("repro_torch", "repro")]
    assert outs[0] == outs[1]
    assert outs[0].count("\n") == 11
