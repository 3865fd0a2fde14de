"""Port parity: real worker processes under the job master.

Each cell trains the reduced wide_deep DLRM for 10 steps in a REAL worker
process (``repro_torch.train.worker_main``) while ``--chaos-proc`` scripts
the worker's death: SIGKILL before a step, SIGSTOP (caught by the
heartbeat deadline), SIGKILL inside the checkpoint pre-commit window, or a
repeated kill loop. The job master re-execs it from the newest valid
layout-stamped checkpoint, and the merged per-step loss log (the latest
incarnation wins a replayed step) must equal the no-fault run's to the
ulp.

On the CPU the suite keeps a small sample, so that it loads its host
lightly while other test files run beside it: one shared baseline and at
most three worker-spawning cells, run one after another on single-thread
CPU workers (``worker_main`` sets ``torch.set_num_threads(1)`` on ``cpu``).
The padded and flat layouts and every ``n_ps`` give the same losses, so one
baseline serves every cell. The launcher's ``--chaos-proc`` and ``--chaos``
modes are held to the reference launcher: both start from the reference's
init, and their summaries agree (exactly, apart from times; losses within
LOSS_ATOL). The full 8-cell kill matrix of ``tests/test_chaos_proc.py``
runs on the card (``cuda`` marker; it skips without one):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_chaos_proc.py

Every test that spawns workers asserts, through the ``reaped`` fixture,
that no process of any worker's process group is left, live or stopped.
"""
import json
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401  (sets torch threads)
from repro.configs import dlrm_models as jcfg  # noqa: E402
from repro.core import flash_checkpoint as jfc  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.train import supervisor as jsup  # noqa: E402
from repro_torch.core.migration import MigrationTimings  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.train.job_master import (JobMaster, JobMasterConfig,  # noqa: E402
                                          JobMasterReport, WorkerSpec)

pytestmark = pytest.mark.chaos_proc

STEPS = 10
CKPT_EVERY = 3
RUN_DEADLINE_S = 300.0
HEARTBEAT_S = 8.0                   # stop cells wait this long, idle
LOSS_ATOL = 2e-5


@pytest.fixture(scope="module")
def reaped():
    """Collects the event lists of every master run of the module; at the
    end asserts that no process of any spawned worker's group is left."""
    runs = []
    yield runs
    left = []
    for events in runs:
        for pid in [ev.detail["pid"] for ev in events
                    if ev.kind == "spawned"]:
            try:
                os.killpg(pid, 0)
            except ProcessLookupError:
                continue
            left.append(pid)
    assert not left, f"worker process groups still alive: {left}"


def run_master(root, name, *, chaos, n_ps, padded, device, reaped,
               heartbeat_deadline_s=HEARTBEAT_S, max_reexecs=5):
    workdir = os.path.join(str(root), name)
    spec = WorkerSpec(name=name, workdir=workdir,
                      ckpt_dir=os.path.join(workdir, "ckpt"),
                      steps=STEPS, ckpt_every=CKPT_EVERY,
                      n_ps=n_ps, padded=padded, chaos_proc=chaos,
                      device=device)
    master = JobMaster([spec], JobMasterConfig(
        heartbeat_deadline_s=heartbeat_deadline_s,
        max_reexecs=max_reexecs, run_deadline_s=RUN_DEADLINE_S))
    reaped.append(master.events)
    return spec, master.run()


def merged_losses(spec):
    """Per-step loss with the LATEST incarnation winning replayed steps."""
    best = {}
    for rec in sorted(spec.read_losses(), key=lambda r: r["incarnation"]):
        best[rec["step"]] = rec["loss"]
    return [best[s] for s in sorted(best)]


def check_cell(spec, report, base, cell, chaos, min_reexecs):
    """The reference kill matrix's assertions on one cell."""
    assert report.completed, f"cell {cell} did not complete: {report.events}"
    assert report.final_steps[cell] == STEPS
    assert report.reexecs >= min_reexecs
    history = report.exit_history[cell]
    assert history[-1] == 0
    assert all(rc == -9 for rc in history[:-1])
    losses = merged_losses(spec)
    assert len(losses) == STEPS
    assert losses == base, (
        f"cell {cell}: recovery not bit-exact\n got  {losses}\n want {base}")
    assert len(report.reexec_latencies_s) >= min_reexecs
    assert all(lat > 0 for lat in report.reexec_latencies_s)
    assert len(report.restore_latencies_s) >= min_reexecs
    assert all(lat > 0 for lat in report.restore_latencies_s)
    with open(spec.faults_path) as f:
        fired = [json.loads(ln) for ln in f]
    assert len(fired) >= min_reexecs
    kind = chaos.split("@")[0]
    assert all(rec["fault"] == kind for rec in fired)
    if kind == "kill_ckpt":
        committed = [d for d in os.listdir(spec.ckpt_dir)
                     if d.startswith("ckpt_") and ".tmp-" not in d]
        assert committed, "no committed checkpoint survived"
    timings = report.measured_timings()
    mean = sum(report.reexec_latencies_s) / len(report.reexec_latencies_s)
    assert timings.worker_reexec_s == pytest.approx(mean)
    assert timings.reexec_s() == pytest.approx(mean)


# ---------------------------------------------------------------- CPU sample
@pytest.fixture(scope="module")
def cpu_runs(tmp_path_factory, reaped):
    """Master runs on CPU workers, each run once and shared."""
    cache = {}

    def get(name, chaos="", n_ps=4, padded=True):
        if name not in cache:
            root = tmp_path_factory.mktemp(name)
            cache[name] = run_master(root, name, chaos=chaos, n_ps=n_ps,
                                     padded=padded, device="cpu",
                                     reaped=reaped)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def cpu_baseline(cpu_runs):
    spec, report = cpu_runs("base")
    assert report.completed and report.reexecs == 0
    losses = merged_losses(spec)
    assert len(losses) == STEPS
    return losses


CPU_SAMPLE = [
    # id                     chaos     n_ps padded min_reexecs
    ("kill_at4-ps4-padded",  "kill@4", 4,   True,  1),
    ("stop_at7-ps2-flat",    "stop@7", 2,   False, 1),
]


@pytest.mark.parametrize("cell,chaos,n_ps,padded,min_reexecs", CPU_SAMPLE,
                         ids=[m[0] for m in CPU_SAMPLE])
def test_kill_sample_bit_exact_on_cpu_workers(cpu_runs, cpu_baseline, cell,
                                              chaos, n_ps, padded,
                                              min_reexecs):
    spec, report = cpu_runs(cell, chaos, n_ps, padded)
    check_cell(spec, report, cpu_baseline, cell, chaos, min_reexecs)


def test_master_event_log_roundtrip(tmp_path, cpu_runs, cpu_baseline):
    """The structured event log is valid JSONL ending in a summary line
    (written from the kill@4 cell's run)."""
    spec, report = cpu_runs("kill_at4-ps4-padded", "kill@4")
    assert report.completed
    path = os.path.join(str(tmp_path), "events.jsonl")
    master = JobMaster([spec])          # write path only needs the events
    master.events = report.events
    master.write_event_log(path, report)
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    assert lines[-1]["kind"] == "summary"
    assert lines[-1]["reexecs"] == report.reexecs
    assert lines[-1]["completed"] is True
    kinds = [ln["kind"] for ln in lines]
    assert "worker_died" in kinds and "reexec_ready" in kinds
    assert merged_losses(spec) == cpu_baseline


def test_measured_timings_shorten_sim_recovery():
    """Measured re-exec latency shrinks the worker replacement horizon from
    the 300 s pod-provision default."""
    report = JobMasterReport(
        completed=True, final_steps={"w": STEPS}, reexecs=1,
        exit_history={"w": [-9, 0]}, reexec_latencies_s=[1.7],
        restore_latencies_s=[1.1], wall_seconds=9.0, events=[])
    t = report.measured_timings()
    assert t.reexec_s() == pytest.approx(1.7)
    assert t.flash_ckpt_load_s == pytest.approx(1.1)
    assert MigrationTimings().reexec_s() == MigrationTimings().provision_s


def test_worker_argv_names_the_port_and_its_device(tmp_path):
    spec = WorkerSpec(name="w", workdir=str(tmp_path), ckpt_dir="ck",
                      device="cpu", chaos_proc="kill@4")
    argv = spec.argv(2, python="py")
    assert argv[:3] == ["py", "-m", "repro_torch.train.worker_main"]
    assert argv[argv.index("--device") + 1] == "cpu"
    assert argv[argv.index("--incarnation") + 1] == "2"
    assert WorkerSpec(name="w", workdir="d", ckpt_dir="c").device == "cuda"


# ------------------------------------------------- launchers vs the reference
def _seed_blob(ckpt_dir, hot_rows_k=0):
    """The reference's fresh init (the launchers' seed 0) as the stamped
    step-0 blob the port's run resumes from."""
    import dataclasses
    cfg = dataclasses.replace(jcfg.reduced_dlrm(jcfg.WIDE_DEEP),
                              hot_rows_k=hot_rows_k)
    jsup.DLRMJob(cfg, jfc.FlashCheckpoint(ckpt_dir, async_persist=False),
                 n_ps=4, padded=True).start(resume=False)


def _reference_launcher(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jlaunch.main()
    monkeypatch.undo()
    return capsys.readouterr().out


def _line(out, head):
    (line,) = [ln for ln in out.splitlines() if ln.startswith(head + " ")]
    return dict(re.findall(r"(\w+)=(\{[^}]*\}|\S+)", line))


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def test_launcher_chaos_proc_matches_the_reference(tmp_path, monkeypatch,
                                                   capsys, reaped):
    """``--chaos-proc kill_ckpt@3`` on a CPU worker: the same exits,
    re-execs and events as the reference launcher's JAX worker, and the
    same losses within LOSS_ATOL (both start from the reference's init)."""
    flags = ["--arch", "wide_deep", "--steps", str(STEPS), "--chaos-proc",
             "kill_ckpt@3", "--ckpt-every", str(CKPT_EVERY),
             "--padded-shards", "--heartbeat-deadline", str(HEARTBEAT_S)]
    jwork, twork = str(tmp_path / "ref"), str(tmp_path / "port")
    jout = _reference_launcher(
        flags + ["--workdir", jwork, "--event-log", jwork + ".jsonl"],
        monkeypatch, capsys)
    _seed_blob(os.path.join(twork, "ckpt"))
    run = launch.main(flags + ["--workdir", twork, "--event-log",
                               twork + ".jsonl", "--device", "cpu"])
    reaped.append(run.report.events)
    tline = _line(capsys.readouterr().out, "CHAOS-PROC")
    jline = _line(jout, "CHAOS-PROC")
    assert set(tline) == set(jline)
    for key in ("completed", "final_steps", "reexecs", "exit_history"):
        assert tline[key] == jline[key], key
    assert run.report.exit_history == {"worker0": [-9, 0]}
    jsum, tsum = (_read_jsonl(p + ".jsonl")[-1] for p in (jwork, twork))
    for key in ("completed", "final_steps", "reexecs", "exit_history"):
        assert tsum[key] == jsum[key], key
    jkinds = [e["kind"] for e in _read_jsonl(jwork + ".jsonl")[:-1]]
    tkinds = [e["kind"] for e in _read_jsonl(twork + ".jsonl")[:-1]]
    assert tkinds == jkinds
    jspec = WorkerSpec(name="worker0", workdir=jwork, ckpt_dir="")
    tlosses, jlosses = merged_losses(run.spec), merged_losses(jspec)
    assert len(tlosses) == len(jlosses) == STEPS
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=LOSS_ATOL)


def test_launcher_chaos_matches_the_reference(tmp_path, monkeypatch, capsys):
    """``--chaos`` (in process, no worker): the same events, restarts,
    steps lost and goodput as the reference launcher, losses within
    LOSS_ATOL; both start from the reference's init."""
    flags = ["--arch", "wide_deep", "--steps", "16", "--chaos",
             "ps_loss@6,ckpt_corrupt@8,ps_loss@10,oom@12",
             "--ckpt-every", "4", "--padded-shards", "--hot-rows", "24"]
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jout = _reference_launcher(
        flags + ["--ckpt-dir", jdir, "--event-log", jdir + ".jsonl"],
        monkeypatch, capsys)
    _seed_blob(tdir, hot_rows_k=24)
    run = launch.main(flags + ["--ckpt-dir", tdir, "--resume", "--device",
                               "cpu", "--event-log", tdir + ".jsonl"])
    tout = capsys.readouterr().out
    tline, jline = _line(tout, "CHAOS"), _line(jout, "CHAOS")
    assert set(tline) == set(jline)
    for key in ("completed", "final_step", "restarts", "steps_lost",
                "goodput"):
        assert tline[key] == jline[key], key
    jlog, tlog = _read_jsonl(jdir + ".jsonl"), _read_jsonl(tdir + ".jsonl")
    keep = ("fault", "n_lost", "cause", "action", "surviving_n_ps",
            "steps_lost")

    def events(log):
        return [(e["kind"], e["step"],
                 {k: e["detail"][k] for k in keep if k in e["detail"]})
                for e in log[:-1] if e["kind"] != "straggler_detected"]

    assert events(tlog) == events(jlog)
    assert abs(tlog[-1]["final_loss"] - jlog[-1]["final_loss"]) <= LOSS_ATOL
    assert run.report.restarts == 3 and run.job.n_ps == 2
    assert [e["kind"] for e in run.job.ckpt.events].count(
        "corrupt_blob_fallback") == 1


# ------------------------------------------------------ the card (cuda marker)
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the workers' kernels have no CPU "
                    "mode)")
    from repro_torch.kernels import cuda_lib
    cuda_lib.build()                    # workers load it, never build it
    return "cuda"


@pytest.fixture(scope="module")
def card_baseline(card, tmp_path_factory, reaped):
    cache = {}

    def get(n_ps, padded):
        if (n_ps, padded) not in cache:
            root = tmp_path_factory.mktemp(f"card-base-ps{n_ps}-{padded}")
            spec, report = run_master(root, "base", chaos="", n_ps=n_ps,
                                      padded=padded, device=card,
                                      reaped=reaped)
            assert report.completed and report.reexecs == 0
            losses = merged_losses(spec)
            assert len(losses) == STEPS
            cache[(n_ps, padded)] = losses
        return cache[(n_ps, padded)]

    return get


# the reference's kill matrix (tests/test_chaos_proc.py): every fault kind,
# kill step, n_ps and layout appears in at least two cells
MATRIX = [
    # id                          chaos            n_ps padded min_reexecs
    ("kill_at4-ps4-padded",       "kill@4",        4,   True,  1),
    ("kill_at7-ps2-flat",         "kill@7",        2,   False, 1),
    ("stop_at4-ps4-flat",         "stop@4",        4,   False, 1),
    ("stop_at7-ps2-padded",       "stop@7",        2,   True,  1),
    ("killckpt_at3-ps4-padded",   "kill_ckpt@3",   4,   True,  1),
    ("killckpt_at6-ps2-flat",     "kill_ckpt@6",   2,   False, 1),
    ("killloop_at4x2-ps2-padded", "kill_loop@4x2", 2,   True,  2),
    ("killloop_at7x2-ps4-flat",   "kill_loop@7x2", 4,   False, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,chaos,n_ps,padded,min_reexecs", MATRIX,
                         ids=[m[0] for m in MATRIX])
def test_kill_matrix_bit_exact_on_the_card(tmp_path, card, card_baseline,
                                           reaped, cell, chaos, n_ps, padded,
                                           min_reexecs):
    spec, report = run_master(tmp_path, cell, chaos=chaos, n_ps=n_ps,
                              padded=padded, device=card, reaped=reaped)
    check_cell(spec, report, card_baseline(n_ps, padded), cell, chaos,
               min_reexecs)
