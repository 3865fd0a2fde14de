"""Job-master daemon (paper §3/§5): real worker processes, re-exec'd on death.

Port of ``repro/train/job_master.py``. The workers it spawns run
``python -m repro_torch.train.worker_main`` on the device named by
``WorkerSpec.device`` (``cuda`` unless ``cpu`` is asked for), and a dead
worker's whole process group is killed, so nothing it started outlives it.

The supervisor heals a job *inside one interpreter* — injected faults are
scripted exceptions, and the watchdog can only abandon an attempt. The
paper's reliability claims, though, are about processes dying in a real
cluster: pod evictions (SIGKILL), wedged parameter servers (a process that
stops answering without exiting), kills that land mid-checkpoint-write.
This module is the job-master side of that contract:

* ``WorkerSpec`` — the launch recipe of one worker: the argv of
  ``repro_torch.train.worker_main`` (a real ``DLRMJob`` loop), its heartbeat /
  loss-log / checkpoint paths, and its ``--chaos-proc`` fault plan.
* ``JobMaster`` — spawns each worker as a subprocess, monitors **heartbeat
  files + exit codes**, and re-execs dead workers with capped exponential
  backoff. A worker that exits nonzero (or is SIGKILLed) is re-exec'd; a
  worker whose heartbeat goes stale without exiting (SIGSTOP, wedged native
  call) is SIGKILLed first — the kill path the in-process watchdog could
  only model. The re-exec'd incarnation restores the newest *valid*
  layout-stamped flash checkpoint (``DLRMJob.start(resume=True)`` →
  ``resume_dlrm_stamped``), so recovery is bit-exact by construction.
* ``JobMasterReport`` — outcome + measured re-exec/restore latencies;
  ``measured_timings()`` maps them onto ``repro_torch.core.migration.
  MigrationTimings``, the horizon a cluster simulator prices worker
  replacement with, instead of a pod-provision constant.

Heartbeat protocol (one JSON file per worker, atomically replaced)::

    {"pid": ..., "incarnation": k, "step": n, "phase": p, "t": wall,
     "restore_s": r}
    phase: "boot"  - process alive, heavy imports / device set-up in progress
           "ready" - restored (from step n) and warmed up; restore_s measured
           "step"  - completed global step n
           "done"  - finished all steps; exiting 0

Staleness uses the payload's own wall clock: a worker in "boot" gets
``spawn_grace_s`` (``import torch``, a CUDA context, the kernel library's
load and, with a cold ``build/``, its first-use ``nvcc`` build), after
that each heartbeat
must arrive within ``heartbeat_deadline_s``. A heartbeat whose incarnation
is not the live one is a dead incarnation's leftover and counts as "boot".

This module is deliberately **stdlib-only** (no torch import): the master
must stay responsive while workers boot, and its own failure domain
should not include the accelerator stack.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, IO, List, Optional, Sequence, Tuple

from repro_torch.core.migration import MigrationTimings

#: repo ``src`` dir, so spawned workers resolve ``repro_torch`` like the
#: master did
_SRC_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))

PHASES = ("boot", "ready", "step", "done")


class ReexecBudgetExceeded(RuntimeError):
    """A worker kept dying past the capped re-exec budget; the job failed."""


class JobMasterDeadlineExceeded(RuntimeError):
    """The whole run overshot ``run_deadline_s`` (e.g. a hung re-exec)."""


# ------------------------------------------------------------------ heartbeat
def write_heartbeat(path: str, *, pid: int, incarnation: int, step: int,
                    phase: str, restore_s: float = 0.0) -> None:
    """Atomically publish a worker heartbeat (tmp file + ``os.replace``)."""
    if phase not in PHASES:
        raise ValueError(f"unknown heartbeat phase {phase!r}")
    payload = {"pid": int(pid), "incarnation": int(incarnation),
               "step": int(step), "phase": phase, "t": time.time(),
               "restore_s": float(restore_s)}
    tmp = f"{path}.tmp-{pid}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def read_heartbeat(path: str) -> Optional[Dict[str, Any]]:
    """Read the newest heartbeat; None when absent (never raises on torn
    content — writes are atomic, but the very first read may race the
    worker's first publish)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


# ----------------------------------------------------------------- worker spec
@dataclass(frozen=True)
class WorkerSpec:
    """Launch recipe of one named worker process.

    The master re-execs the same argv on every death, with only
    ``--incarnation`` advanced — the worker derives everything else
    (restore point, fault gating) from the checkpoint dir and the plan.
    """
    name: str
    workdir: str                     # heartbeat / loss-log / stdout live here
    ckpt_dir: str
    arch: str = "wide_deep"
    steps: int = 10
    ckpt_every: int = 3
    n_ps: int = 4
    padded: bool = True
    chaos_proc: str = ""             # ProcessFaultInjector plan (may be "")
    opt_name: str = "adagrad"
    lr: float = 0.05
    init_seed: int = 0
    data_seed: int = 11
    device: str = "cuda"             # the worker's --device (cuda or cpu)
    extra_args: Tuple[str, ...] = ()

    @property
    def heartbeat_path(self) -> str:
        return os.path.join(self.workdir, f"hb_{self.name}.json")

    @property
    def losses_path(self) -> str:
        return os.path.join(self.workdir, f"losses_{self.name}.jsonl")

    @property
    def faults_path(self) -> str:
        return os.path.join(self.workdir, f"faults_{self.name}.jsonl")

    def argv(self, incarnation: int, python: str = sys.executable) -> List[str]:
        cmd = [python, "-m", "repro_torch.train.worker_main",
               "--arch", self.arch, "--steps", str(self.steps),
               "--ckpt-dir", self.ckpt_dir,
               "--ckpt-every", str(self.ckpt_every),
               "--n-ps", str(self.n_ps),
               "--optimizer", self.opt_name, "--lr", str(self.lr),
               "--init-seed", str(self.init_seed),
               "--data-seed", str(self.data_seed),
               "--heartbeat", self.heartbeat_path,
               "--losses", self.losses_path,
               "--fault-log", self.faults_path,
               "--incarnation", str(incarnation),
               "--device", self.device]
        if self.padded:
            cmd.append("--padded")
        if self.chaos_proc:
            cmd += ["--chaos-proc", self.chaos_proc]
        cmd += list(self.extra_args)
        return cmd

    def read_losses(self) -> List[Dict[str, Any]]:
        """All recorded ``{incarnation, step, loss}`` lines, across every
        incarnation (replayed steps appear once per incarnation)."""
        out = []
        try:
            with open(self.losses_path) as f:
                for line in f:
                    if line.strip():
                        out.append(json.loads(line))
        except FileNotFoundError:
            return []                    # no incarnation recorded a step yet
        return out


# --------------------------------------------------------------------- config
@dataclass
class JobMasterConfig:
    """Monitor cadence, staleness deadlines, and the re-exec policy."""
    poll_interval_s: float = 0.05
    heartbeat_deadline_s: float = 10.0   # after "ready": stale => SIGKILL
    spawn_grace_s: float = 120.0         # boot -> ready (imports, CUDA
                                         # context, kernel library)
    max_reexecs: int = 5                 # capped re-exec budget per worker
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    backoff_jitter: float = 0.25         # ± fraction, deterministic from seed
    seed: int = 0
    run_deadline_s: Optional[float] = None   # whole-run wall cap; None = off


@dataclass
class JobMasterEvent:
    """One structured entry of the spawn → death → re-exec log."""
    t: float
    kind: str                  # spawned | worker_died | heartbeat_stale | ...
    worker: str
    detail: Dict[str, Any] = field(default_factory=dict)


@dataclass
class JobMasterReport:
    """Outcome + measured recovery costs of one mastered run."""
    completed: bool
    final_steps: Dict[str, int]
    reexecs: int
    exit_history: Dict[str, List[int]]       # worker -> exit codes seen
    reexec_latencies_s: List[float]          # death detect -> next "ready"
    restore_latencies_s: List[float]         # worker-measured ckpt restores
    wall_seconds: float
    events: List[JobMasterEvent]

    def measured_timings(self) -> MigrationTimings:
        """Feed measured process-recovery latencies into the cluster sim.

        Re-exec latency (death → replacement ready) maps onto
        ``worker_reexec_s`` — the horizon a cluster simulator uses for
        dynamic-sharding worker replacement — and the worker's own measured
        flash-restore time onto ``flash_ckpt_load_s``.
        """
        kw: Dict[str, float] = {}
        if self.reexec_latencies_s:
            kw["worker_reexec_s"] = max(
                sum(self.reexec_latencies_s) / len(self.reexec_latencies_s),
                1e-3)
        if self.restore_latencies_s:
            kw["flash_ckpt_load_s"] = max(
                sum(self.restore_latencies_s) / len(self.restore_latencies_s),
                1e-3)
        return MigrationTimings(**kw)


# ----------------------------------------------------------------- the daemon
class _WorkerState:
    """Mutable monitor-side record of one worker (master internal)."""

    def __init__(self, spec: WorkerSpec):
        self.spec = spec
        self.proc: Optional[subprocess.Popen] = None
        self.log_file: Optional[IO[bytes]] = None
        self.incarnation = -1
        self.spawned_at = 0.0
        self.death_detected_at: Optional[float] = None
        self.ready_seen = False          # current incarnation reached "ready"
        self.completed = False
        self.reexecs = 0
        self.exit_codes: List[int] = []
        self.final_step = -1


class JobMaster:
    """Spawn, monitor (heartbeats + exit codes), and re-exec real workers.

    ``run()`` returns when every worker's process exited 0 with a "done"
    heartbeat at ``spec.steps``; it raises ``ReexecBudgetExceeded`` when a
    worker dies past its budget, ``JobMasterDeadlineExceeded`` when the
    whole run overshoots ``run_deadline_s``. Live workers are always killed
    on the way out — the master never leaks processes.
    """

    def __init__(self, workers: Sequence[WorkerSpec],
                 config: Optional[JobMasterConfig] = None, *,
                 python: str = sys.executable):
        if not workers:
            raise ValueError("JobMaster needs at least one WorkerSpec")
        names = [w.name for w in workers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate worker names: {names}")
        self.config = config or JobMasterConfig()
        self.python = python
        self._workers = [_WorkerState(w) for w in workers]
        self.events: List[JobMasterEvent] = []
        self.reexec_latencies_s: List[float] = []
        self.restore_latencies_s: List[float] = []
        # deterministic backoff jitter without numpy: seeded stdlib Random
        import random
        self._rng = random.Random(self.config.seed)

    # ------------------------------------------------------------------ log
    def _event(self, kind: str, worker: str, **detail: Any) -> JobMasterEvent:
        ev = JobMasterEvent(time.time(), kind, worker, detail)
        self.events.append(ev)
        return ev

    def write_event_log(self, path: str,
                        report: Optional[JobMasterReport] = None) -> None:
        """Dump the structured event log as JSONL; a final ``summary`` line
        carries the report's metrics (same shape as the supervisor's log)."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(asdict(ev)) + "\n")
            if report is not None:
                lat = report.reexec_latencies_s
                f.write(json.dumps({
                    "kind": "summary", "completed": report.completed,
                    "final_steps": report.final_steps,
                    "reexecs": report.reexecs,
                    "exit_history": report.exit_history,
                    "reexec_latency_mean_s":
                        sum(lat) / len(lat) if lat else 0.0,
                    "wall_seconds": report.wall_seconds}) + "\n")

    # ---------------------------------------------------------------- spawn
    def _spawn(self, ws: _WorkerState) -> None:
        ws.incarnation += 1
        spec = ws.spec
        os.makedirs(spec.workdir, exist_ok=True)
        env = dict(os.environ)
        env["PYTHONPATH"] = _SRC_DIR + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        log_path = os.path.join(spec.workdir,
                                f"{spec.name}.{ws.incarnation}.log")
        if ws.log_file is not None:
            ws.log_file.close()
        ws.log_file = open(log_path, "ab")
        ws.proc = subprocess.Popen(
            spec.argv(ws.incarnation, self.python), env=env,
            stdout=ws.log_file, stderr=subprocess.STDOUT,
            start_new_session=True)      # its own process group: clean kills
        ws.spawned_at = time.time()
        ws.ready_seen = False
        self._event("spawned", spec.name, incarnation=ws.incarnation,
                    pid=ws.proc.pid, log=log_path)

    def _kill_group(self, ws: _WorkerState) -> None:
        """SIGKILL every process left in the worker's process group (the
        worker leads its own session, so its pid is the group id)."""
        assert ws.proc is not None
        try:
            os.killpg(ws.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            # the group is empty: the worker exited and started nothing
            # that outlived it
            return

    def _kill(self, ws: _WorkerState) -> None:
        """SIGKILL a live worker and its process group (also reaps the
        worker); no-op when already dead."""
        if ws.proc is not None and ws.proc.poll() is None:
            try:
                os.killpg(ws.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                # exited between poll() and kill(); the wait() below reaps it
                self._event("kill_raced_exit", ws.spec.name,
                            incarnation=ws.incarnation, pid=ws.proc.pid)
            ws.proc.wait(timeout=30)

    def _backoff_s(self, ws: _WorkerState) -> float:
        c = self.config
        d = min(c.backoff_base_s * 2 ** max(ws.reexecs - 1, 0), c.backoff_cap_s)
        return max(d * (1.0 + c.backoff_jitter * self._rng.uniform(-1, 1)), 0.0)

    # -------------------------------------------------------------- monitor
    def _heartbeat(self, ws: _WorkerState) -> Optional[Dict[str, Any]]:
        """Current incarnation's heartbeat, or None while it hasn't spoken."""
        hb = read_heartbeat(ws.spec.heartbeat_path)
        if hb is None or hb.get("incarnation") != ws.incarnation:
            return None                  # a dead incarnation's leftover
        return hb

    def _stale(self, ws: _WorkerState, hb: Optional[Dict[str, Any]],
               now: float) -> Optional[str]:
        """Staleness verdict: None = healthy, else a reason string."""
        c = self.config
        if hb is None or hb.get("phase") == "boot":
            since = now - ws.spawned_at
            if since > c.spawn_grace_s:
                return f"no ready heartbeat within spawn grace ({since:.1f}s)"
            return None
        since = now - float(hb.get("t", 0.0))
        if since > c.heartbeat_deadline_s:
            return (f"heartbeat stale {since:.1f}s > "
                    f"{c.heartbeat_deadline_s}s (phase={hb.get('phase')}, "
                    f"step={hb.get('step')})")
        return None

    def _observe_recovery(self, ws: _WorkerState,
                          hb: Optional[Dict[str, Any]]) -> None:
        """First ready/step/done heartbeat of a re-exec'd incarnation closes
        the death → ready latency measurement."""
        if hb is None or ws.ready_seen or hb.get("phase") == "boot":
            return
        ws.ready_seen = True
        if ws.death_detected_at is not None:
            latency = time.time() - ws.death_detected_at
            self.reexec_latencies_s.append(latency)
            # incarnation 0's "restore" is a fresh init, not a checkpoint
            # load — only re-exec'd incarnations feed the restore mean
            if float(hb.get("restore_s", 0.0)) > 0.0:
                self.restore_latencies_s.append(float(hb["restore_s"]))
            self._event("reexec_ready", ws.spec.name,
                        incarnation=ws.incarnation,
                        reexec_latency_s=round(latency, 4),
                        resumed_step=hb.get("step"))
            ws.death_detected_at = None

    def _handle_death(self, ws: _WorkerState, cause: str, **detail: Any) -> None:
        ws.death_detected_at = time.time()
        self._event(cause, ws.spec.name, incarnation=ws.incarnation, **detail)
        ws.reexecs += 1
        if ws.reexecs > self.config.max_reexecs:
            self._event("reexec_budget_exceeded", ws.spec.name,
                        reexecs=ws.reexecs - 1,
                        budget=self.config.max_reexecs)
            raise ReexecBudgetExceeded(
                f"worker {ws.spec.name!r}: {ws.reexecs - 1} re-execs "
                f"exhausted the budget of {self.config.max_reexecs} "
                f"(last cause: {cause})")
        delay = self._backoff_s(ws)
        time.sleep(delay)
        self._spawn(ws)
        self._event("reexec", ws.spec.name, incarnation=ws.incarnation,
                    backoff_s=round(delay, 4), cause=cause)

    def _poll_one(self, ws: _WorkerState, now: float) -> None:
        assert ws.proc is not None
        hb = self._heartbeat(ws)
        self._observe_recovery(ws, hb)
        rc = ws.proc.poll()
        if rc is not None:
            self._kill_group(ws)         # anything the worker left running
            ws.exit_codes.append(rc)
            if rc == 0 and hb is not None and hb.get("phase") == "done" \
                    and int(hb.get("step", -1)) >= ws.spec.steps:
                ws.completed = True
                ws.final_step = int(hb["step"])
                self._event("worker_done", ws.spec.name,
                            incarnation=ws.incarnation, step=ws.final_step)
                return
            self._handle_death(
                ws, "worker_died", exit_code=rc,
                signal=signal.Signals(-rc).name if rc < 0 else None,
                last_step=None if hb is None else hb.get("step"))
            return
        reason = self._stale(ws, hb, now)
        if reason is not None:
            # alive but silent: SIGSTOPped or wedged — kill the husk first
            self._kill(ws)
            ws.exit_codes.append(-signal.SIGKILL)
            self._handle_death(ws, "heartbeat_stale", reason=reason,
                               last_step=None if hb is None else hb.get("step"))

    # ------------------------------------------------------------------ run
    def run(self) -> JobMasterReport:
        t_start = time.time()
        try:
            for ws in self._workers:
                self._spawn(ws)
            while not all(ws.completed for ws in self._workers):
                if self.config.run_deadline_s is not None and \
                        time.time() - t_start > self.config.run_deadline_s:
                    self._event("run_deadline_exceeded", "*",
                                deadline_s=self.config.run_deadline_s)
                    raise JobMasterDeadlineExceeded(
                        f"job master overshot run_deadline_s="
                        f"{self.config.run_deadline_s}")
                time.sleep(self.config.poll_interval_s)
                now = time.time()
                for ws in self._workers:
                    if not ws.completed:
                        self._poll_one(ws, now)
        finally:
            for ws in self._workers:
                self._kill(ws)
                if ws.log_file is not None:
                    ws.log_file.close()
                    ws.log_file = None
        return JobMasterReport(
            completed=all(ws.completed for ws in self._workers),
            final_steps={ws.spec.name: ws.final_step for ws in self._workers},
            reexecs=sum(ws.reexecs for ws in self._workers),
            exit_history={ws.spec.name: list(ws.exit_codes)
                          for ws in self._workers},
            reexec_latencies_s=list(self.reexec_latencies_s),
            restore_latencies_s=list(self.restore_latencies_s),
            wall_seconds=time.time() - t_start,
            events=list(self.events))
