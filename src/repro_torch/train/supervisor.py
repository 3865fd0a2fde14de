"""Self-healing supervisor over the real DLRM training loop (paper §5).

Port of ``repro/train/supervisor.py``. Where torch differs from JAX:

* The fused step updates the pooled stores in place, which JAX arrays
  never do. So the step's first-use costs (the kernel library's load, the
  allocator, cuBLAS) are paid by a warm-up step on a *copy* of the state
  (``DLRMJob._build_step``): a warm-up on the live state would advance it by
  one step. Faults fire in the step's ``before`` hook, ahead of the first
  in-place kernel, and every recovery puts *new* tensors into
  ``DLRMJob.state`` (``elastic.resume_dlrm_stamped`` copies every leaf),
  never the live pools an abandoned attempt may have written.
* Attempts run on the watchdog's worker thread. A thread's current CUDA
  device is its own, so ``run_step`` names the job's device explicitly.

DLRover-RM's reliability pillar: an unstable shared cloud loses ~1.5 %/pod/
day, stragglers appear from resource contention, and jobs hang. The paper's
JCT/completion-rate wins come from *detecting* these abnormalities and
recovering fast — flash checkpoints plus elastic re-scaling — rather than
restarting from scratch. This module is that loop on the repo's real
training path:

* ``DLRMJob`` — one restartable DLRM training job: deterministic batches
  keyed by **global step** (the property that makes recovery bit-exact),
  layout-stamped flash checkpoints on a cadence, and typed recovery entry
  points (restore, elastic shrink onto surviving PS shards, graceful
  degradation after OOM).
* ``Supervisor`` — wraps the job with a step-deadline **watchdog** (hang
  detection via a cancellable worker thread), **EWMA step-time straggler
  detection**, and a recovery driver with exponential backoff + jitter and
  a capped restart budget. Every fault → detect → recover transition lands
  in a structured event log with recovery-latency and steps-lost metrics.

Recovery is bit-exact: batches are a pure function of the global step, flash
checkpoints verify per-leaf checksums, and restore falls back to the newest
*valid* blob — so the post-recovery loss trajectory equals the no-fault
run's after the restored step (``tests/test_torch_supervisor.py`` asserts
equality, not closeness).

Scope note: the watchdog abandons a hung *attempt* (injected stalls are
cancellable sleeps and unwind via ``AttemptAbandoned``); a truly wedged
native call can only be killed at process level. That process level exists:
``repro_torch.train.job_master`` promotes this supervisor to a daemon that
spawns ``DLRMJob`` loops as real subprocesses
(``repro_torch.train.worker_main``),
monitors heartbeat files + exit codes, and re-execs dead workers from the
newest valid checkpoint — its public names are re-exported here so the
in-process and process-level supervision surfaces live side by side.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.dlrm_models import DLRMConfig
from repro_torch.core.faults import (
    AttemptAbandoned, FaultError, FaultInjector, PSShardLoss, TransientOOM,
)
from repro_torch.core.flash_checkpoint import FlashCheckpoint
from repro_torch.core.migration import MigrationTimings
from repro_torch.data.synthetic import criteo_batch
from repro_torch.kernels import cuda_lib
from repro_torch.launch.train import resolve_device, to_device
from repro_torch.sharding.policy import (
    PaddedLayout, padded_layout_for_ranges, uniform_vocab_ranges,
)
from repro_torch.train.job_master import (  # noqa: F401  (process-level surface)
    JobMaster, JobMasterConfig, JobMasterReport, ReexecBudgetExceeded,
    WorkerSpec,
)
from repro_torch.train import elastic, optim, replan
from repro_torch.train import trainer as trainer_mod


class RestartBudgetExceeded(RuntimeError):
    """The supervisor's capped restart budget ran out; the job is failed."""


def _clone(tree):
    """A copy of a train state whose tensors share no storage with it."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if torch.is_tensor(tree) else tree


# ------------------------------------------------------------------------ job
class DLRMJob:
    """One restartable DLRM training job (the unit a supervisor heals).

    Batches are generated directly from the deterministic synthetic stream,
    indexed by global step — sample ``i`` of step ``n`` is absolute sample
    ``n * batch_size + i`` — so a replay after restore consumes byte-
    identical data (the §5.1 exactly-once property, applied to recovery).

    Args:
      cfg:        the DLRM workload config.
      ckpt:       flash-checkpoint store (memory + optional disk tier).
      opt_name:   optimizer name ("adagrad", "adam", ...).
      lr:         learning rate.
      init_seed:  PRNG seed of the fresh-parameter init.
      data_seed:  seed of the deterministic sample stream.
      ckpt_every: checkpoint cadence in global steps.
      n_ps:       PS shard count of the (padded) placement plan.
      padded:     materialize physically-unequal PS shards (PaddedLayout).
      sparse_update: build the step with the fused sparse backward +
                  row-wise optimizer update (``EmbeddingPlan.sparse_update``);
                  requires an optimizer with an ``update_rows`` seam.
      injector:   optional ``FaultInjector`` wired through the batch hook.
      device:     where the state and the steps live: ``cuda`` unless
                  ``cpu`` is asked for (``resolve_device`` raises when CUDA
                  is asked for and absent; nothing falls back).
    """

    def __init__(self, cfg: DLRMConfig, ckpt: FlashCheckpoint, *,
                 opt_name: str = "adagrad", lr: float = 0.05,
                 init_seed: int = 0, data_seed: int = 11,
                 ckpt_every: int = 10, n_ps: int = 4, padded: bool = False,
                 sparse_update: bool = False,
                 injector: Optional[FaultInjector] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(str(device))
        self.ckpt = ckpt
        self.opt_name = opt_name
        self.opt = optim.make(opt_name, lr)
        self.init_seed = init_seed
        self.data_seed = data_seed
        self.ckpt_every = max(int(ckpt_every), 1)
        self.n_ps = int(n_ps)
        self.injector = injector
        self.layout: Optional[PaddedLayout] = None
        if padded:
            self.layout = padded_layout_for_ranges(
                uniform_vocab_ranges(cfg.total_embedding_rows, self.n_ps))
        self.sparse_update = bool(sparse_update)
        self.table_hot: Optional[Any] = None     # measured cache plan rows
        self.vocab_ranges: Optional[Any] = None  # applied placement ranges
        self.remapper = replan.EmbeddingRemapper(cfg.table_rows,
                                                 cfg.bag_sizes)
        self.state: Optional[Dict[str, Any]] = None
        self.step_fn: Optional[Callable[..., Any]] = None
        self.global_step = 0
        self.generation = 0          # bumped on every recovery; stale
        self._lock = threading.RLock()  # attempts see it and abandon
        self._cancel: Optional[threading.Event] = None
        self.losses: Dict[int, float] = {}
        self.degrade_level = 0

    # ------------------------------------------------------------ lifecycle
    def _build_step(self) -> None:
        step = trainer_mod.make_dlrm_train_step(
            self.cfg, self.opt, plan=self.cfg.embedding_plan(
                table_hot=self.table_hot, layout=self.layout,
                sparse_update=self.sparse_update))
        if self.state is not None:
            # pay the first-use costs (kernel library, allocator, cuBLAS) NOW,
            # outside the watchdog deadline, on a throwaway step over a COPY
            # of the state: the fused step updates the pools in place, so a
            # warm-up on the live state would advance it by one step
            if self.device.type == "cuda":
                cuda_lib.load()
            with self._on_device():
                _, m = step(_clone(self.state),
                            self._raw_batch(self.global_step))
                float(m["loss"])
        fn = step
        if self.injector is not None:
            # trainer-layer fault seam: crash-class faults (PS loss, OOM)
            # and stalls fire where the step actually executes
            fn = trainer_mod.with_step_hooks(
                fn, before=lambda state, batch: self.injector.before_step(
                    self.global_step, self._cancel))
        self.step_fn = fn

    def start(self, resume: bool = True) -> int:
        """Fresh init — or resume from the newest valid checkpoint."""
        if resume and self.ckpt.latest_step() is not None:
            try:
                return self.restore()
            except FileNotFoundError as e:
                # every blob corrupt: fall through to fresh init, but leave a
                # trace in the checkpoint event log — a silent fresh start
                # after data loss is indistinguishable from a clean boot
                self.ckpt.note("restore_failed_fresh_start", error=str(e))
        with self._lock:             # a stale attempt may still be running
            gen = torch.Generator(device=self.device).manual_seed(
                self.init_seed)
            self.state = trainer_mod.make_dlrm_train_state(
                self.cfg, self.opt, gen, layout=self.layout)
            self.global_step = 0
            self._build_step()
            self.save()              # step-0 blob: recovery never lacks a base
        return 0

    def _on_device(self):
        """Make the job's device current in the calling thread (each
        thread has its own current CUDA device)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _raw_batch(self, gstep: int) -> Dict[str, torch.Tensor]:
        B = self.cfg.batch_size
        raw = criteo_batch(self.cfg, self.data_seed,
                           np.arange(gstep * B, (gstep + 1) * B))
        return to_device(self.remapper.remap_batch(raw), self.device)

    def batch_for(self, gstep: int) -> Dict[str, torch.Tensor]:
        """Deterministic batch of global step ``gstep`` (remapped, on device)."""
        if self.injector is not None:
            self.injector.on_batch(gstep)       # data-pipeline fault hook
        return self._raw_batch(gstep)

    def run_step(self, generation: Optional[int] = None,
                 cancel: Optional[threading.Event] = None) -> Dict[str, Any]:
        """Execute one training step; saves on the checkpoint cadence.

        ``generation`` (from the supervisor) guards against an abandoned
        watchdog attempt racing a recovery: a stale attempt raises
        ``AttemptAbandoned`` instead of touching state. ``cancel`` threads
        the watchdog's cancellation into injected stalls, so a hung attempt
        unwinds promptly (releasing the state lock) once detected.
        """
        with self._lock, self._on_device():
            if generation is not None and generation != self.generation:
                raise AttemptAbandoned(f"stale attempt gen={generation}")
            self._cancel = cancel
            gstep = self.global_step
            batch = self.batch_for(gstep)
            assert self.step_fn is not None, "run_step before start()"
            state, m = self.step_fn(self.state, batch)
            loss = float(m["loss"])             # forces host sync: real timing
            self.state = state
            self.global_step = gstep + 1
            self.losses[gstep] = loss
            if self.global_step % self.ckpt_every == 0:
                self.save()
            return {"loss": loss, "step": gstep}

    # ----------------------------------------------------------- checkpoints
    def save(self) -> None:
        replan.save_with_layout(self.ckpt, self.state, self.global_step,
                                self.remapper, self.table_hot,
                                self.vocab_ranges, layout=self.layout)

    def restore(self, *, onto_n_ps: Optional[int] = None) -> int:
        """Restore from the newest valid checkpoint (typed recovery action).

        ``onto_n_ps`` re-resumes a padded job onto that many *surviving* PS
        shards (elastic shrink after ``PSShardLoss``); None keeps the
        stamped layout. Returns the restored global step.
        """
        with self._lock:
            self.generation += 1
            self.ckpt.wait()                     # flush in-flight persists
            # new tensors: an abandoned attempt may have written the live pools
            (self.state, step, self.remapper, self.table_hot,
             self.vocab_ranges, self.layout) = elastic.resume_dlrm_stamped(
                self.cfg, self.opt, self.ckpt, device=self.device,
                onto_n_ps=onto_n_ps)
            if onto_n_ps is not None and self.layout is not None:
                self.n_ps = self.layout.n_ps
            self.global_step = step
            self._build_step()
            return step

    # ------------------------------------------------------------ degradation
    def degrade(self) -> str:
        """Graceful degradation ladder for repeated OOM (typed action).

        First occurrence drops the hot-row cache (frees the largest
        discretionary reservation); repeats halve the batch size (floor 8).
        The step is rebuilt; training resumes at the same global step —
        an injected OOM kills the attempt in the step's ``before`` hook,
        before the fused step updates anything in place.
        """
        with self._lock:
            self.generation += 1
            self.degrade_level += 1
            if self.degrade_level == 1 and (
                    self.table_hot is not None or self.cfg.hot_rows_k > 0):
                self.table_hot = None
                self.cfg = dataclasses.replace(self.cfg, hot_rows_k=0)
                action = "drop_hot_cache"
            else:
                new_b = max(self.cfg.batch_size // 2, 8)
                self.cfg = dataclasses.replace(self.cfg, batch_size=new_b)
                action = f"shrink_batch_to_{new_b}"
            self._build_step()
            return action


# ----------------------------------------------------------------- supervisor
@dataclass
class SupervisorConfig:
    """Detection thresholds and the recovery policy knobs."""
    step_deadline_s: Optional[float] = None   # watchdog; None disables
    straggler_factor: float = 3.0             # step_time > factor * EWMA
    ewma_alpha: float = 0.25
    ewma_warmup_steps: int = 5
    max_restarts: int = 5                     # capped restart budget
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    backoff_jitter: float = 0.25              # ± fraction of the delay
    seed: int = 0                             # jitter RNG (determinism)


@dataclass
class SupervisorEvent:
    """One structured entry of the fault → detect → recover log."""
    t: float
    kind: str                                 # fault_detected | recovered | ...
    step: int
    detail: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SupervisorReport:
    """Outcome + metrics of one supervised run."""
    completed: bool
    final_step: int
    final_loss: float
    restarts: int
    steps_lost: int
    step_attempts: int
    productive_steps: int
    wall_seconds: float
    recovery_latencies_s: List[float]
    events: List[SupervisorEvent]

    @property
    def goodput_fraction(self) -> float:
        """Fraction of executed step attempts that advanced training."""
        return self.productive_steps / max(self.step_attempts, 1)

    def measured_timings(self) -> MigrationTimings:
        """Feed measured recovery latencies back into the cluster simulator.

        Maps the supervisor's observed flash-restore latency onto
        ``MigrationTimings``, the recovery cost the failure model of
        ``repro_torch.sim.cluster.CloudSim`` prices.
        """
        load = (float(np.mean(self.recovery_latencies_s))
                if self.recovery_latencies_s else
                MigrationTimings.flash_ckpt_load_s)
        return MigrationTimings(flash_ckpt_load_s=max(load, 1e-3))


class Supervisor:
    """Watchdog + recovery driver around a ``DLRMJob``.

    Detection: a per-step deadline (hang), EWMA step-time outliers
    (straggler), and typed ``FaultError``s surfacing from the hooks
    (PS loss, OOM). Recovery: restore from the newest valid flash
    checkpoint with exponential backoff + jitter under a capped restart
    budget; PS loss additionally shrinks the padded layout onto the
    surviving shard count; repeated OOM walks the degradation ladder.
    """

    def __init__(self, job: DLRMJob, config: Optional[SupervisorConfig] = None,
                 *, injector: Optional[FaultInjector] = None):
        self.job = job
        self.cfg = config or SupervisorConfig()
        self.injector = injector if injector is not None else job.injector
        self.job.injector = self.injector
        self.events: List[SupervisorEvent] = []
        self.restarts = 0
        self._consecutive_failures = 0
        self._rng = np.random.default_rng(self.cfg.seed)
        self._ewma: Optional[float] = None
        self._ewma_n = 0
        self.recovery_latencies: List[float] = []
        self.steps_lost = 0
        self.step_attempts = 0
        self._pool = ThreadPoolExecutor(max_workers=1)

    # ------------------------------------------------------------------ log
    def _event(self, kind: str, step: int, **detail) -> SupervisorEvent:
        ev = SupervisorEvent(time.time(), kind, int(step), detail)
        self.events.append(ev)
        return ev

    def write_event_log(self, path: str,
                        report: Optional[SupervisorReport] = None) -> None:
        """Dump the structured event log as JSONL (one event per line); a
        final ``summary`` line carries the report's metrics."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(asdict(ev)) + "\n")
            if report is not None:
                f.write(json.dumps({
                    "kind": "summary", "completed": report.completed,
                    "final_step": report.final_step,
                    "final_loss": report.final_loss,
                    "restarts": report.restarts,
                    "steps_lost": report.steps_lost,
                    "goodput_fraction": report.goodput_fraction,
                    "recovery_latency_mean_s": float(np.mean(
                        report.recovery_latencies_s))
                    if report.recovery_latencies_s else 0.0,
                    "wall_seconds": report.wall_seconds}) + "\n")

    # ------------------------------------------------------------- attempts
    def _attempt(self, gstep: int, generation: int,
                 cancel: threading.Event) -> Dict[str, Any]:
        if cancel.is_set():
            raise AttemptAbandoned(f"step {gstep} cancelled")
        return self.job.run_step(generation, cancel)

    def _backoff(self) -> float:
        d = min(self.cfg.backoff_base_s * 2 ** max(
            self._consecutive_failures - 1, 0), self.cfg.backoff_cap_s)
        d *= 1.0 + self.cfg.backoff_jitter * float(self._rng.uniform(-1, 1))
        return max(d, 0.0)

    def _recover(self, cause: str, at_step: int, *,
                 onto_n_ps: Optional[int] = None,
                 degrade: bool = False) -> None:
        self.restarts += 1
        self._consecutive_failures += 1
        if self.restarts > self.cfg.max_restarts:
            self._event("restart_budget_exceeded", at_step, cause=cause,
                        restarts=self.restarts,
                        budget=self.cfg.max_restarts)
            raise RestartBudgetExceeded(
                f"{self.restarts - 1} restarts exhausted the budget of "
                f"{self.cfg.max_restarts} (last cause: {cause})")
        delay = self._backoff()
        time.sleep(delay)
        t0 = time.perf_counter()
        detail: Dict[str, Any] = {"cause": cause, "backoff_s": round(delay, 4)}
        if degrade:
            detail["action"] = self.job.degrade()
            restored = self.job.global_step     # state intact: retry in place
        else:
            restored = self.job.restore(onto_n_ps=onto_n_ps)
            detail["action"] = ("elastic_shrink" if onto_n_ps is not None
                                else "restore")
            if onto_n_ps is not None:
                detail["surviving_n_ps"] = onto_n_ps
        latency = time.perf_counter() - t0
        lost = max(at_step - restored, 0)
        self.steps_lost += lost
        self.recovery_latencies.append(latency)
        self._event("recovered", restored, recovery_latency_s=round(latency, 4),
                    steps_lost=lost, **detail)

    # ------------------------------------------------------------------ run
    def run(self, total_steps: int, *, resume: bool = True) -> SupervisorReport:
        """Supervise the job until ``total_steps`` global steps completed.

        Raises ``RestartBudgetExceeded`` when recovery stops making
        progress; any other exception propagates (the supervisor only
        swallows *typed* faults it knows how to heal).
        """
        t_start = time.perf_counter()
        start_step = self.job.start(resume=resume)
        if start_step:
            self._event("resumed", start_step)
        last_loss = float("nan")
        try:
            while self.job.global_step < total_steps:
                gstep = self.job.global_step
                generation = self.job.generation
                cancel = threading.Event()
                self.step_attempts += 1
                t0 = time.perf_counter()
                fut = self._pool.submit(self._attempt, gstep, generation,
                                        cancel)
                try:
                    m = fut.result(timeout=self.cfg.step_deadline_s)
                except FutureTimeout:
                    cancel.set()
                    self._event("fault_detected", gstep, fault="hang",
                                deadline_s=self.cfg.step_deadline_s)
                    # the abandoned attempt unwinds via AttemptAbandoned /
                    # the generation guard; a fresh worker serves recovery
                    self._pool.shutdown(wait=False)
                    self._pool = ThreadPoolExecutor(max_workers=1)
                    self._recover("hang", gstep)
                    continue
                except PSShardLoss as e:
                    self._event("fault_detected", gstep, fault="ps_loss",
                                n_lost=e.n_lost)
                    survivors = None
                    if self.job.layout is not None:
                        survivors = max(self.job.layout.n_ps - e.n_lost, 1)
                    self._recover("ps_loss", gstep, onto_n_ps=survivors)
                    continue
                except TransientOOM:
                    self._event("fault_detected", gstep, fault="oom")
                    self._recover("oom", gstep, degrade=True)
                    continue
                except AttemptAbandoned:
                    continue
                except FaultError as e:          # unknown typed fault: restore
                    self._event("fault_detected", gstep,
                                fault=type(e).__name__.lower())
                    self._recover(type(e).__name__, gstep)
                    continue
                dt = time.perf_counter() - t0
                self._consecutive_failures = 0
                last_loss = m["loss"]
                self._observe_step_time(gstep, dt)
        finally:
            self._pool.shutdown(wait=False)
        report = SupervisorReport(
            completed=True, final_step=self.job.global_step,
            final_loss=last_loss, restarts=self.restarts,
            steps_lost=self.steps_lost, step_attempts=self.step_attempts,
            productive_steps=self.job.global_step - start_step,
            wall_seconds=time.perf_counter() - t_start,
            recovery_latencies_s=list(self.recovery_latencies),
            events=list(self.events))
        return report

    def _observe_step_time(self, gstep: int, dt: float) -> None:
        """EWMA straggler detection over completed-step wall times."""
        if self._ewma is None:
            self._ewma = dt
        self._ewma_n += 1
        warm = self._ewma_n > self.cfg.ewma_warmup_steps
        if warm and dt > self.cfg.straggler_factor * self._ewma:
            self._event("straggler_detected", gstep,
                        step_time_s=round(dt, 4),
                        ewma_s=round(self._ewma, 4),
                        factor=round(dt / self._ewma, 2))
            # fold a clipped sample so one outlier can't poison the baseline
            dt = self.cfg.straggler_factor * self._ewma
        a = self.cfg.ewma_alpha
        self._ewma = a * dt + (1 - a) * self._ewma
