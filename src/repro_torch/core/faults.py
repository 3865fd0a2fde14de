"""Deterministic fault injection (paper §2.2/§5): scripted cloud abnormalities.

Copy of ``repro/core/faults.py`` (numpy only): the same spec grammar, the
same defaults and the same seeded byte flips, so a plan string and a
corruption seed damage the same bytes in either package.

AntGroup's clusters lose ~1.5 %/pod/day to failures, plus stragglers, hangs
and OOMs; DLRover-RM's reliability win comes from *detecting* these and
recovering via flash checkpoints and elastic re-scaling. This module makes
those abnormalities reproducible on the **real** training path: a
``FaultPlan`` scripts what goes wrong at which global step, and a
``FaultInjector`` fires the plan through three hook points —

* the trainer loop (``before_step``): PS-shard loss, step hang (a
  watchdog-visible stall), transient OOM;
* the data pipeline (``on_batch`` / ``ShardDataLoader(fault_hook=...)``):
  per-step straggler delays;
* the checkpoint layer (``on_persist`` / ``FlashCheckpoint(fault_hook=...)``):
  blob corruption / truncation of just-persisted checkpoints.

Plans are fully scripted (no hidden randomness at fire time); the only RNG —
seeded, explicit — picks which bytes a corruption flips, so every chaos run
is replayable. ``repro_torch.train.supervisor`` is the recovery side of the loop.

Spec grammar (the launcher's ``--chaos`` / ``--chaos-proc`` flags)::

    spec     := fault ("," fault)*
    fault    := kind "@" step ["x" count] [":" param]
    kind     := ps_loss | hang | straggler | oom | ckpt_corrupt | ckpt_truncate
              | kill | stop | kill_ckpt | kill_loop

Examples: ``ps_loss@10`` (lose one PS shard at step 10), ``hang@20:0.5``
(stall 0.5 s at step 20), ``straggler@30x5:0.05`` (50 ms extra per step for
steps 30..34), ``ckpt_corrupt@40`` (corrupt the first blob persisted at
step ≥ 40 and drop the memory tier — only older disk blobs survive).

The second block of kinds is **process-level** (the ``--chaos-proc`` mode):
they are fired *inside a real worker process* by ``ProcessFaultInjector``
and model pod-eviction-class failures the in-process injector cannot —
``kill@10`` SIGKILLs the worker right before it executes global step 10,
``stop@10`` SIGSTOPs it (a wedged process: only the job master's heartbeat
deadline can see it), ``kill_ckpt@10`` SIGKILLs in the checkpoint layer's
pre-commit window (mid-write: the staging dir is complete but the atomic
rename never happened), and ``kill_loop@10x3`` SIGKILLs the first three
incarnations at step 10 (a crash loop bounded only by the job master's
capped re-exec budget). ``repro_torch.train.job_master`` is the recovery side.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

KINDS = ("ps_loss", "hang", "straggler", "oom", "ckpt_corrupt", "ckpt_truncate",
         "kill", "stop", "kill_ckpt", "kill_loop")

#: kinds fired at process level by ``ProcessFaultInjector`` (the worker kills
#: itself) rather than through the in-process trainer/data/checkpoint hooks
PROC_KINDS = ("kill", "stop", "kill_ckpt", "kill_loop")

# default param per kind: ps_loss = shards lost, hang = stall seconds,
# straggler = extra seconds per step, others unused
_DEFAULT_PARAM = {"ps_loss": 1.0, "hang": 30.0, "straggler": 0.05,
                  "oom": 0.0, "ckpt_corrupt": 0.0, "ckpt_truncate": 0.0,
                  "kill": 0.0, "stop": 0.0, "kill_ckpt": 0.0, "kill_loop": 0.0}


# --------------------------------------------------------------------- errors
class FaultError(RuntimeError):
    """Base class of every injected abnormality."""


class PSShardLoss(FaultError):
    """A parameter-server shard vanished (pod eviction / hardware loss)."""

    def __init__(self, n_lost: int = 1):
        super().__init__(f"lost {n_lost} PS shard(s)")
        self.n_lost = int(n_lost)


class TransientOOM(FaultError):
    """A worker was OOM-killed; the step never ran (state is intact)."""


class AttemptAbandoned(RuntimeError):
    """A watchdog cancelled this step attempt; discard it silently."""


# ----------------------------------------------------------------------- plan
@dataclass(frozen=True)
class FaultSpec:
    """One scripted abnormality: ``kind`` fires at global steps
    ``[step, step + count)`` with a kind-specific ``param``."""
    kind: str
    step: int
    count: int = 1
    param: float = float("nan")

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if self.step < 0 or self.count < 1:
            raise ValueError(f"bad fault window: step={self.step} "
                             f"count={self.count}")
        if np.isnan(self.param):
            object.__setattr__(self, "param", _DEFAULT_PARAM[self.kind])


@dataclass(frozen=True)
class FaultPlan:
    """An ordered, immutable script of abnormalities for one run."""
    specs: Tuple[FaultSpec, ...] = ()

    def at_step(self, step: int) -> List[FaultSpec]:
        return [s for s in self.specs if s.step <= step < s.step + s.count]

    def __str__(self) -> str:
        parts = []
        for s in self.specs:
            p = f"{s.kind}@{s.step}"
            if s.count != 1:
                p += f"x{s.count}"
            if s.param != _DEFAULT_PARAM[s.kind]:
                p += f":{s.param:g}"
            parts.append(p)
        return ",".join(parts)


def parse_chaos_spec(spec: str) -> FaultPlan:
    """Parse a ``--chaos`` spec string into a ``FaultPlan``.

    >>> plan = parse_chaos_spec("ps_loss@10,hang@20:0.5,straggler@30x5:0.05")
    >>> [s.kind for s in plan.specs]
    ['ps_loss', 'hang', 'straggler']
    >>> plan.at_step(32)[0].param
    0.05
    >>> parse_chaos_spec("")
    FaultPlan(specs=())
    """
    specs = []
    for part in (p.strip() for p in spec.split(",") if p.strip()):
        if "@" not in part:
            raise ValueError(f"bad fault spec {part!r}: expected kind@step"
                             f"[xcount][:param]")
        kind, rest = part.split("@", 1)
        param = float("nan")
        if ":" in rest:
            rest, p = rest.split(":", 1)
            param = float(p)
        count = 1
        if "x" in rest:
            rest, c = rest.split("x", 1)
            count = int(c)
        specs.append(FaultSpec(kind.strip(), int(rest), count, param))
    return FaultPlan(tuple(sorted(specs, key=lambda s: (s.step, s.kind))))


def random_plan(n_faults: int, horizon_steps: int, *, seed: int = 0,
                kinds: Tuple[str, ...] = ("ps_loss", "hang", "straggler",
                                          "oom")) -> FaultPlan:
    """A seeded random-but-reproducible plan (for chaos benchmarks).

    >>> str(random_plan(2, 100, seed=7)) == str(random_plan(2, 100, seed=7))
    True
    """
    rng = np.random.default_rng(seed)
    specs = []
    steps = sorted(rng.choice(np.arange(1, max(horizon_steps, 2)),
                              size=min(n_faults, horizon_steps - 1),
                              replace=False).tolist())
    for step in steps:
        specs.append(FaultSpec(str(rng.choice(kinds)), int(step)))
    return FaultPlan(tuple(specs))


# -------------------------------------------------------------- blob sabotage
def corrupt_blob(path: str, *, mode: str = "flip", seed: int = 0) -> str:
    """Deterministically damage a persisted checkpoint (dir or legacy file).

    ``mode="flip"`` flips 64 bytes in the middle of the data file (a bad
    DMA / bit-rot analog); ``mode="truncate"`` cuts the file in half (a
    mid-write kill analog). Returns a description of what was damaged.
    """
    target = path
    if os.path.isdir(path):
        data = os.path.join(path, "leaves.npz")
        target = data if os.path.exists(data) else os.path.join(
            path, "MANIFEST.json")
    size = os.path.getsize(target)
    if mode == "truncate":
        with open(target, "r+b") as f:
            f.truncate(size // 2)
        return f"truncated {target} {size} -> {size // 2} bytes"
    rng = np.random.default_rng(seed)
    n = min(64, max(size // 2, 1))
    off = size // 3
    with open(target, "r+b") as f:
        f.seek(off)
        junk = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        f.write(junk)
    return f"flipped {n} bytes at offset {off} of {target}"


# ------------------------------------------------------------------- injector
class FaultInjector:
    """Fires a ``FaultPlan`` through the trainer/data/checkpoint hooks.

    Each spec fires **once per step in its window** and is then spent —
    recovery replaying the same global step does not re-trigger it (the
    cloud's pod is already gone; re-killing it on every retry would make
    recovery untestable). ``fired`` and ``log`` record exactly what was
    injected and when, for the chaos event log.
    """

    def __init__(self, plan: FaultPlan, *, seed: int = 0):
        self.plan = plan
        self.seed = int(seed)
        self._spent: set = set()          # (spec, step) pairs already fired
        self._lock = threading.Lock()
        self.fired: List[Tuple[int, str]] = []
        self.log: List[Dict] = []
        self._ckpt = None                 # bound FlashCheckpoint (optional)

    def bind_checkpoint(self, ckpt) -> None:
        """Give checkpoint-layer faults access to the store's memory tier."""
        self._ckpt = ckpt

    def _take(self, step: int, kinds: Tuple[str, ...]) -> List[FaultSpec]:
        """Unspent specs of the given kinds active at ``step`` (marks spent)."""
        out = []
        with self._lock:
            for spec in self.plan.at_step(step):
                if spec.kind in kinds and (spec, step) not in self._spent:
                    self._spent.add((spec, step))
                    self.fired.append((step, spec.kind))
                    out.append(spec)
        return out

    def _note(self, step: int, spec: FaultSpec, detail: str) -> None:
        self.log.append({"t": time.time(), "kind": "fault_injected",
                         "fault": spec.kind, "step": int(step),
                         "detail": detail})

    # ------------------------------------------------------------- trainer hook
    def before_step(self, step: int,
                    cancel: Optional[threading.Event] = None) -> None:
        """Trainer-loop hook; call right before executing global ``step``.

        Raises ``PSShardLoss``/``TransientOOM`` for crash-class faults;
        sleeps for hang-class faults (interruptibly: a watchdog that sets
        ``cancel`` turns the stall into ``AttemptAbandoned`` so the hung
        attempt unwinds without touching state).
        """
        for spec in self._take(step, ("hang",)):
            self._note(step, spec, f"stall {spec.param:g}s")
            deadline = time.monotonic() + float(spec.param)
            while time.monotonic() < deadline:
                if cancel is not None:
                    if cancel.wait(0.01):
                        raise AttemptAbandoned(
                            f"hang at step {step} cancelled")
                else:
                    time.sleep(max(min(0.01, deadline - time.monotonic()),
                                   0.0))
        if cancel is not None and cancel.is_set():
            raise AttemptAbandoned(f"step {step} cancelled")
        for spec in self._take(step, ("ps_loss",)):
            self._note(step, spec, f"lost {int(spec.param)} shard(s)")
            raise PSShardLoss(int(spec.param))
        for spec in self._take(step, ("oom",)):
            self._note(step, spec, "worker OOM-killed")
            raise TransientOOM(f"injected OOM at step {step}")

    # ------------------------------------------------------- data-pipeline hook
    def on_batch(self, step: int) -> None:
        """Data-pipeline hook; injects straggler delay while building a batch."""
        for spec in self._take(step, ("straggler",)):
            self._note(step, spec, f"straggler +{spec.param:g}s")
            time.sleep(float(spec.param))

    # ----------------------------------------------------- checkpoint-layer hook
    def on_persist(self, path: str, step: int) -> None:
        """Checkpoint-layer hook (``FlashCheckpoint(fault_hook=...)``).

        A pending ``ckpt_corrupt``/``ckpt_truncate`` spec damages the first
        blob persisted at a step ≥ its trigger, and drops the store's memory
        tier — modelling the paper's node-loss scenario where only (possibly
        damaged) remote-storage copies survive.
        """
        for spec in self._take_persist(step):
            mode = "truncate" if spec.kind == "ckpt_truncate" else "flip"
            detail = corrupt_blob(path, mode=mode, seed=self.seed)
            if self._ckpt is not None:
                self._ckpt.drop_memory_tier()
                detail += " + dropped memory tier"
            self._note(step, spec, detail)

    def _take_persist(self, step: int) -> List[FaultSpec]:
        """Corruption specs trigger on the first persist at/after their step."""
        out = []
        with self._lock:
            for spec in self.plan.specs:
                if spec.kind in ("ckpt_corrupt", "ckpt_truncate") and \
                        spec.step <= step and spec not in self._spent:
                    self._spent.add(spec)
                    self.fired.append((step, spec.kind))
                    out.append(spec)
        return out


# --------------------------------------------------------- process-level chaos
class ProcessFaultInjector:
    """Fires the ``PROC_KINDS`` of a plan *inside a real worker process*.

    Unlike ``FaultInjector`` (scripted exceptions inside one interpreter),
    these faults end the process: ``kill``/``kill_loop``/``kill_ckpt`` raise
    SIGKILL against the worker's own pid, ``stop`` raises SIGSTOP (the
    process freezes mid-run; only the job master's heartbeat deadline can
    detect it and SIGKILL the husk). Recovery is therefore exercised for
    real — a fresh interpreter must re-exec, restore the newest valid
    layout-stamped checkpoint, and replay.

    Determinism across re-execs comes from **incarnation gating** rather
    than the in-process injector's spent-set (which dies with the process):
    the job master passes each worker its incarnation number (0 for the
    first exec, +1 per re-exec), and

    * ``kill`` / ``stop`` / ``kill_ckpt`` fire only in incarnation 0 — the
      cloud's pod is already gone; the replacement replaying the same
      global step must not re-die;
    * ``kill_loop`` fires in every incarnation ``< count`` — a scripted
      crash loop whose only exit is the master's capped re-exec budget
      (or outliving ``count``).

    ``signal_fn`` is a test seam (defaults to ``os.kill`` on own pid).
    """

    def __init__(self, plan: FaultPlan, *, incarnation: int = 0,
                 signal_fn: Optional[Callable[[int], None]] = None,
                 log_path: Optional[str] = None):
        self.plan = plan
        self.incarnation = int(incarnation)
        self._signal = signal_fn if signal_fn is not None else (
            lambda signum: os.kill(os.getpid(), signum))
        self.log_path = log_path

    @staticmethod
    def fires(spec: FaultSpec, step: int, incarnation: int) -> bool:
        """Pure gating predicate: does ``spec`` fire here? (doctested)

        >>> from repro_torch.core.faults import FaultSpec, ProcessFaultInjector
        >>> f = ProcessFaultInjector.fires
        >>> f(FaultSpec("kill", 5), 5, 0)          # first exec dies at step 5
        True
        >>> f(FaultSpec("kill", 5), 5, 1)          # the re-exec replays it
        False
        >>> f(FaultSpec("kill_loop", 5, count=3), 5, 2)   # crash loop: 0,1,2
        True
        >>> f(FaultSpec("kill_loop", 5, count=3), 5, 3)   # incarnation 3 lives
        False
        >>> f(FaultSpec("kill_ckpt", 4), 6, 0)     # first persist at step >= 4
        True
        >>> f(FaultSpec("ps_loss", 5), 5, 0)       # in-process kind: not ours
        False
        """
        if spec.kind in ("kill", "stop", "kill_ckpt"):
            if incarnation != 0:
                return False
        elif spec.kind == "kill_loop":
            if incarnation >= spec.count:
                return False
        else:
            return False
        if spec.kind == "kill_ckpt":
            return step >= spec.step
        return step == spec.step

    def _log(self, spec: FaultSpec, step: int, detail: str) -> None:
        """Append a pre-death marker (O_APPEND: survives the SIGKILL)."""
        if self.log_path is None:
            return
        import json
        with open(self.log_path, "a") as f:
            f.write(json.dumps({
                "t": time.time(), "kind": "proc_fault_fired",
                "fault": spec.kind, "step": int(step),
                "incarnation": self.incarnation, "detail": detail}) + "\n")
            f.flush()
            os.fsync(f.fileno())

    # ------------------------------------------------------------ worker hooks
    def before_step(self, step: int) -> None:
        """Worker-loop hook; call right before executing global ``step``.

        May not return: ``kill``/``kill_loop`` specs SIGKILL the process,
        ``stop`` specs SIGSTOP it (execution resumes here only if an
        external SIGCONT arrives — the job master never sends one; it
        SIGKILLs the husk on heartbeat expiry and re-execs).
        """
        for spec in self.plan.specs:
            if spec.kind in ("kill", "kill_loop") and \
                    self.fires(spec, step, self.incarnation):
                self._log(spec, step, "SIGKILL self before step")
                self._signal(signal.SIGKILL)
            elif spec.kind == "stop" and \
                    self.fires(spec, step, self.incarnation):
                self._log(spec, step, "SIGSTOP self before step")
                self._signal(signal.SIGSTOP)

    def on_pre_commit(self, path: str, step: int) -> None:
        """Checkpoint-layer hook (``FlashCheckpoint(pre_commit_hook=...)``).

        Fires in the mid-write window: the staging directory under ``path``
        is fully written (data + manifest, checksums valid) but the atomic
        rename has not happened. A SIGKILL here is the worst torn-save case
        — ``valid_steps`` must never count the leftover.
        """
        for spec in self.plan.specs:
            if spec.kind == "kill_ckpt" and \
                    self.fires(spec, step, self.incarnation):
                self._log(spec, step, f"SIGKILL self mid-save of {path}")
                self._signal(signal.SIGKILL)
