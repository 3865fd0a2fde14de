"""Training launcher (port of ``repro/launch/train.py``): any ``--arch``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 100 --batch 8 --seq 64 [--full] [--ckpt-dir DIR] [--resume] \\
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch wide_deep \\
        --full --fused-update --padded-shards --steps 20 \\
        [--replan-every 10] [--ckpt-dir DIR --ckpt-every 5] [--resume] \\
        [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; with no GPU and no such
request it raises, and it never falls back to the CPU.

An LM arch (any of ``configs.registry.ARCHS``) runs ``train_lm``, the
reference's LM mode: the reduced config unless ``--full``, adamw unless
``--optimizer`` says otherwise, the step of ``trainer.make_train_step``
with ``remat`` (donating the state, as a jitted step with donated buffers
would), over ``lm_batch(0, ids, --seq, vocab)`` in the order of a
single-worker ``ShardDataLoader``; an enc-dec arch gets zero f32 frames. It
checkpoints the reference's LM tree (``state_tree.lm_to_tree``) every
``--ckpt-every`` steps and at the end, keyed by the global step where the
reference keys by the process's own step count (a resumed run's blobs
would otherwise sort below the ones it resumed from); the final one is
skipped when that step is already saved (the reference writes it twice).
``--resume`` restores the newest one through ``elastic.resume_on_mesh``;
the sample stream restarts at sample 0, as in the reference. The
DLRM-only flags ``--chaos``, ``--supervise`` and ``--chaos-proc`` leave an
LM run unchanged, as the reference's do. The default ``--arch`` stays
``wide_deep``, which the port's DLRM callers rely on; the reference's is
``llama3.2-3b``.

A DLRM arch runs the modes below. Batches are ``criteo_batch(cfg, 11,
ids)`` in the order of a single-worker ``ShardDataLoader``, remapped
through the job's ``EmbeddingRemapper``.

The live re-planning loop is the reference's: a ``HotTableTracker`` folds
every remapped batch into decayed rolling counts, and every
``--replan-every`` steps the launcher asks it whether the placement drifted
past ``--imbalance-threshold``. On a decision it writes a layout-stamped
snapshot of the old state, permutes the pooled rows and their optimizer
moments, re-pads them onto the balanced (unequal) PS ranges
(``--padded-shards``), and rebuilds the step with the measured
``table_hot`` cache plan. It checkpoints every ``--ckpt-every`` steps
(keyed by the global step); ``--resume`` restores the newest stamped blob
and continues on its plan and layout, with the sample stream restarting at
sample 0, as in the reference.

Two more modes, as in the reference, run training under the self-healing
layer. ``--chaos SPEC`` (or ``--supervise``) runs ``train_dlrm_supervised``:
a ``DLRMJob`` under the ``Supervisor`` (step watchdog ``--step-deadline``,
EWMA straggler detection, capped restarts ``--max-restarts``), the scripted
faults fired through the trainer, data and checkpoint hooks, checkpoints
persisted synchronously every ``--ckpt-every`` steps. ``--chaos-proc SPEC``
runs ``train_dlrm_chaos_proc``: the reduced job in a real worker process
(``repro_torch.train.worker_main`` on ``--device``) under the
``JobMaster``, which re-execs it from the newest valid checkpoint when the
plan kills or stops it (``--heartbeat-deadline``, ``--workdir``). Both
print the reference's ``CHAOS`` / ``CHAOS-PROC`` line and write the event
log to ``--event-log``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch wide_deep \\
        --steps 40 --chaos ps_loss@10,hang@20 --step-deadline 5.0 \\
        --ckpt-every 5 --padded-shards [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch wide_deep \\
        --steps 8 --chaos-proc kill_loop@4x2 --ckpt-every 3 \\
        --padded-shards [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, reduce_config
from repro_torch.configs.dlrm_models import DLRMConfig, reduced_dlrm
from repro_torch.configs.registry import ARCHS, DLRMS, get_arch, get_dlrm
from repro_torch.core.flash_checkpoint import FlashCheckpoint
from repro_torch.core.sharding_service import (HotTableTracker,
                                               ReplanDecision,
                                               ShardingService)
from repro_torch.data.pipeline import ShardDataLoader
from repro_torch.data.synthetic import criteo_batch, lm_batch
from repro_torch.models.registry import build_model
from repro_torch.sharding.policy import (EmbeddingPlan, PaddedLayout,
                                         padded_layout_for_ranges,
                                         uniform_vocab_ranges)
from repro_torch.train import elastic, optim, replan, state_tree, trainer

DATA_SEED = 11


def resolve_device(device: str) -> torch.device:
    """The torch device of ``--device``; raises when CUDA is asked for and
    absent. On the card, float32 matmuls run in full float32: TF32 is
    switched off explicitly, so the dense network computes what the
    reference computes."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass --device cpu to run the plain versions on "
                "the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def data_loader(steps: int, batch_size: int,
                batch_fn: Callable[[np.ndarray], Any]
                ) -> Tuple[ShardingService, ShardDataLoader]:
    """The launcher's data path: one worker pulling contiguous shards of
    ``max(8 * batch_size, 64)`` samples from a dataset of ``steps *
    batch_size`` samples (a short tail wraps within its shard)."""
    svc = ShardingService(steps * batch_size,
                          shard_size=max(batch_size * 8, 64))
    return svc, ShardDataLoader(svc, "worker0", batch_fn,
                                batch_size=batch_size)


def sample_order(steps: int, batch_size: int) -> Iterator[np.ndarray]:
    """Absolute sample ids of each batch the launcher trains on."""
    return iter(data_loader(steps, batch_size, lambda idx: idx)[1])


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class TrainRun(NamedTuple):
    """What ``train_dlrm`` ran and where it ended: the final state on its
    ``layout`` under ``plan``, every applied re-plan decision, and the step
    the run resumed from (None for a fresh start)."""
    cfg: DLRMConfig
    opt: optim.Optimizer
    plan: EmbeddingPlan
    state: Dict[str, Any]
    losses: List[float]
    seconds: float
    layout: Optional[PaddedLayout]
    decisions: List[ReplanDecision]
    restored_step: Optional[int]
    exactly_once: bool


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="wide_deep",
                    choices=sorted(DLRMS) + sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 8 for LMs, the config's batch for DLRMs")
    ap.add_argument("--seq", type=int, default=64,
                    help="LM sequence length")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default=None,
                    choices=["adam", "adamw", "adagrad", "sgd"],
                    help="default: adamw for LMs, adagrad (the classic DLRM "
                         "optimizer) for DLRMs")
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--layers", type=int, default=None,
                    help="LM: cut the model to its first N layers (the "
                         "width stays the config's)")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--zipf-alpha", type=float, default=1.05,
                    help="power-law skew of the sparse-feature stream")
    ap.add_argument("--hot-rows", type=int, default=64,
                    help="hot-row cache budget in pooled rows")
    ap.add_argument("--n-ps", type=int, default=4,
                    help="PS shard count the padded layout targets")
    ap.add_argument("--padded-shards", action="store_true",
                    help="store the pooled rows as a padded "
                         "(n_ps, max_range, D) array")
    ap.add_argument("--fused-update", action="store_true",
                    help="fused sparse backward + row-wise optimizer update "
                         "on looked-up rows only (adagrad/adam)")
    ap.add_argument("--replan-every", type=int, default=0, metavar="N",
                    help="poll the hot tracker for a re-plan every N steps "
                         "(0 disables live re-planning)")
    ap.add_argument("--imbalance-threshold", type=float, default=1.2,
                    help="max/mean PS load that arms a re-plan")
    ap.add_argument("--ckpt-dir", default=None,
                    help="persist layout-stamped checkpoints here")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest valid checkpoint of --ckpt-dir")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    # --- chaos / self-healing ----------------------------------------------
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="scripted fault plan, e.g. 'ps_loss@10,hang@20:0.5' "
                         "(see repro_torch.core.faults); implies --supervise")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the corruption-byte RNG (determinism)")
    ap.add_argument("--supervise", action="store_true",
                    help="train under the recovery supervisor (watchdog + "
                         "restore-with-backoff) even without injected faults")
    ap.add_argument("--chaos-proc", default=None, metavar="SPEC",
                    help="process-level fault plan, e.g. 'kill@5' or "
                         "'kill_loop@3x2,stop@7': train in a real worker "
                         "process under the job master, which re-execs it "
                         "from the newest valid checkpoint")
    ap.add_argument("--workdir", default=None,
                    help="job-master working directory (heartbeats, loss "
                         "logs, worker logs); default: a fresh temp dir")
    ap.add_argument("--heartbeat-deadline", type=float, default=30.0,
                    help="job-master staleness deadline in seconds after a "
                         "worker's first 'ready' heartbeat")
    ap.add_argument("--step-deadline", type=float, default=None,
                    help="watchdog per-step deadline in seconds (None "
                         "disables)")
    ap.add_argument("--max-restarts", type=int, default=5,
                    help="capped restart (re-exec) budget")
    ap.add_argument("--event-log", default=None, metavar="PATH",
                    help="write the structured event log (JSONL) here")
    return ap


def dlrm_args(args) -> argparse.Namespace:
    """A copy of the flags with the DLRM default optimizer (adagrad) filled
    in where ``--optimizer`` was not given."""
    return argparse.Namespace(**{**vars(args),
                                 "optimizer": args.optimizer or "adagrad"})


def dlrm_config(args) -> DLRMConfig:
    """The DLRM config of the launcher's flags (``--arch``, ``--full``,
    ``--zipf-alpha``, ``--hot-rows``, ``--batch``); refuses
    ``--fused-update`` with an optimizer that has no row-update seam.
    ``args`` has its optimizer filled in (``dlrm_args``)."""
    cfg = get_dlrm(args.arch)
    if not args.full:
        cfg = reduced_dlrm(cfg)
    if args.fused_update and optim.make(args.optimizer,
                                        args.lr).update_rows is None:
        raise SystemExit(f"--fused-update: optimizer {args.optimizer!r} has no "
                         "row-update seam (use adagrad or adam)")
    return dataclasses.replace(cfg, zipf_alpha=args.zipf_alpha,
                               hot_rows_k=args.hot_rows,
                               batch_size=args.batch or cfg.batch_size)


def train_dlrm(args, *, state: Optional[Dict[str, Any]] = None) -> TrainRun:
    """DLRM training on ``args.device`` with the live re-planning loop.

    ``state`` replaces the fresh train state (seed 0) when nothing is
    restored; it must lie on the layout ``--padded-shards`` implies.
    Checkpoints are layout-stamped (``replan.save_with_layout``), so
    ``--resume`` in a fresh process continues on the stamped plan and
    layout however many re-plans came before.
    """
    args = dlrm_args(args)
    device = resolve_device(args.device)
    cfg = dlrm_config(args)
    R = cfg.total_embedding_rows
    opt = optim.make(args.optimizer, args.lr)
    print(f"arch={cfg.name} kind={cfg.kind} params={cfg.param_count():,} "
          f"rows={R:,} zipf_alpha={cfg.zipf_alpha} "
          f"({'full' if args.full else 'reduced'}) device={device}")

    ckpt = FlashCheckpoint(args.ckpt_dir)
    remapper = replan.EmbeddingRemapper(cfg.table_rows, cfg.bag_sizes)
    table_hot = None                             # None = cfg default plan
    vocab_ranges = None                          # None = uniform striping
    layout = None                                # None = flat pooled store
    restored_step = None
    if args.resume and ckpt.latest_step() is not None:
        state, restored_step, remapper, table_hot, vocab_ranges, layout = \
            replan.restore_with_layout(cfg, opt, ckpt, device=device)
        print(f"resumed from step {restored_step} (layout-stamped; cache "
              f"plan {'measured' if table_hot else 'default'}; "
              f"{'padded ' + str(layout.n_ps) + '-shard' if layout else 'flat'}"
              " pool)")
    if args.padded_shards and layout is None:
        # physical shards follow the applied plan, uniform until one exists
        layout = padded_layout_for_ranges(
            vocab_ranges if vocab_ranges is not None
            else uniform_vocab_ranges(R, args.n_ps))
        if restored_step is not None:            # a flat blob, padded now
            state = replan.pad_train_state(state, R, layout)
    if state is None:
        gen = torch.Generator(device=device).manual_seed(0)
        state = trainer.make_dlrm_train_state(cfg, opt, gen, layout=layout)
    if layout is not None:
        print(f"padded PS shards: n_ps={layout.n_ps} "
              f"max_range={layout.max_range} physical rows/shard="
              f"{list(layout.shard_sizes)} "
              f"(+{layout.padded_rows - R} pad rows)")
    plan = cfg.embedding_plan(table_hot=table_hot, layout=layout,
                              sparse_update=args.fused_update)
    if args.fused_update:
        print("fused sparse update: backward dedupe + row-wise "
              f"{args.optimizer} on looked-up rows only")
    step_fn = trainer.make_dlrm_train_step(
        cfg, opt, grad_compress=args.grad_compress, plan=plan)

    tracker = HotTableTracker(
        cfg.table_rows, n_ps=args.n_ps, hot_budget=cfg.hot_rows_k,
        trigger=args.imbalance_threshold,
        cooldown=max(args.replan_every, 1),
        min_lookups=4 * cfg.batch_size * cfg.lookups_per_sample,
        initial_ranges=vocab_ranges, initial_hot=table_hot,
        bag_sizes=cfg.bag_sizes)
    svc, loader = data_loader(args.steps, cfg.batch_size,
                              lambda idx: criteo_batch(cfg, DATA_SEED, idx))

    def snapshot():
        # keyed by the GLOBAL step, so a resumed run's blobs sort above the
        # ones it resumed from (n restarts at 0 in every process)
        replan.save_with_layout(ckpt, state, state["step"], remapper,
                                table_hot, vocab_ranges, layout=layout)

    losses, decisions = [], []
    t0 = time.perf_counter()
    n = 0
    for raw in loader:
        batch = remapper.remap_batch(raw)
        tracker.observe(batch["sparse"])         # worker-side heartbeat payload
        state, m = step_fn(state, to_device(batch, device))
        losses.append(m["loss"])
        n += 1
        replanned = False
        if n % 20 == 0 or n == 1:
            print(f"step {n:5d} loss={float(m['loss']):.4f} "
                  f"imbalance={tracker.imbalance():.3f} "
                  f"({n * cfg.batch_size / (time.perf_counter() - t0):.1f} "
                  "samples/s)")
        if args.replan_every and n % args.replan_every == 0:
            decision = tracker.maybe_replan()
            if decision is not None:
                # the old layout's stamped snapshot first, so a crash in the
                # middle of the re-plan loses nothing
                snapshot()
                res = replan.apply_replan(
                    state, cfg, opt, decision, remapper=remapper,
                    grad_compress=args.grad_compress, layout=layout,
                    plan=plan)
                tracker.mark_applied(decision)
                state, step_fn, layout, plan = (res.state, res.step_fn,
                                                res.layout, res.plan)
                table_hot = decision.table_hot
                vocab_ranges = decision.vocab_ranges
                decisions.append(decision)
                replanned = True
                print(f"step {n:5d} RE-PLAN: imbalance "
                      f"{decision.imbalance_before:.3f} -> "
                      f"{decision.imbalance_after:.3f}, "
                      f"cache rows {sum(decision.table_hot)}"
                      + (f", physical rows/shard {list(layout.shard_sizes)}"
                         if layout is not None else ""))
        if args.ckpt_dir and n % args.ckpt_every == 0 and not replanned:
            snapshot()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    values = [float(x) for x in losses]
    ok, covered, dup = svc.coverage(0)
    print(f"done: {n} steps in {seconds:.3f} s "
          f"({n / max(seconds, 1e-9):.2f} steps/s), exactly-once={ok} "
          f"(covered={covered} dup={dup}), {tracker.n_replans} re-plan(s), "
          f"final imbalance {tracker.imbalance():.3f}")
    if args.ckpt_dir:
        snapshot()
        ckpt.wait()
        print(f"checkpointed at step {n} -> {args.ckpt_dir}")
    return TrainRun(cfg, opt, plan, state, values, seconds, layout,
                    decisions, restored_step, ok)


class SupervisedRun(NamedTuple):
    """What ``train_dlrm_supervised`` ran: the job (its ``losses`` by global
    step, its checkpoint store and final layout) and the supervisor's
    report."""
    job: Any
    report: Any


def train_dlrm_supervised(args) -> SupervisedRun:
    """DLRM training under the self-healing supervisor (``--chaos`` /
    ``--supervise``), on ``args.device``.

    The scripted fault plan fires through the trainer/data/checkpoint hooks;
    the supervisor detects each abnormality (watchdog deadline, typed fault,
    EWMA outlier) and recovers from layout-stamped flash checkpoints,
    persisted synchronously so that every blob is restorable.
    """
    from repro_torch.core.faults import FaultInjector, parse_chaos_spec
    from repro_torch.train.supervisor import (DLRMJob, Supervisor,
                                              SupervisorConfig)

    args = dlrm_args(args)
    device = resolve_device(args.device)
    cfg = dlrm_config(args)
    plan = parse_chaos_spec(args.chaos or "")
    injector = FaultInjector(plan, seed=args.chaos_seed) if plan.specs else None
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="chaos_ckpt_")
    ckpt = FlashCheckpoint(
        ckpt_dir, async_persist=False,      # sync: every blob restorable
        fault_hook=injector.on_persist if injector else None)
    if injector is not None:
        injector.bind_checkpoint(ckpt)
    print(f"arch={cfg.name} kind={cfg.kind} params={cfg.param_count():,} "
          f"supervised (chaos plan: {plan if plan.specs else 'none'}; "
          f"ckpt -> {ckpt_dir}) device={device}")

    job = DLRMJob(cfg, ckpt, opt_name=args.optimizer, lr=args.lr,
                  ckpt_every=args.ckpt_every, n_ps=args.n_ps,
                  padded=args.padded_shards,
                  sparse_update=args.fused_update, injector=injector,
                  device=device)
    sup = Supervisor(job, SupervisorConfig(
        step_deadline_s=args.step_deadline, max_restarts=args.max_restarts,
        seed=args.chaos_seed))
    try:
        report = sup.run(args.steps, resume=args.resume)
    finally:
        if args.event_log:                  # log survives a failed run too
            sup.write_event_log(args.event_log)
    for ev in report.events:
        print(f"  event step={ev.step:5d} {ev.kind} {ev.detail}")
    lat = report.recovery_latencies_s
    mean_lat = sum(lat) / len(lat) if lat else 0.0
    print(f"CHAOS completed={report.completed} final_step={report.final_step} "
          f"final_loss={report.final_loss:.6f} restarts={report.restarts} "
          f"steps_lost={report.steps_lost} "
          f"goodput={report.goodput_fraction:.3f} "
          f"recovery_latency_mean_s={mean_lat:.4f}")
    if args.event_log:
        sup.write_event_log(args.event_log, report)
        print(f"event log -> {args.event_log}")
    return SupervisedRun(job, report)


class ChaosProcRun(NamedTuple):
    """What ``train_dlrm_chaos_proc`` ran: the worker's spec (its loss,
    fault and heartbeat files) and the job master's report."""
    spec: Any
    report: Any


def train_dlrm_chaos_proc(args) -> ChaosProcRun:
    """DLRM training in a real worker process under the job master
    (``--chaos-proc``).

    The worker (``repro_torch.train.worker_main`` on ``args.device``, the
    reduced config) is an OS process the plan SIGKILLs or SIGSTOPs; the
    master detects the death by exit code or stale heartbeat and re-execs a
    fresh incarnation that resumes from the newest valid layout-stamped
    checkpoint.
    """
    from repro_torch.train.job_master import (JobMaster, JobMasterConfig,
                                              WorkerSpec)

    args = dlrm_args(args)
    resolve_device(args.device)             # fail here, not in the worker
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_proc_")
    spec = WorkerSpec(
        name="worker0", workdir=workdir,
        ckpt_dir=args.ckpt_dir or os.path.join(workdir, "ckpt"),
        arch=args.arch, steps=args.steps, ckpt_every=args.ckpt_every,
        n_ps=args.n_ps, padded=args.padded_shards,
        chaos_proc=args.chaos_proc, opt_name=args.optimizer, lr=args.lr,
        device=args.device)
    master = JobMaster([spec], JobMasterConfig(
        heartbeat_deadline_s=args.heartbeat_deadline,
        max_reexecs=args.max_restarts, seed=args.chaos_seed))
    print(f"arch={args.arch} chaos-proc plan: {args.chaos_proc or 'none'} "
          f"(workdir -> {workdir}, ckpt -> {spec.ckpt_dir}) "
          f"device={args.device}")
    try:
        report = master.run()
    finally:
        if args.event_log:                  # log survives a failed run too
            master.write_event_log(args.event_log)
    for ev in report.events:
        print(f"  event {ev.kind} worker={ev.worker} {ev.detail}")
    t = report.measured_timings()
    losses = spec.read_losses()
    final_loss = losses[-1]["loss"] if losses else float("nan")
    print(f"CHAOS-PROC completed={report.completed} "
          f"final_steps={report.final_steps} reexecs={report.reexecs} "
          f"exit_history={report.exit_history} final_loss={final_loss:.6f} "
          f"reexec_mean_s={t.reexec_s():.3f} "
          f"restore_mean_s={t.flash_ckpt_load_s:.3f} "
          f"wall_s={report.wall_seconds:.1f}")
    if args.event_log:
        master.write_event_log(args.event_log, report)
        print(f"event log -> {args.event_log}")
    return ChaosProcRun(spec, report)


class LMRun(NamedTuple):
    """What ``train_lm`` ran: the config, model, optimizer and final state;
    per step the loss, the gradient norm and the seconds of the step
    (synchronised on the card); the step the run resumed from (None for a
    fresh start), the data path's exactly-once coverage, and the
    checkpoint's seconds (``restore``: the resume onto the device;
    ``memory_tier``: each snapshot's tree and memory tier; ``persist``: the
    last disk write)."""
    cfg: ModelConfig
    api: Any
    opt: optim.Optimizer
    state: Dict[str, Any]
    losses: List[float]
    grad_norms: List[float]
    step_seconds: List[float]
    seconds: float
    restored_step: Optional[int]
    exactly_once: bool
    covered: int
    dup: int
    ckpt_seconds: Dict[str, Any]


def train_lm(args, *, state: Optional[Dict[str, Any]] = None) -> LMRun:
    """LM training on ``args.device`` (the reference's LM mode).

    ``--chaos``, ``--supervise`` and ``--chaos-proc`` are DLRM modes: an LM
    trains as if they were absent, as in the reference, which dispatches
    them only for a DLRM arch. ``state`` replaces the fresh train state (seed 0) when nothing is
    restored; the run consumes it (the step donates its state)."""
    device = resolve_device(args.device)
    batch_size = args.batch or 8
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduce_config(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    api = build_model(cfg)
    opt_name = args.optimizer or "adamw"
    opt = optim.make(opt_name, args.lr)
    print(f"arch={cfg.name} family={cfg.family} params={cfg.param_count():,} "
          f"({'full' if args.full else 'reduced'}) device={device}")

    ckpt = FlashCheckpoint(args.ckpt_dir) if args.ckpt_dir else None
    restored_step = None
    ckpt_s: Dict[str, Any] = {"memory_tier": []}
    if args.resume and ckpt is not None and ckpt.latest_step() is not None:
        t0 = time.perf_counter()
        state, restored_step, _ = elastic.resume_on_mesh(
            api, opt, opt_name, ckpt, None, None, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ckpt_s["restore"] = time.perf_counter() - t0
        print(f"resumed from step {restored_step}")
    if state is None:
        state = trainer.make_train_state(
            api, opt, torch.Generator(device=device).manual_seed(0))
    step_fn = trainer.make_train_step(api, opt, remat=True,
                                      grad_compress=args.grad_compress,
                                      donate=True)
    svc, loader = data_loader(
        args.steps, batch_size,
        lambda idx: lm_batch(0, idx, args.seq, cfg.vocab_size))

    saved = [None]

    def snapshot():
        # keyed by the global step; a step already saved is not saved again
        if saved[0] == state["step"]:
            return
        t0 = time.perf_counter()
        ckpt.save(state_tree.lm_to_tree(state, cfg), state["step"])
        ckpt_s["memory_tier"].append(time.perf_counter() - t0)
        saved[0] = state["step"]

    losses, gnorms, step_s = [], [], []
    t0 = time.perf_counter()
    n = 0
    for raw in loader:
        batch = to_device(raw, device)
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros(
                (batch_size, cfg.n_frames, cfg.d_model), dtype=torch.float32,
                device=device)
        t_step = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t_step)
        n += 1
        if n % 20 == 0 or n == 1:
            print(f"step {n:5d} loss={losses[-1]:.4f} gnorm={gnorms[-1]:.3f} "
                  f"({n * batch_size / (time.perf_counter() - t0):.1f} "
                  "samples/s)")
        if ckpt is not None and n % args.ckpt_every == 0:
            snapshot()
    seconds = time.perf_counter() - t0
    ok, covered, dup = svc.coverage(0)
    print(f"done: {n} steps, exactly-once={ok} (covered={covered} dup={dup})")
    if ckpt is not None:
        snapshot()
        ckpt.wait()
        ckpt_s["persist"] = ckpt.last_persist_seconds
        print(f"checkpointed at step {state['step']} -> {args.ckpt_dir}")
    return LMRun(cfg, api, opt, state, losses, gnorms, step_s, seconds,
                 restored_step, ok, covered, dup, ckpt_s)


def main(argv: Optional[Sequence[str]] = None):
    """Dispatch on the flags as the reference does: an LM arch runs
    ``train_lm``; for a DLRM ``--chaos-proc`` runs
    ``train_dlrm_chaos_proc``, ``--chaos``/``--supervise``
    ``train_dlrm_supervised``, anything else ``train_dlrm``."""
    args = build_parser().parse_args(argv)
    if args.arch not in DLRMS:
        return train_lm(args)
    if args.chaos_proc is not None:
        return train_dlrm_chaos_proc(args)
    if args.chaos or args.supervise:
        return train_dlrm_supervised(args)
    return train_dlrm(args)


if __name__ == "__main__":
    main()
