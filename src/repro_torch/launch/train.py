"""DLRM training launcher (port of ``train_dlrm`` of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch wide_deep \\
        --full --fused-update --padded-shards --steps 20 \\
        [--replan-every 10] [--ckpt-dir DIR --ckpt-every 5] [--resume] \\
        [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; with no GPU and no such
request it raises, and it never falls back to the CPU. Batches are
``criteo_batch(cfg, 11, ids)`` in the order of a single-worker
``ShardDataLoader``, remapped through the job's ``EmbeddingRemapper``.

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
sample 0, as in the reference. Chaos runs and the supervisor are not part
of this port yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.configs.dlrm_models import DLRMConfig, reduced_dlrm
from repro_torch.configs.registry import DLRMS, get_dlrm
from repro_torch.core.flash_checkpoint import FlashCheckpoint
from repro_torch.core.sharding_service import (HotTableTracker,
                                               ReplanDecision,
                                               ShardingService)
from repro_torch.data.pipeline import ShardDataLoader
from repro_torch.data.synthetic import criteo_batch
from repro_torch.sharding.policy import (EmbeddingPlan, PaddedLayout,
                                         padded_layout_for_ranges,
                                         uniform_vocab_ranges)
from repro_torch.train import optim, replan, trainer

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
    ap.add_argument("--arch", default="wide_deep", choices=sorted(DLRMS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None,
                    help="default: the config's batch")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adagrad",
                    choices=["adam", "adamw", "adagrad", "sgd"],
                    help="adagrad is the classic DLRM optimizer")
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
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
    return ap


def train_dlrm(args, *, state: Optional[Dict[str, Any]] = None) -> TrainRun:
    """DLRM training on ``args.device`` with the live re-planning loop.

    ``state`` replaces the fresh train state (seed 0) when nothing is
    restored; it must lie on the layout ``--padded-shards`` implies.
    Checkpoints are layout-stamped (``replan.save_with_layout``), so
    ``--resume`` in a fresh process continues on the stamped plan and
    layout however many re-plans came before.
    """
    device = resolve_device(args.device)
    cfg = get_dlrm(args.arch)
    if not args.full:
        cfg = reduced_dlrm(cfg)
    cfg = dataclasses.replace(cfg, zipf_alpha=args.zipf_alpha,
                              hot_rows_k=args.hot_rows,
                              batch_size=args.batch or cfg.batch_size)
    R = cfg.total_embedding_rows
    opt = optim.make(args.optimizer, args.lr)
    print(f"arch={cfg.name} kind={cfg.kind} params={cfg.param_count():,} "
          f"rows={R:,} zipf_alpha={cfg.zipf_alpha} "
          f"({'full' if args.full else 'reduced'}) device={device}")

    ckpt = FlashCheckpoint(args.ckpt_dir)
    remapper = replan.EmbeddingRemapper(cfg.table_rows)
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
    if args.fused_update and opt.update_rows is None:
        raise SystemExit(f"--fused-update: optimizer {args.optimizer!r} has no "
                         "row-update seam (use adagrad or adam)")
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
        min_lookups=4 * cfg.batch_size * cfg.n_tables * cfg.multi_hot,
        initial_ranges=vocab_ranges, initial_hot=table_hot)
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


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    return train_dlrm(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
