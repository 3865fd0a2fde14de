"""DLRM training launcher (port of ``train_dlrm`` of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch wide_deep \\
        --full --fused-update --steps 20 [--padded-shards] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; with no GPU and no such
request it raises, and it never falls back to the CPU. Batches are
``criteo_batch(cfg, 11, ids)`` in the sample order of the reference
launcher's single-worker ``ShardDataLoader`` (``sample_order``). Live
re-planning, checkpoints and chaos runs are not part of this port yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.dlrm_models import DLRMConfig, reduced_dlrm
from repro_torch.configs.registry import DLRMS, get_dlrm
from repro_torch.data.synthetic import criteo_batch
from repro_torch.sharding.policy import (EmbeddingPlan,
                                         padded_layout_for_ranges,
                                         uniform_vocab_ranges)
from repro_torch.train import optim, trainer

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


def sample_order(steps: int, batch_size: int) -> Iterator[np.ndarray]:
    """Absolute sample ids of each batch, in the reference launcher's order.

    One worker pulls contiguous shards of ``max(8 * batch_size, 64)``
    samples from a dataset of ``steps * batch_size`` samples and cuts each
    shard into batches; a short tail wraps within its shard.
    """
    total = steps * batch_size
    shard_size = max(batch_size * 8, 64)
    for start in range(0, total, shard_size):
        end = min(start + shard_size, total)
        size = end - start
        for lo in range(start, end, batch_size):
            hi = min(lo + batch_size, end)
            idx = np.arange(lo, hi)
            if len(idx) < batch_size:                  # pad by wrapping
                extra = np.arange(start, start + batch_size - len(idx))
                idx = np.concatenate([idx, extra % max(size, 1) + start])
            yield idx


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class TrainRun(NamedTuple):
    """What ``train_dlrm`` ran and where it ended."""
    cfg: DLRMConfig
    opt: optim.Optimizer
    plan: EmbeddingPlan
    state: Dict[str, Any]
    losses: List[float]
    seconds: float


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
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    return ap


def train_dlrm(args, *, state: Optional[Dict[str, Any]] = None) -> TrainRun:
    """DLRM training on ``args.device``; ``state`` continues from a given
    train state instead of a fresh one (seed 0)."""
    device = resolve_device(args.device)
    cfg = get_dlrm(args.arch)
    if not args.full:
        cfg = reduced_dlrm(cfg)
    cfg = dataclasses.replace(cfg, zipf_alpha=args.zipf_alpha,
                              hot_rows_k=args.hot_rows,
                              batch_size=args.batch or cfg.batch_size)
    opt = optim.make(args.optimizer, args.lr)
    print(f"arch={cfg.name} kind={cfg.kind} params={cfg.param_count():,} "
          f"rows={cfg.total_embedding_rows:,} zipf_alpha={cfg.zipf_alpha} "
          f"({'full' if args.full else 'reduced'}) device={device}")
    layout = None
    if args.padded_shards:
        layout = padded_layout_for_ranges(
            uniform_vocab_ranges(cfg.total_embedding_rows, args.n_ps))
        print(f"padded PS shards: n_ps={layout.n_ps} "
              f"max_range={layout.max_range} physical rows/shard="
              f"{list(layout.shard_sizes)} "
              f"(+{layout.padded_rows - cfg.total_embedding_rows} pad rows)")
    if args.fused_update and opt.update_rows is None:
        raise SystemExit(f"--fused-update: optimizer {args.optimizer!r} has no "
                         "row-update seam (use adagrad or adam)")
    if state is None:
        gen = torch.Generator(device=device).manual_seed(0)
        state = trainer.make_dlrm_train_state(cfg, opt, gen, layout=layout)
    plan = cfg.embedding_plan(layout=layout, sparse_update=args.fused_update)
    if args.fused_update:
        print("fused sparse update: backward dedupe + row-wise "
              f"{args.optimizer} on looked-up rows only")
    step_fn = trainer.make_dlrm_train_step(
        cfg, opt, grad_compress=args.grad_compress, plan=plan)

    losses = []
    t0 = time.perf_counter()
    for n, ids in enumerate(sample_order(args.steps, cfg.batch_size), 1):
        batch = to_device(criteo_batch(cfg, DATA_SEED, ids), device)
        state, m = step_fn(state, batch)
        losses.append(m["loss"])
        if n % 20 == 0 or n == 1:
            print(f"step {n:5d} loss={float(m['loss']):.4f} "
                  f"({n * cfg.batch_size / (time.perf_counter() - t0):.1f} "
                  "samples/s)")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    values = [float(x) for x in losses]
    print(f"done: {len(values)} steps in {seconds:.3f} s "
          f"({len(values) / max(seconds, 1e-9):.2f} steps/s)")
    return TrainRun(cfg, opt, plan, state, values, seconds)


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    return train_dlrm(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
