"""End-to-end run of the PyTorch/CUDA port: a ~310M-parameter Wide&Deep
job trained through the full DLRover-RM lifecycle on one GPU — warm start,
profiling, auto-scaling decisions, a mid-training worker failure (shard
requeued), a straggler (smaller shards), flash checkpoints — under the
port's ``ClusterBrain``. The counterpart of ``elastic_dlrm_train.py``: the
same config, the same events at the same steps, the same printed lines.

    PYTHONPATH=src python examples/elastic_dlrm_train_torch.py \\
        [--steps 300] [--device cuda]

The profiler feed is the reference's synthetic one (iteration times drawn
from ``default_rng(step)``, memory ``4e9 + samples * 1e3`` bytes), so the
brain decides as the reference's brain does; the step time and peak memory
measured on the device are printed beside it and feed no decision. Every
train step runs K1 twice (the deep and the wide pool, dense path).
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.dlrm_models import DLRMConfig
from repro_torch.core.autoscaler import ClusterCapacity
from repro_torch.core.brain import ClusterBrain, JobMaster, Profiler
from repro_torch.core.flash_checkpoint import FlashCheckpoint
from repro_torch.core.perf_model import JobResources, JobStatics
from repro_torch.core.sharding_service import ShardingService
from repro_torch.core.warm_start import JobMeta
from repro_torch.data.pipeline import ShardDataLoader
from repro_torch.data.synthetic import criteo_batch
from repro_torch.launch.train import resolve_device, to_device
from repro_torch.models.dlrm import dlrm_auc
from repro_torch.train import optim, trainer

JOB_ID = "dlrm-100m"
FAILOVER_STEP = 60
STRAGGLER_STEP = 120
OPTIMIZE_STEP = 150
CKPT_EVERY = 50


def build_cfg() -> DLRMConfig:
    # the reference example's config: 26 tables of 240k-1.2M rows, D=16
    rows = tuple(int(2.4e5 * (1 + (i % 5))) for i in range(26))
    return DLRMConfig(name="wide_deep_100m", kind="wide_deep",
                      table_rows=rows, embed_dim=16,
                      mlp_dims=(256, 128, 64), batch_size=256)


@dataclasses.dataclass
class Lifecycle:
    """What one lifecycle run decided and measured."""
    brain: ClusterBrain
    master: JobMaster
    losses: List[float]
    step_seconds: List[float]        # each step, through its float(loss)
    stage1_plan: JobResources
    stage2_plans: Dict[str, JobResources]
    stage3_scaled: Dict[str, float]
    coverage: Tuple[bool, int, int]
    auc: float
    seconds: float                   # the training loop, wall clock
    throughput: float                # samples/s passed to brain.complete
    ckpt_save_s: float               # the last save's memory tier
    ckpt_persist_s: float            # the last save's disk tier
    peak_mem_bytes: Optional[int]    # torch.cuda.max_memory_allocated


def run_lifecycle(cfg: DLRMConfig, *, steps: int, device: str,
                  ckpt_dir: str, log: Callable[[str], None] = print
                  ) -> Lifecycle:
    """Train ``cfg`` for ``steps * batch`` samples (plus the samples a
    failover repeats) under the three stages of the port's brain."""
    dev = resolve_device(device)
    log(f"DLRM {cfg.name}: {cfg.param_count():,} params "
        f"({cfg.total_embedding_rows:,} embedding rows)")

    opt = optim.adagrad(0.05)
    t0 = time.time()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = trainer.make_dlrm_train_state(cfg, opt, gen)
    plan = cfg.embedding_plan()
    step_fn = trainer.make_dlrm_train_step(cfg, opt, plan=plan)
    log(f"init in {time.time()-t0:.1f}s")

    # --- cluster brain admission (stage 1: warm start) -----------------------
    brain = ClusterBrain(ClusterCapacity(2048, 16384))
    statics = JobStatics(batch_size=cfg.batch_size,
                         model_size=cfg.param_count() * 4.0,
                         bandwidth=1e9, emb_dim=cfg.embed_dim)
    total_samples = steps * cfg.batch_size
    meta = JobMeta(cfg.kind, dense_params=1e6,
                   emb_rows=cfg.total_embedding_rows, emb_dim=cfg.embed_dim,
                   batch_size=cfg.batch_size, dataset_samples=total_samples)
    master = JobMaster(
        job_id=JOB_ID, meta=meta, statics=statics,
        resources=JobResources(w=2, p=1, cpu_w=4, cpu_p=4),
        total_samples=total_samples,
        sharding=ShardingService(total_samples, shard_size=cfg.batch_size * 8,
                                 min_shard=cfg.batch_size),
        profiler=Profiler(statics=statics))
    stage1 = brain.admit(master)
    log(f"stage-1 warm start plan: {stage1}")

    ckpt = FlashCheckpoint(ckpt_dir)
    svc = master.sharding
    clock = [0.0]

    def tick():
        clock[0] += 1.0
        return clock[0]

    def batch_fn(idx):
        return criteo_batch(cfg, seed=11, indices=idx)

    loader = ShardDataLoader(svc, "workerA", batch_fn, cfg.batch_size,
                             clock=tick)
    losses: List[float] = []
    step_seconds: List[float] = []
    stage2: Dict[str, JobResources] = {}
    stage3: Dict[str, float] = {}
    failed_over = False
    straggled = False
    t_train = time.time()
    while True:
        b = loader.next_batch()
        if b is None:
            break
        t_step = time.perf_counter()
        state, m = step_fn(state, to_device(b, dev))
        losses.append(float(m["loss"]))
        step_seconds.append(time.perf_counter() - t_step)
        n = len(losses)
        # profile for stage 2
        master.profiler.record_iteration(
            master.resources, float(np.random.default_rng(n).lognormal(-2, .05)))
        master.samples_done = n * cfg.batch_size
        master.profiler.record_memory(master.samples_done,
                                      4e9 + master.samples_done * 1e3)
        if n % CKPT_EVERY == 0:
            log(f"step {n:4d} loss={losses[-1]:.4f}")
            ckpt.save(state, n)
        if n == FAILOVER_STEP and not failed_over:
            # --- stage 3: worker failure -> shard requeued, new worker -----
            failed_over = True
            svc.report_failure("workerA", tick())
            loader = ShardDataLoader(svc, "workerB", batch_fn,
                                     cfg.batch_size, clock=tick)
            log("workerA failed: shard requeued, workerB resumed "
                "(no data loss)")
        if n == STRAGGLER_STEP and not straggled:
            straggled = True
            svc._view("workerB", tick()).is_straggler = True
            log("workerB flagged straggler: now receives split shards")
        if n == OPTIMIZE_STEP:
            stage2 = brain.optimize()
            log(f"stage-2 auto-scale plan: {stage2.get(JOB_ID)}")
            stage3 = brain.check_oom()
            if stage3:
                log(f"stage-3 OOM prevention resized PS memory: {stage3}")

    dt = time.time() - t_train
    coverage = svc.coverage(0)
    ev = criteo_batch(cfg, seed=12, indices=np.arange(512))
    with torch.no_grad():
        auc = float(dlrm_auc(state["params"], to_device(ev, dev), cfg, plan))
    throughput = len(losses) * cfg.batch_size / dt
    ok, covered, dup = coverage
    log(f"\ntrained {len(losses)} steps in {dt:.1f}s "
        f"({throughput:.0f} samples/s)")
    log(f"loss {losses[0]:.4f} -> {np.mean(losses[-10:]):.4f}  AUC={auc:.4f}")
    log(f"exactly-once coverage: exact={ok} covered={covered} dup={dup}")
    ckpt.wait()
    log(f"final flash-ckpt: mem {ckpt.last_save_seconds*1e3:.1f} ms / "
        f"disk {ckpt.last_persist_seconds*1e3:.1f} ms (async)")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    log(f"measured on {dev}: median step "
        f"{float(np.median(step_seconds))*1e3:.2f} ms (host data excluded), "
        "peak memory " + (f"{peak/2**30:.2f} GiB" if peak is not None
                          else "not measured (cpu)") +
        "; neither feeds the brain")
    brain.complete(JOB_ID, throughput=throughput)
    log("job recorded to config DB for future warm starts")
    return Lifecycle(
        brain=brain, master=master, losses=losses, step_seconds=step_seconds,
        stage1_plan=stage1, stage2_plans=stage2, stage3_scaled=stage3,
        coverage=coverage, auc=auc, seconds=dt, throughput=throughput,
        ckpt_save_s=ckpt.last_save_seconds,
        ckpt_persist_s=ckpt.last_persist_seconds, peak_mem_bytes=peak)


def main(argv: Optional[Sequence[str]] = None) -> Lifecycle:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="flashckpt_") as d:
        return run_lifecycle(build_cfg(), steps=args.steps,
                             device=args.device, ckpt_dir=d)


if __name__ == "__main__":
    main()
