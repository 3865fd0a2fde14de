"""Worker-process entrypoint spawned (and re-exec'd) by the job master.

Port of ``repro/train/worker_main.py``. It trains on ``--device`` (``cuda``
unless ``cpu`` is asked for; without CUDA it raises, it never falls back).
Recovery across processes is bit-exact only if every step is, so the
worker turns on ``torch.use_deterministic_algorithms`` with a fixed
``CUBLAS_WORKSPACE_CONFIG`` (set before torch starts, in this process
only), keeps TF32 off (``resolve_device``), and on the CPU runs one thread,
so that workers never take every core of their host.

One incarnation of one worker: build the reduced DLRM job, resume from the
newest valid layout-stamped checkpoint in ``--ckpt-dir`` (fresh init when
none), then train to ``--steps`` global steps, publishing a heartbeat file
after every step and appending each step's loss to a shared JSONL log.

Bit-exactness across kills is inherited, not re-implemented: batches are a
pure function of the global step (``DLRMJob``), checkpoints are layout-
stamped and checksum-verified (``FlashCheckpoint`` + ``resume_dlrm_stamped``),
so incarnation *k* replaying steps the dead incarnation already ran recomputes
byte-identical losses — the kill-matrix suite (``tests/test_torch_chaos_proc.py``)
asserts the merged loss log equals a never-killed run's to the ulp.

``--chaos-proc`` scripts this process's own death
(``repro_torch.core.faults.ProcessFaultInjector``): SIGKILL before a scheduled
step, SIGSTOP (the master's heartbeat deadline must catch it), or SIGKILL
inside the checkpoint pre-commit window. ``--incarnation`` (supplied by the
master) gates which specs fire, so a re-exec'd worker does not re-die
unless the plan says so (``kill_loop``).

Invoked as ``python -m repro_torch.train.worker_main`` — heavy imports happen
*after* the first "boot" heartbeat so the master can tell "booting" from
"dead" immediately. On the way out a worker prints the kernel launch
counts of its incarnation (``cuda_lib.LAUNCHES``) to its log.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.train.worker_main")
    ap.add_argument("--arch", default="wide_deep")
    ap.add_argument("--steps", type=int, required=True,
                    help="train until this many global steps completed")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--ckpt-every", type=int, default=3)
    ap.add_argument("--n-ps", type=int, default=4)
    ap.add_argument("--padded", action="store_true")
    ap.add_argument("--optimizer", default="adagrad")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--init-seed", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=11)
    ap.add_argument("--heartbeat", required=True,
                    help="heartbeat JSON path (atomically replaced per step)")
    ap.add_argument("--losses", required=True,
                    help="append-only JSONL of {incarnation, step, loss}")
    ap.add_argument("--fault-log", default=None,
                    help="append-only JSONL of fired process faults")
    ap.add_argument("--chaos-proc", default="",
                    help="process-level fault plan (kill/stop/kill_ckpt/"
                         "kill_loop specs; see repro_torch.core.faults)")
    ap.add_argument("--incarnation", type=int, default=0,
                    help="0 for the first exec; +1 per job-master re-exec")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)

    # publish liveness before the heavy imports and the device set-up: the
    # master's spawn grace (not its per-step deadline) covers everything
    # until "ready"
    from repro_torch.train.job_master import write_heartbeat
    pid = os.getpid()

    def beat(step: int, phase: str, restore_s: float = 0.0) -> None:
        write_heartbeat(args.heartbeat, pid=pid,
                        incarnation=args.incarnation, step=step,
                        phase=phase, restore_s=restore_s)

    beat(-1, "boot")

    # cuBLAS reads its workspace setting when it starts: set it before torch
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    torch.use_deterministic_algorithms(True)
    if args.device == "cpu":
        torch.set_num_threads(1)

    from repro_torch.configs.dlrm_models import reduced_dlrm
    from repro_torch.configs.registry import get_dlrm
    from repro_torch.core.faults import ProcessFaultInjector, parse_chaos_spec
    from repro_torch.core.flash_checkpoint import FlashCheckpoint
    from repro_torch.kernels import cuda_lib
    from repro_torch.train.supervisor import DLRMJob

    cfg = reduced_dlrm(get_dlrm(args.arch))
    injector = ProcessFaultInjector(
        parse_chaos_spec(args.chaos_proc), incarnation=args.incarnation,
        log_path=args.fault_log)
    ckpt = FlashCheckpoint(
        args.ckpt_dir, async_persist=False,  # sync: every blob restorable
        pre_commit_hook=injector.on_pre_commit)
    job = DLRMJob(cfg, ckpt, opt_name=args.optimizer, lr=args.lr,
                  init_seed=args.init_seed, data_seed=args.data_seed,
                  ckpt_every=args.ckpt_every, n_ps=args.n_ps,
                  padded=args.padded, device=args.device)
    t0 = time.perf_counter()
    start_step = job.start(resume=True)      # newest valid stamped blob
    # every later beat re-publishes restore_s: steps can outpace the master's
    # poll, so the "ready" beat alone would often be replaced before it's read
    restore_s = time.perf_counter() - t0
    beat(start_step, "ready", restore_s=restore_s)

    with open(args.losses, "a") as losses:
        while job.global_step < args.steps:
            injector.before_step(job.global_step)   # may SIGKILL/SIGSTOP here
            m = job.run_step()
            losses.write(json.dumps({
                "incarnation": args.incarnation, "step": m["step"],
                "loss": m["loss"]}) + "\n")
            losses.flush()
            beat(job.global_step, "step", restore_s=restore_s)
    job.save()                               # final blob on the way out
    ckpt.wait()
    beat(job.global_step, "done", restore_s=restore_s)
    print("launches " + json.dumps(cuda_lib.LAUNCHES), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
