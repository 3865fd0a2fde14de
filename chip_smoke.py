#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA. It imports nothing of JAX or of ``repro``.
Phases, each of which fails the run (exit 1, no ``ok`` line):

1. build: compile K1-K5 from ``src/repro_torch/csrc`` into ``build/``;
   print the card's name and power limit (``nvidia-smi``) and the
   ``-Xptxas -v`` lines (registers, shared memory, spills) of the
   redesigned kernels; K1-K3's main-path kernels, K4's tensor-core and
   SIMT kernels, K5's chunked instances (head dim 256, or more than 8
   q-heads per kv-head) and the segment sum's (SS) D=16 and D=1 instances
   must not spill.
2. K1 against its plain version on the card at the full Wide&Deep shapes
   (B=512, T=26, H=4, R=3,294,238, D=16 and the wide D=1), over
   sum/mean/max x weighted/unweighted x cache off/64/26*512 rows x flat/
   padded (n_ps=4): within K1_ULP (0: bit for bit); cache-on and padded
   outputs equal cache-off flat outputs bit for bit.
3. K2 and K3 against their plain versions on the deduped rows of a real
   full-width batch (D=16 on the vector route, D=1 on the scalar route),
   from fresh and from carried moment pools: bit for bit (0 ULP); rows not
   touched stay bit-identical.
4. the slice through ``repro_torch.launch.train``: 20 full-width Wide&Deep
   steps with the fused update (adagrad, zipf 1.05, 64 hot rows, padded
   shards), 5 with adam, 5 on the dense path; every kernel of each path
   launched (counts reset just before each run, read just after), losses
   finite; 3 further steps on the card and on the CPU (plain versions) from
   the same carried state and batches agree within LOSS_ATOL; one step run
   twice gives bit-identical pools.
5. per kernel: launches, median time at the main path's shapes, its bound
   at 3.35 TB/s, the plain version's time and, for K1, the time of
   ``torch.nn.functional.embedding_bag`` (a yardstick the port never calls).
   K1-K3 on both pools of the step: the deep D=16 pool, which must take
   the vector route, and the wide D=1 pool, K1's wide route and K2/K3's
   scalar route; the grids of ``bag_plan`` and ``update_plan``. SS, the
   dedupe's segment sum (``csrc/segment_sum.cu``), on the bags route of
   the step, at D=16 and D=1 on the rows of this batch and of a batch of
   the Wide&Deep benchmark cell (B=65,536 on Criteo Kaggle's tables, made
   by ``portbench``'s traffic generator): equal bit for bit to its plain
   version (``g_bags[order // H]``, then ``torch.segment_reduce``) and to
   the library path it replaced (the sorted gather of the expanded
   cotangent, then ``segment_reduce``), both timed beside it; its bound is
   the longest segment's chain of adds or its bytes.
6. a ``torch.profiler`` breakdown of the fused adagrad step: device time,
   idle share, the kernels that take the most device time, and K1 and K2
   (both pools each) and SS found by name, with their device time per call;
   fails if the trace has no device events or misses one of them.

The LM slice (llama3.2-3b at full width: 28 layers, d_model 3072, 24/8
heads of 128, d_ff 8192, vocab 128256, bf16; random weights from a seeded
``torch.Generator``):

7. K4 and K5 against their plain versions on the card at full-width shapes
   (24 q-heads over 8 kv-heads, D=128) in variants: f32 (K4's SIMT route)
   and bf16 (its tensor-core route, asserted for the full-width shapes);
   causal, windowed, softcapped; a sequence that is no multiple of the
   tile; ``q_offset > 0``; rows with no valid key; B=2; D=64 with G=4; for
   K5 the engine's bf16 q over an f32 cache, a bf16 cache, ``-1`` slots, a
   wrapped ring, and caches split into several ranges (asserted at B=1,
   L=2048), some of them with no valid slot. Within ATTN_TOL.
8. ``forward_lm`` logits against ``prefill_into_cache`` logits for one
   32-token prompt at full width (28 layers, bf16): rel < FWD_DEC_REL_BF16.
   K4 counted over the forward (counts reset just before it, read just
   after). Then a ``torch.profiler`` window of 8 decode steps of the
   engine's shape (batch 1, f32 cache of 128 slots), where K5 must run
   unsplit: one kernel per layer and step.
9. card against CPU: full width cut to 2 layers, f32, one weight set;
   ``forward_lm`` and 8 decode steps within CARD_CPU_REL.
10. serving through ``repro_torch.launch.serve``: ``--arch llama3.2-3b
    --full --requests 8 --slots 4 --max-new 16``; every request finishes
    with 16 tokens; K5 counted over the run.
11. K4 (B=1, S=2048, causal, bf16: the tensor-core route) and K5 (B=1,
    L=2048 and B=8, L=4096, the engine's bf16 q over an f32 cache) timed
    as in phase 5, with their plain versions,
    ``F.scaled_dot_product_attention`` on the same inputs (a yardstick the
    port never calls) and their bounds: flops at the bf16 tensor-core peak
    for K4, bytes at 3.35 TB/s for K5; K4's SIMT route timed on f32 inputs
    of the same shape (bound: flops at the f32 peak).

Live re-planning, checkpoints and elastic resume (full-width Wide&Deep,
64 hot rows, n_ps=4 padded, fused adagrad), run after phase 6:

12. the launcher with ``--replan-every 10 --ckpt-every 5 --ckpt-dir`` (a
    temporary directory under ``build/``, removed at the end): exactly one
    re-plan, at step 10; K1 and K2 launched twice in every one of the 20
    steps; exactly-once coverage; blobs 15 and 20 on disk. Then
    ``--resume --steps 5`` there: back on the stamped plan and padded
    layout from step 20. Then adam with ``--replan-every 5``: one re-plan
    at step 5, K3 in all 10 steps. Then, from the state at step 10 and the
    run's decision, bit for bit: the forward loss of a remapped probe batch
    across ``apply_replan``; one fused adagrad step under each plan (loss,
    ``mlp.w0``, pools and accumulators after the inverse permutation);
    ``restore_on_plan`` of the stamped pre-re-plan snapshot from disk; and
    ``resume_dlrm_stamped(onto_n_ps=2)`` of the post-re-plan blob. K1 on
    both post-re-plan pools (measured cache, unequal ranges) within K1_ULP
    of its plain version for sum, mean and max. Times: ``apply_replan``,
    ``save_with_layout`` (memory tier) and the disk persist,
    ``restore_with_layout`` from disk, ``HotTableTracker.observe`` per
    batch, and launcher steps/s without and with ``--replan-every``.

The self-healing layer, run last (full-width Wide&Deep, 64 hot rows,
n_ps=4 padded, fused update):

13. (a) the launcher's supervised mode, 30 steps with synchronous
    checkpoints every 5: a clean run, whose slowest step (a checkpoint
    step) sets the step deadline (DEADLINE_FACTOR times it); then the same
    run under SELFHEAL_CHAOS, which must give exactly the events of
    SELFHEAL_WANT (an elastic shrink onto 3 PS shards, a watchdog restore,
    and a fall-back past the corrupted step-20 blob while shrinking onto
    2) and a loss at every step equal (``==``) to the clean run's; then
    adam under ``oom@5,oom@9``, whose recoveries must be
    ``drop_hot_cache`` and ``shrink_batch_to_256`` with no step lost (K1
    then runs without a cache, K3 under the supervisor). Counts are set to
    0 before each run and read after: K1 and K2 (K3) launch exactly twice
    per executed step and per warm-up. (b) the job master with four
    workers on the card (reduced Wide&Deep, n_ps=4 padded): a baseline
    and ``kill@4``, ``stop@7``, ``kill_ckpt@3``; each cell's merged loss
    log equals the baseline's to the ulp, every non-final incarnation
    died by SIGKILL, no worker's process group is left, and each worker's
    last incarnation reports its K1 launches. Re-exec (death to ready) and
    restore latencies are reported.

The resource manager, run after phase 13:

14. (a) ``examples/elastic_dlrm_train_torch.py`` at its full config (the
    reference example's: 26 tables, 18,240,000 pooled rows, D=16, MLP
    256/128/64, batch 256; dense path, adagrad) for ``--steps 160`` on the
    card, under the port's ``ClusterBrain``: the executed steps, the
    exactly-once coverage across the failover and the straggler split,
    and the stage-1/2/3 decisions equal LIFECYCLE_WANT (what the
    reference's control plane gives, held there by
    ``tests/test_torch_brain.py``); one config-DB record after
    ``complete``; losses finite and the mean of the last 10 below the
    first; AUC in (0.5, 1]; K1 exactly twice per executed step plus twice
    for the eval, and no other kernel. Launcher steps/s, the median step
    (through ``float(loss)``), peak memory and the checkpoint's tiers.
    (b) the first 10 jobs of the port's trace copy through
    ``repro_torch.sim.replay.replay`` under ``dlrover_rm`` and
    ``static_user`` (6 h, seed 3, failure seed 77, amplitude 0.15), with
    the default ``TIMINGS`` and with phase 13's measured flash restore and
    worker re-exec, each replay in its own process; a second run with the
    card's timings gives the same summary and event log.

The rest of the LM zoo, run last (seeded random bf16 weights, batch 1,
f32 caches):

15. (a) K4 and K5 at the zoo's new shapes against their plain versions
    within ATTN_TOL: K5 at recurrentgemma's local layers (1 kv-head, 10
    q-heads, D=256, window 2048; bf16 q over an f32 and a bf16 cache, 128
    and 2048 slots (split), a wrapped ring, empty splits); K4 at D=256,
    10/1 heads, causal and window 2048, on its tensor-core route in bf16
    (also one query at position 2,047 against 2,048 keys, and S=1000 with
    window 256) and its SIMT route in f32; its tensor-core route at
    Whisper's encoder (S=1500, 16/16 heads, D=64, non-causal) and
    cross-attention (Sq=1 and Sq=16 against 1,500 keys, split over the
    keys), and the SIMT route at the same shapes in f32; each case logged
    with its ``split_plan`` count, which must be 1 at Whisper's encoder,
    llama3.2-3b's and recurrentgemma's shapes and more at the
    cross-attention. (b) granite-moe-1b-a400m,
    mamba2-2.7b and recurrentgemma-2b at full width and depth:
    ``forward_lm`` against ``prefill_into_cache`` on a 32-token prompt, rel
    < FWD_DEC_REL_BF16 (MoE at ``capacity_factor = n_experts``); for the
    archs of ZOO_CHECK_F32 (mamba2 and the MoE archs, where bf16 rounding
    alone moves the logits past that bound) the same weights in f32 within
    FWD_DEC_REL_F32, the bf16 numbers reported; K4 once per attention
    layer over the forward and K5 once per attention layer and token over
    the decode, exactly, and nothing else; 8 timed decode
    steps; then ``repro_torch.launch.serve --arch <id> --full --requests 4
    --slots 2 --max-new 8``, every request finished, K5 exactly attention
    layers x (prompt + decoded tokens). whisper-medium (24 + 24 layers)
    through its ``ModelAPI``: the teacher-forced pass on 1,500 random
    frames and 16 tokens against ``fill_cross_cache`` and 16 decode steps
    within FWD_DEC_REL_BF16, K4 and K5 counted exactly. (c) minitron-8b at
    full depth, gemma3-27b cut to 6 layers (one 5-local + 1-global group),
    command-r-35b, chameleon-34b and mixtral-8x22b cut to 2 layers, as in
    (b) without serving. (d) card against CPU, f32, full width: granite,
    mamba2 and whisper cut to 2 layers, recurrentgemma to 3 (one whole
    recurrent, recurrent, local group); forward and 8 decode steps within
    CARD_CPU_REL. (e) K5 at recurrentgemma's L=128 and L=2048, K4 at
    Whisper's encoder and cross-attention shapes (one decode step, Sq=1,
    and the teacher-forced pass, Sq=16; ``n_split`` per row) and at
    D=256, S=2048 (the tensor-core route in bf16, the SIMT route in f32),
    timed as in phase 11 with the plain version, SDPA and the bound. (f)
    recurrentgemma-2b's eval step (``trainer.make_eval_step``) on (b)'s
    full-depth weights at B=1, S=2048 on an ``lm_batch``: K4 exactly once
    per local layer (8) and nothing else (counts reset just before one
    step, read just after), its loss within LM_EVAL_REL of the training
    (chunked) route's on the same batch, and the median of ZOO_EVAL_STEPS
    synchronised steps. (g) per model: ms per decode step, tok/s served,
    peak memory.

LM training, run last (adamw at LM_LR, remat; attention trains on the
chunked route of ``models/attention.py``, so no kernel launches in a train
step):

16. (a) ``repro_torch.launch.train --arch llama3.2-3b --full --steps 10
    --batch 8 --seq 64`` (28 layers, 3.2 B params, bf16): losses finite,
    the mean of the last 3 below the first, 10 steps, exactly-once
    coverage of 80 samples, no kernel launched, peak memory under 80 GB;
    ms per step (median of steps 3-10, synchronised) and tokens/s. (c)
    the eval step on the trained state: K4 exactly once per layer (28),
    its loss within LM_EVAL_REL of the training route's on the same
    params and batch. A ``torch.profiler`` split of one step: the whole
    step, its forward + backward and its optimizer in windows of their
    own (device time, host gaps, idle share). (b) two steps at B=1,
    S=2048: ms and peak memory. (d) three launcher steps of
    granite-moe-1b-a400m, mamba2-2.7b, recurrentgemma-2b and
    whisper-medium at full width and depth (B=8, S=64; whisper's 1,500
    zero frames): losses finite, no kernel launched, ms per step and peak
    memory. (e) card against CPU, f32, full width cut to 2 layers, B=2,
    S=64, TF32 off: the loss within LM_CARD_CPU_LOSS_REL, every gradient
    leaf within LM_CARD_CPU_GRAD_REL, the params after one adamw step
    within 2 lr element by element and the loss after it within
    LM_CARD_CPU_STEP_LOSS_REL. (f) ``--ckpt-dir --ckpt-every 5`` for 10
    steps at full width cut to 2 layers (a temporary directory under
    ``build/``), then ``--resume --steps 5``: blobs 5 and 10, the state
    restored from disk equal to the saved one bit for bit, the resumed
    run's first loss equal to a step of the saved state in process; the
    memory tier, persist and restore times.

The single-table bag, the batched-serving example and the cost tool, run
last:

17. (a) ``ops.embedding_bag`` (K1 with one table) on Wide&Deep's largest
    table (870,963 rows) at D=16 and D=1, B=512, zipf 1.05 ids, n=4 (the
    vector and wide routes) and n=3 (the generic route), sum/mean/max,
    unweighted and weighted: one K1 launch per call (counts set to 0 just
    before the 24 calls, read just after), each output bit for bit with
    K1's plain version, the route asserted; timed at n=4 (unweighted sum)
    as in phase 5, through the wrapper and alone, beside the plain
    version, ``F.embedding_bag`` and the bytes bound. (b)
    ``examples/serve_batched_torch.py`` for llama3.2-3b and mamba2-2.7b in
    subprocesses with ``--device cuda`` and ``--device cpu``: each exits 0
    and the card's tokens equal the CPU's; its ``serve`` in process on the
    card, counted: llama launches K5 and nothing else, mamba2 nothing. (c)
    ``repro_torch.launch.costs`` on full-width llama3.2-3b, on meta tensors
    on the host: model FLOPs, the counted step FLOPs and the analytic HBM
    bytes at phase 16's shape (B=8, S=64, remat), and the step's shares of
    the bf16 dense peak and of the HBM bandwidth at phase 16's median step;
    ``train_4k`` through the module's CLI. (d) the launcher's 5 fused adam
    steps (phase 4's config), then phase 6's profile of that step: K1 and
    K3 on both pools found by name, their device time per call.

Prints the ``slice``, ``lm``, ``replan``, ``selfheal``, ``lifecycle``,
``sim``, ``lm_zoo``, ``lm_train`` and ``single_table`` JSON lines, the
``kernels`` JSON line (K1-K5 and SS; K1-K3 with their phase-13 launches under
``launches_selfheal``, K1 with phase 14's under ``launches_lifecycle`` and
phase 17's under ``launches_single_table`` with their timings under
``at_single_table``, K3 with its in-step time under
``in_step_us_per_call``, K4 and K5 with phase 15's per
model under ``launches_lm_zoo`` and their phase-15 timings under
``at_lm_zoo_shapes``, K4 with phase 15 (f)'s eval step under
``launches_lm_zoo_eval`` and phase 16's per train step and per eval under
``launches_lm_train``), and last ``{"ok": true, "device": {...}}``. Full
details go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

K1_ULP = 0            # K1 vs plain: bit for bit (the same _rn operations
                      # in the same order)
PARAM_ULP = 0         # K2/K3 vs plain on the card, params and moments: bit
MOMENT_ULP = 0        # for bit (the same _rn operations in the same order)
LOSS_ATOL = 1e-4      # card vs CPU loss, 3 full-width steps
# K4/K5 vs plain, (abs, rel) of the plain output: both compute in f32 in
# other orders, so a bf16 output may round one bf16 step (at most 2^-7 of
# its magnitude) the other way, and no further
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-3, 8e-3)}
# SDPA, the yardstick the port never calls, is held to its own bound: in
# bf16 it rounds the probabilities to bf16 before the PV product
SDPA_TOL = (1.6e-2, 1.6e-2)
FWD_DEC_REL_BF16 = 5e-2       # full-width bf16 forward vs decode logits
CARD_CPU_REL = 1e-4           # f32 logits, card vs CPU, 2 full-width layers
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published peak at 700 W
F32_FLOP_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12      # H100 SXM, dense bf16 on the tensor cores
TIMING_ITERS = 50
SPIN_CYCLES = 50_000_000      # ~25 ms of a spinning kernel at ~2 GHz


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def ulp_distance(a, b) -> int:
    """Largest distance in float32 ULP between two float32 tensors."""
    import torch
    check(a.shape == b.shape, f"shape mismatch {a.shape} vs {b.shape}")
    if a.numel() == 0:
        return 0

    def line(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((line(a) - line(b)).abs().max())


def time_ms(fn, flush, iters=TIMING_ITERS, warmup=3):
    """Median device time of ``fn`` in ms over ``iters`` launches, each
    timed alone with CUDA events after a write that evicts the L2.

    A spin kernel first keeps the card busy while the host enqueues every
    launch, so no host-side launch gap lands between a pair of events (a
    function that synchronises inside, as the plain versions' boolean
    masks do, still pays its own gaps)."""
    import torch
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def bound_ms(n_bytes, n_flops, flop_per_s=F32_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


def clone_state(state, device):
    """Deep copy of a train state onto ``device``."""
    import torch

    def move(x):
        if torch.is_tensor(x):
            return x.detach().to(device, copy=True)
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        return copy.deepcopy(x)

    return move(state)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
# patterns on the mangled names of the redesigned kernels -> report names
PTXAS_REPORTED = {
    "bag_vec16_kernelILi0E": "K1 D=16 vector (sum)",
    "bag_wide_kernelILi0E": "K1 D=1 wide (sum)",
    "flash_tc_kernelILi256": "K4 tensor-core D=256",
    "flash_tc_kernelILi128": "K4 tensor-core D=128",
    "flash_tc_kernelILi64": "K4 tensor-core D=64",
    "flash_fwd_kernelI\\w*Li8E": "K4 SIMT D<=128 (f32, bf16)",
    "flash_fwd_kernelI\\w*Li16E": "K4 SIMT D<=256 (f32, bf16)",
    "decode_split_kernelILi4ELi8ELi8ELb0E13__nv_bfloat16fE":
        "K5 split D<=128 (bf16 q, f32 cache)",
    "decode_split_kernelILi4ELi8ELi8ELb1E":
        "K5 split D<=128, G>8 (every q and cache dtype)",
    "decode_split_kernelILi8ELi4ELi4ELb1E":
        "K5 split D<=256 (every q and cache dtype)",
    "decode_combine_kernelI13__nv_bfloat16E": "K5 combine (bf16 q)",
    **{f"rows_{kind}_kernelI\\w*{op}E": f"{k} {name}"
       for op, k in (("AdagradOp", "K2"), ("AdamOp", "K3"))
       for kind, name in (("vec16", "D=16 vector"), ("wide", "D=1 scalar"))},
    **{f"segment_sum_{kind}_kernelI{args}E": f"SS {kind} {name}"
       for kind in ("short", "long")
       for args, name in (("Li16ELb1", "D=16 float4"), ("Li1ELb0", "D=1"))},
}


def ptxas_report(build_log):
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of the
    kernels named in PTXAS_REPORTED, one string per kernel."""
    import re
    out, current = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            current = next((name for key, name in PTXAS_REPORTED.items()
                            if re.search(key, line)), None)
        elif current and ("spill" in line or "Used" in line):
            out.setdefault(current, []).append(
                line.split("info    :")[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def phase_build(report):
    from repro_torch.kernels import cuda_lib
    t0 = time.perf_counter()
    lib = cuda_lib.build()
    cuda_lib.load()
    build_log = cuda_lib.build_log() or ""
    ptxas = ptxas_report(build_log)
    report["build"] = {"seconds": time.perf_counter() - t0,
                       "library": str(lib.relative_to(ROOT)),
                       "ptxas": ptxas, "log": build_log}
    log(f"phase 1 build: {lib.name} in {report['build']['seconds']:.1f} s")
    missing = set(PTXAS_REPORTED.values()) - set(ptxas)
    check(not missing, f"no ptxas lines for {missing}")
    import re
    for name, line in ptxas.items():
        log(f"  ptxas {name}: {line}")
        if name.startswith(("K1", "K2", "K3", "K4", "K5 split D<=256",
                            "K5 split D<=128, G>8", "SS")):
            spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes "
                                r"spill loads", line)
            check(spills and all(a == b == "0" for a, b in spills),
                  f"{name} spills: {line}")


def _full_cfg(hot_rows_k=64):
    from repro_torch.configs.registry import get_dlrm
    return dataclasses.replace(get_dlrm("wide_deep"), zipf_alpha=1.05,
                               hot_rows_k=hot_rows_k)


def _real_batch(cfg, dev, step=0):
    from repro_torch.data.synthetic import criteo_batch
    from repro_torch.launch import train as launch
    ids = list(launch.sample_order(step + 1, cfg.batch_size))[step]
    return launch.to_device(criteo_batch(cfg, launch.DATA_SEED, ids), dev)


def phase_k1(report, dev):
    import torch
    from repro_torch.kernels import fused_embedding as fe
    from repro_torch.sharding import policy as pol

    cfg = _full_cfg()
    batch = _real_batch(cfg, dev)
    idx = batch["sparse"]
    B, T, H = idx.shape
    layout = pol.padded_layout_for_ranges(
        pol.uniform_vocab_ranges(cfg.total_embedding_rows, 4))
    gen = torch.Generator(device=dev).manual_seed(1)
    w = torch.rand((B, T, H), generator=gen, device=dev) + 0.5
    max_err, max_ulp, n_checked = 0.0, 0, 0
    for D in (cfg.embed_dim, 1):
        flat_pool = torch.randn((cfg.total_embedding_rows, D), generator=gen,
                                device=dev)
        pools = {"flat": (flat_pool, None),
                 "padded": (layout.pad_rows(flat_pool).reshape(
                     layout.padded_rows, D), layout)}
        for combiner in ("sum", "mean", "max"):
            for weights in (None, w):
                base = None
                for name, (pool, lay) in pools.items():
                    for hot in (0, 64, 26 * 512):
                        table_hot = _full_cfg(hot).table_hot
                        plan = pol.EmbeddingPlan(
                            offsets=cfg.table_offsets, combiner=combiner,
                            table_hot=table_hot, layout=lay)
                        enc, cache = fe.kernel_inputs(pool, idx, plan)
                        got = fe.embedding_bag_cuda(pool, enc, weights, cache,
                                                    combiner)
                        want = fe.embedding_bag_plain(pool, enc, weights,
                                                      cache, combiner)
                        torch.cuda.synchronize()
                        tag = (f"K1 D={D} {combiner} "
                               f"{'weighted' if weights is not None else ''} "
                               f"{name} hot={hot}")
                        u = ulp_distance(got, want)
                        max_ulp = max(max_ulp, u)
                        check(u <= K1_ULP, f"{tag}: {u} ULP > {K1_ULP}")
                        max_err = max(max_err,
                                      float((got - want).abs().max()))
                        if base is None:
                            base = got
                        check(torch.equal(got, base),
                              f"{tag}: differs from cache-off flat output")
                        n_checked += 1
                # the autograd entry point launches K1 on the same inputs
                pub = fe.fused_embedding_bag(pool, idx, weights, plan=plan)
                check(torch.equal(pub, base), f"K1 D={D} {combiner}: "
                      "fused_embedding_bag differs from the kernel")
        del flat_pool, pools
    report["k1"] = {"variants": n_checked, "max_abs_err": max_err,
                    "max_ulp": max_ulp, "ulp_bound": K1_ULP}
    log(f"phase 2 K1: {n_checked} variants agree with the plain version "
        f"(max {max_ulp} ULP, bound {K1_ULP}; cache and padded outputs "
        "bit-identical)")
    return max_err


def _sparse_rows(cfg, dev, D):
    """Deduped (rows, vals) of a real full-width batch for a D-wide pool."""
    import torch
    from repro_torch.kernels import fused_embedding as fe
    batch = _real_batch(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    pool = torch.randn((cfg.total_embedding_rows, D), generator=gen,
                       device=dev)
    g = torch.randn((cfg.batch_size, cfg.n_tables, D), generator=gen,
                    device=dev)
    rows, vals, _ = fe.sparse_row_grads(pool, batch["sparse"], g,
                                        plan=cfg.embedding_plan())
    return pool, rows, vals


def phase_k2_k3(report, dev):
    """K2/K3 vs plain on the deduped rows of a real full-width batch.

    From (a) fresh moment pools without weight decay, as on a first step,
    and (b) carried random moments with weight decay: params within
    PARAM_ULP and moments within MOMENT_ULP ULPs, both 0: the kernels avoid
    FMA contraction and keep the plain versions' order; untouched rows stay
    bit-identical.
    """
    import torch
    from repro_torch.kernels import fused_update as fu
    cfg = _full_cfg()
    errs = {"adagrad_row_update": 0.0, "adam_row_update": 0.0}
    worst = {}
    b1, b2, lr = 0.9, 0.999, 3e-3

    def note(kernel, tag, got, want, bound):
        u = ulp_distance(got, want)
        worst[tag] = max(worst.get(tag, 0), u)
        check(u <= bound, f"{tag}: {u} ULP > {bound}")
        errs[kernel] = max(errs[kernel], float((got - want).abs().max()))

    for D in (cfg.embed_dim, 1):
        p0, rows, vals = _sparse_rows(cfg, dev, D)
        R = p0.shape[0]
        untouched = torch.ones(R, dtype=torch.bool, device=dev)
        untouched[rows[rows < R].long()] = False
        gen = torch.Generator(device=dev).manual_seed(3)
        carried = torch.rand(p0.shape, generator=gen, device=dev)
        for state in ("fresh", "carried"):
            a0 = torch.zeros_like(p0) if state == "fresh" else carried
            m0 = torch.zeros_like(p0) if state == "fresh" else carried - 0.5
            wd = 0.0 if state == "fresh" else 0.01
            # K2
            pk, ak, pp, ap = p0.clone(), a0.clone(), p0.clone(), a0.clone()
            fu.adagrad_rows_cuda(pk, ak, rows, vals, lr=lr, eps=1e-10)
            fu.adagrad_rows_plain(pp, ap, rows, vals, lr=lr, eps=1e-10)
            torch.cuda.synchronize()
            tag = f"K2 D={D} {state}"
            note("adagrad_row_update", f"{tag} params", pk, pp, PARAM_ULP)
            note("adagrad_row_update", f"{tag} acc", ak, ap, MOMENT_ULP)
            check(torch.equal(pk[untouched], p0[untouched])
                  and torch.equal(ak[untouched], a0[untouched]),
                  f"{tag}: untouched rows changed")
            # K3
            bias = fu.adam_bias(7, b1, b2, dev)
            kw = dict(lr=lr, b1=b1, b2=b2, eps=1e-8, wd=wd)
            pk, mk, vk = p0.clone(), m0.clone(), a0.clone()
            pp, mp, vp = p0.clone(), m0.clone(), a0.clone()
            fu.adam_rows_cuda(pk, mk, vk, rows, vals, bias, **kw)
            fu.adam_rows_plain(pp, mp, vp, rows, vals, bias, **kw)
            torch.cuda.synchronize()
            tag = f"K3 D={D} {state}"
            note("adam_row_update", f"{tag} params", pk, pp, PARAM_ULP)
            note("adam_row_update", f"{tag} m", mk, mp, MOMENT_ULP)
            note("adam_row_update", f"{tag} v", vk, vp, MOMENT_ULP)
            check(torch.equal(pk[untouched], p0[untouched])
                  and torch.equal(mk[untouched], m0[untouched])
                  and torch.equal(vk[untouched], a0[untouched]),
                  f"{tag}: untouched rows changed")
    report["k2_k3"] = {"max_abs_err": errs, "worst_ulps": worst,
                       "param_ulp_bound": PARAM_ULP,
                       "moment_ulp_bound": MOMENT_ULP}
    log(f"phase 3 K2/K3: within {PARAM_ULP}/{MOMENT_ULP} ULP of the plain "
        f"versions, untouched rows bit-identical; worst ULPs {worst}")
    return errs


SLICE_FLAGS = ["--arch", "wide_deep", "--full", "--zipf-alpha", "1.05",
               "--hot-rows", "64", "--padded-shards", "--device", "cuda"]


def _driven(argv, expect):
    """One launcher run with every count set to 0 just before it and read
    just after; fails if a kernel of that path did not launch."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import train as launch
    cuda_lib.reset_launches()
    run = launch.main(argv)
    counts = dict(cuda_lib.LAUNCHES)
    for kernel in expect:
        check(counts[kernel] > 0, f"{kernel} never launched on {argv}")
    check(all(math.isfinite(x) for x in run.losses),
          f"non-finite loss on {argv}: {run.losses}")
    return run, counts


def phase_slice(report, dev):
    import torch
    from repro_torch.data.synthetic import criteo_batch
    from repro_torch.launch import train as launch
    from repro_torch.train import trainer

    log("phase 4 slice: 20 steps, fused update, adagrad")
    run, c_main = _driven(SLICE_FLAGS + ["--fused-update", "--steps", "20"],
                          ("fused_embedding_bag", "adagrad_row_update",
                           "segment_sum_bags"))
    log("phase 4 slice: 5 steps, fused update, adam")
    _, c_adam = _driven(SLICE_FLAGS + ["--fused-update", "--optimizer",
                                       "adam", "--steps", "5"],
                        ("fused_embedding_bag", "adam_row_update",
                         "segment_sum_bags"))
    log("phase 4 slice: 5 steps, dense path")
    _, c_dense = _driven(SLICE_FLAGS + ["--steps", "5"],
                         ("fused_embedding_bag", "segment_sum_bags"))

    # 3 further steps on the card and on the CPU from the carried state
    cfg, opt, plan = run.cfg, run.opt, run.plan
    step = trainer.make_dlrm_train_step(cfg, opt, plan=plan)
    more = list(launch.sample_order(23, cfg.batch_size))[20:]
    batches = [criteo_batch(cfg, launch.DATA_SEED, ids) for ids in more]
    gpu_state = clone_state(run.state, dev)
    cpu_state = clone_state(run.state, "cpu")
    gpu_losses, cpu_losses = [], []
    for b in batches:
        gpu_state, m = step(gpu_state, launch.to_device(b, dev))
        gpu_losses.append(float(m["loss"]))
        cpu_state, m = step(cpu_state, launch.to_device(b, "cpu"))
        cpu_losses.append(float(m["loss"]))
    loss_diff = max(abs(a - b) for a, b in zip(gpu_losses, cpu_losses))
    pool_diff = float((gpu_state["params"]["tables"].cpu()
                       - cpu_state["params"]["tables"]).abs().max())
    check(loss_diff <= LOSS_ATOL,
          f"card vs CPU losses differ by {loss_diff} > {LOSS_ATOL}: "
          f"{gpu_losses} vs {cpu_losses}")
    log(f"  card vs CPU, 3 steps: losses {gpu_losses} vs {cpu_losses} "
        f"(max diff {loss_diff:.3g}, bound {LOSS_ATOL}); pools max diff "
        f"{pool_diff:.3g}")
    del cpu_state

    # one step twice from the same state: bit-identical pools
    dev_batch = launch.to_device(batches[0], dev)
    a, _ = step(clone_state(run.state, dev), dev_batch)
    b, _ = step(clone_state(run.state, dev), dev_batch)
    for k in ("tables", "wide"):
        check(torch.equal(a["params"][k], b["params"][k])
              and torch.equal(a["opt"]["acc"][k], b["opt"]["acc"][k]),
              f"two identical steps gave different {k} pools")
    log("  one step twice: bit-identical pools and accumulators")
    del a, b

    # step time without host data generation: batches already on the card
    dev_batches = [launch.to_device(x, dev) for x in batches]
    state = clone_state(run.state, dev)
    state, _ = step(state, dev_batches[0])
    torch.cuda.synchronize()
    n_timed = 30
    t0 = time.perf_counter()
    for i in range(n_timed):
        state, m = step(state, dev_batches[i % len(dev_batches)])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_timed * 1e3
    slice_info = {
        "arch": cfg.name, "pooled_rows": cfg.total_embedding_rows,
        "batch": cfg.batch_size, "steps": len(run.losses),
        "launcher_steps_per_s": len(run.losses) / run.seconds,
        "train_step_ms": step_ms, "train_steps_per_s": 1e3 / step_ms,
        "first_loss": run.losses[0], "last_loss": run.losses[-1],
        "cpu_vs_card_max_loss_diff": loss_diff,
        "cpu_vs_card_max_pool_diff": pool_diff,
        "launches": {"adagrad_fused": c_main, "adam_fused": c_adam,
                     "dense": c_dense},
    }
    report["slice"] = slice_info
    return run, c_main, c_adam, slice_info


def phase_timing(report, dev, run, c_main, c_adam, errs):
    import torch
    from repro_torch.kernels import fused_embedding as fe
    from repro_torch.models.dlrm import _pool2d

    cfg, plan = run.cfg, run.plan
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    idx = _real_batch(cfg, dev)["sparse"]
    kernels = []

    # K1 on the main path: both pools, unweighted sum, 64 hot rows, padded
    params = run.state["params"]
    k1 = {"deep": _time_k1(_pool2d(params["tables"], plan.layout), idx,
                           plan, "vector", flush),
          "wide": _time_k1(_pool2d(params["wide"], plan.layout), idx, plan,
                           "wide", flush)}
    D = cfg.embed_dim
    k1d = k1["deep"]
    kernels.append({
        "name": "K1 fused_embedding_bag", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_embedding.cu",
        "replaces": "src/repro/kernels/fused_embedding.py:249",
        "launches": c_main["fused_embedding_bag"], "max_abs_err": errs["k1"],
        "ms": k1d["ms"], "plain_ms": k1d["plain_ms"],
        "bound_ms": k1d["bound_ms"], "bound_by": k1d["bound_by"],
        "library_ms": k1d["library_ms"],
        "at": f"D={D}, {k1d['route']} route", "blocks": k1d["blocks"],
        **{f"wide_{k}": k1["wide"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "blocks")}})

    # K2/K3 on the deduped rows of the same batch (scratch copies of pools):
    # the deep pool (D=16, vector route) and the wide pool (D=1, scalar)
    k23 = {}
    for width in (D, 1):
        k23[width] = _time_k2_k3(dev, cfg, width, flush)
    for name, kernel, launches, replaces in (
            ("K2 adagrad_row_update", "adagrad_row_update",
             c_main["adagrad_row_update"], 72),
            ("K3 adam_row_update", "adam_row_update",
             c_adam["adam_row_update"], 180)):
        deep, wide = k23[D][kernel], k23[1][kernel]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/fused_update.cu",
            "replaces": f"src/repro/kernels/fused_update.py:{replaces}",
            "launches": launches, "max_abs_err": errs["k2_k3"][kernel],
            "ms": deep["ms"], "plain_ms": deep["plain_ms"],
            "bound_ms": deep["bound_ms"], "bound_by": deep["bound_by"],
            "library_ms": None, "at": f"D={D}, {deep['route']} route",
            "blocks": deep["blocks"], "wide_ms": wide["ms"],
            "wide_plain_ms": wide["plain_ms"],
            "wide_bound_ms": wide["bound_ms"],
            "wide_bound_by": wide["bound_by"], "wide_blocks": wide["blocks"]})

    # SS, the dedupe's segment sum, on the bags route of the step: both
    # stores of this batch, then of a batch of the Wide&Deep benchmark cell
    # (B=65,536 on Criteo Kaggle's tables), whose longest segment sets it
    store_idx = fe._flat_lookups(idx, plan.offsets)
    if plan.layout is not None:
        store_idx = fe.translate_rows(store_idx, plan.layout)
    H = idx.shape[2]
    ss = {"deep": _time_ss(store_idx, H, D, flush),
          "wide": _time_ss(store_idx, H, 1, flush)}
    cell_idx, cell_at = _cell_lookups(dev)
    ss["cell"] = {"at": cell_at,
                  "deep": _time_ss(cell_idx, cell_at["H"], D, flush),
                  "wide": _time_ss(cell_idx, cell_at["H"], 1, flush)}
    del cell_idx
    ssd = ss["deep"]
    kernels.append({
        "name": "SS segment_sum", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_sum.cu",
        "replaces": None, "launches": c_main["segment_sum_bags"],
        "max_abs_err": 0.0, "ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
        "library_ms": ssd["library_ms"],
        "at": f"D={D}, bags route, longest segment {ssd['longest']}",
        **{f"wide_{k}": ss["wide"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "at_wide_deep_cell": ss["cell"]})
    report["kernels"] = kernels
    report["timing"] = {
        "l2_flushed": True, "iters": TIMING_ITERS,
        "k1": k1, "k2_k3": k23, "segment_sum": ss,
        "launches_per_step": {
            "fused_embedding_bag": c_main["fused_embedding_bag"] / 20,
            "adagrad_row_update": c_main["adagrad_row_update"] / 20,
            "adam_row_update": c_adam["adam_row_update"] / 5,
            "segment_sum_bags": c_main["segment_sum_bags"] / 20}}
    log(f"phase 5 timing: K1 {k1d['ms']:.4f} ms (wide "
        f"{k1['wide']['ms']:.4f} ms), "
        f"K2 {k23[D]['adagrad_row_update']['ms']:.4f} ms (wide "
        f"{k23[1]['adagrad_row_update']['ms']:.4f} ms), K3 "
        f"{k23[D]['adam_row_update']['ms']:.4f} ms (wide "
        f"{k23[1]['adam_row_update']['ms']:.4f} ms); "
        f"{k23[D]['live_rows']} live rows, {k1d['cold_rows']} cold K1 rows")
    for tag, row in (("", ss), (" at the W&D cell's batch", ss["cell"])):
        log(f"  SS{tag}: {row['deep']['ms']:.4f} ms (wide "
            f"{row['wide']['ms']:.4f} ms), plain {row['deep']['plain_ms']:.4f}"
            f" ms, library {row['deep']['library_ms']:.4f} ms, bound "
            f"{row['deep']['bound_ms']:.4f} ms ({row['deep']['bound_by']}; "
            f"longest segment {row['deep']['longest']})")
    return kernels


def _time_k1(pool, idx, plan, want_route, flush):
    """K1 on one pool of the main path (unweighted sum, the plan's hot rows
    and layout), which must take ``want_route``: timed beside its plain
    version, ``F.embedding_bag`` on the same rows (cache-off indices), and
    its bound: the distinct cold rows, the cache, the indices and the
    output, each moved once, at 3.35 TB/s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_embedding as fe
    B, T, H = idx.shape
    D = pool.shape[1]
    plan = plan.with_combiner("sum")
    enc, cache = fe.kernel_inputs(pool, idx, plan)
    ours = fe.embedding_bag_cuda(pool, enc, None, cache, "sum")
    route = fe.bag_route(D, H, pool, enc, ours,
                         *(x for x in (cache,) if x is not None))
    check(route == want_route,
          f"K1 at D={D} takes the {route} route, not {want_route}")
    k_ms = time_ms(lambda: fe.embedding_bag_cuda(pool, enc, None, cache,
                                                 "sum"), flush)
    p_ms = time_ms(lambda: fe.embedding_bag_plain(pool, enc, None, cache,
                                                  "sum"), flush)
    # the yardstick: one library call on the same rows (cache-off indices)
    store_rows, _ = fe.kernel_inputs(
        pool, idx, dataclasses.replace(plan, table_hot=None))
    bag_idx = store_rows.reshape(B * T, H).long()
    ones = torch.ones(bag_idx.shape, device=pool.device)
    lib_out = F.embedding_bag(bag_idx, pool, mode="sum",
                              per_sample_weights=ones)
    check(float((lib_out.reshape(B, T, D) - ours).abs().max()) < 1e-5,
          f"embedding_bag yardstick at D={D} computes another function")
    l_ms = time_ms(lambda: F.embedding_bag(bag_idx, pool, mode="sum",
                                           per_sample_weights=ones), flush)
    n = B * T * H
    n_cold_rows = int(torch.unique(enc[enc >= 0]).numel())
    n_bytes = (n_cold_rows * D * 4 + (0 if cache is None else cache.numel())
               * 4 + n * 4 + B * T * D * 4)
    b_ms, b_by = bound_ms(n_bytes, n * D)
    return {"route": route, "blocks": fe.bag_plan(B * T, route),
            "threads": fe.BAG_THREADS[route], "ms": k_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
            "cold_rows": n_cold_rows, "bytes": n_bytes}


def _time_k2_k3(dev, cfg, D, flush):
    """K2 and K3 timed on the deduped rows of a real batch for a D-wide
    pool, beside their plain versions and bounds (bytes: 5 and 7 words per
    live row element plus a row id per entry). The route must be the main
    path's (vector for D=16, scalar for D=1); ``update_plan``'s grid is
    reported."""
    import torch
    from repro_torch.kernels import fused_update as fu
    p0, rows, vals = _sparse_rows(cfg, dev, D)
    R, N = p0.shape[0], rows.shape[0]
    n_live = int((rows < R).sum())
    acc = torch.rand(p0.shape, device=dev)
    m_k, v_k = acc.clone() - 0.5, acc.clone()
    route = fu.update_route(D, p0, vals, acc)
    want = "vector" if D % 4 == 0 else "scalar"
    check(route == want, f"K2/K3 at D={D} take the {route} route, not {want}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = fu.update_plan(N, D, sms, route)
    out = {"live_rows": n_live, "entries": N}
    p_k, a_k = p0.clone(), acc.clone()
    bias = fu.adam_bias(7, 0.9, 0.999, dev)
    kw = dict(lr=3e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.0)
    for adam, kernel, words, flops in ((0, "adagrad_row_update", 5, 6),
                                       (1, "adam_row_update", 7, 14)):
        if adam:
            k_ms = time_ms(lambda: fu.adam_rows_cuda(
                p_k, m_k, v_k, rows, vals, bias, **kw), flush)
            p_ms = time_ms(lambda: fu.adam_rows_plain(
                p_k, m_k, v_k, rows, vals, bias, **kw), flush)
        else:
            k_ms = time_ms(lambda: fu.adagrad_rows_cuda(
                p_k, a_k, rows, vals, lr=3e-3, eps=1e-10), flush)
            p_ms = time_ms(lambda: fu.adagrad_rows_plain(
                p_k, a_k, rows, vals, lr=3e-3, eps=1e-10), flush)
        b_ms, b_by = bound_ms(n_live * D * 4 * words + N * 4 + 8 * adam,
                              n_live * D * flops)
        out[kernel] = {"route": route, "blocks": blocks,
                       "threads": fu.THREADS, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                       "bound_by": b_by}
    return out


def _cell_lookups(dev, cell="wide_deep", traffic="zipf105.b65536",
                  seed=3200000001):
    """(N,) int32 store rows of one batch of a ``portbench`` cell, made on
    the card by the benchmark's traffic generator from its configuration
    and traffic files, translated by the cell's padded layout."""
    import torch
    from portbench.yardstick import traffic as gen
    from repro_torch.kernels import fused_embedding as fe
    from repro_torch.sharding import policy as pol
    config = json.loads((ROOT / "portbench" / "configs"
                         / f"{cell}.json").read_text())
    tr = json.loads((ROOT / "portbench" / "traffic"
                     / f"{traffic}.json").read_text())
    rows, H = config["table_rows"], tr["lookups_per_table"]
    batch = gen.criteo_batch(rows, config["n_dense"], tr["batch"], H,
                             float(tr["zipf_alpha"]),
                             gen.generator(seed, gen.DATA_STREAM, dev))
    layout = pol.padded_layout_for_ranges(
        pol.uniform_vocab_ranges(sum(rows), tr["n_ps"]))
    flat = gen.flat_rows(batch["sparse"], rows).to(torch.int32)
    return fe.translate_rows(flat, layout), {
        "cell": f"{cell}.{traffic}", "B": tr["batch"], "T": len(rows),
        "H": H}


def _time_ss(store_idx, H, D, flush):
    """The segment sum on the bags route for (N,) store rows ``store_idx``
    and random (N / H, D) bag cotangents: held bit for bit against its
    plain version (``g_bags[order // H]``, then ``torch.segment_reduce``)
    and timed beside it and beside the library path it replaced (the
    (N, D) copy of the expanded cotangent, the sorted gather, then
    ``segment_reduce``). Bound: the longest segment's chain of dependent
    adds at 4 cycles an add and the card's largest SM clock, or bytes
    (``order``, the segment ends and the bag cotangents read once, the
    ``n_uniq`` summed rows written) at 3.35 TB/s."""
    import torch
    from repro_torch.kernels import fused_embedding as fe
    dev = store_idx.device
    N = store_idx.shape[0]
    gen = torch.Generator(device=dev).manual_seed(D)
    g_bags = torch.randn((N // H, D), generator=gen, device=dev)
    _, order = torch.sort(store_idx, stable=True)
    _, counts = torch.unique_consecutive(store_idx[order],
                                         return_counts=True)
    n_uniq = counts.shape[0]
    vals = torch.zeros((N, D), device=dev)

    def ours():
        fe.segment_sum_cuda(order, counts, g_bags, H, vals, "bags")

    def plain():
        return torch.segment_reduce(g_bags[order // H], "sum",
                                    lengths=counts, axis=0)

    def library():
        g_rows = g_bags[:, None, :].expand(N // H, H, D).reshape(N, D)
        return torch.segment_reduce(g_rows[order], "sum", lengths=counts,
                                    axis=0)

    ours()
    check(torch.equal(vals[:n_uniq], plain())
          and torch.equal(vals[:n_uniq], library())
          and not vals[n_uniq:].any(),
          f"SS at D={D}, N={N}: the kernel's sums differ from "
          "segment_reduce's")
    k_ms = time_ms(ours, flush)
    p_ms = time_ms(plain, flush)
    l_ms = time_ms(library, flush)
    longest = int(counts.max())
    chain_ms = longest * 4 / (_max_sm_mhz() * 1e3)
    n_bytes = 8 * N + 8 * n_uniq + 4 * D * (N // H + n_uniq)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": max(chain_ms, bytes_ms),
            "bound_by": "add chain" if chain_ms >= bytes_ms else "bytes",
            "chain_ms": chain_ms, "bytes_ms": bytes_ms, "bytes": n_bytes,
            "N": N, "n_uniq": n_uniq, "longest": longest}


def _max_sm_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return float(out.stdout.strip().splitlines()[0])


def _device_summary(prof, wall_us, n_steps, top):
    """Per-step device time, idle share and the ``top`` kernels by device
    time from a ``torch.profiler`` run of ``n_steps`` steps that took
    ``wall_us``; also returns the (name, us, calls) device events."""
    import torch
    device = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or evt.key in TRAIN_RANGES:      # annotations, not kernels
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        device.append((evt.key, us, evt.count))
    busy_us = sum(us for _, us, _ in device)
    ranked = sorted(device, key=lambda x: -x[1])[:top]
    return {
        "steps": n_steps, "wall_ms_per_step": wall_us / n_steps / 1e3,
        "device_ms_per_step": busy_us / n_steps / 1e3,
        "device_idle_share": (1 - busy_us / wall_us) if device else None,
        "device_events_per_step": sum(c for *_, c in device) / n_steps,
        "top_device_time": [
            {"name": k[:90], "ms_per_step": us / n_steps / 1e3,
             "calls_per_step": c / n_steps} for k, us, c in ranked],
    }, device


# the main path's kernels in the fused adagrad step, by fragments of the
# names the profiler gives them
PROFILED_KERNELS = {
    "K1 D=16": ("bag_vec16_kernel",),
    "K1 D=1": ("bag_wide_kernel",),
    "K2 D=16": ("rows_vec16_kernel", "AdagradOp"),
    "K2 D=1": ("rows_wide_kernel", "AdagradOp"),
    "SS": ("segment_sum_",),
}


def phase_profile(report, dev, run, n_steps=10, kernels=PROFILED_KERNELS,
                  tag="phase 6", key="profile"):
    """Where the fused step's time goes (phase 6: adagrad; phase 17 (d):
    adam): ``torch.profiler`` over ``n_steps`` steps of ``run``'s step with
    batches already on the card, ``kernels`` found by name. Device time is
    the sum of the CUDA kernel and copy events (one stream, so they do not
    overlap); the idle share is 1 - device time / wall time, with the
    profiler's own host overhead included in the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.synthetic import criteo_batch
    from repro_torch.launch import train as launch
    from repro_torch.train import trainer

    cfg = run.cfg
    step = trainer.make_dlrm_train_step(cfg, run.opt, plan=run.plan)
    batches = [launch.to_device(criteo_batch(cfg, launch.DATA_SEED, ids), dev)
               for ids in list(launch.sample_order(23, cfg.batch_size))[20:]]
    state = clone_state(run.state, dev)
    for b in batches:                                  # warm-up
        state, _ = step(state, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            state, _ = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    info, device = _device_summary(prof, wall_us, n_steps, top=10)
    report[key] = info
    check(device, f"{tag}: torch.profiler showed no device events")
    per_call = {}
    for label, fragments in kernels.items():
        hits = [(us, c) for k, us, c in device
                if all(f in k for f in fragments)]
        check(hits, f"{tag}: {label} ({' + '.join(fragments)}) is not in "
              "the profiled step")
        calls = sum(c for _, c in hits)
        per_call[label] = {"us_per_call": sum(us for us, _ in hits) / calls,
                           "calls_per_step": calls / n_steps}
    info["kernel_us_per_call"] = per_call
    log(f"{tag} profile: {info['wall_ms_per_step']:.3f} ms/step wall "
        f"(profiler on), {info['device_ms_per_step']:.3f} ms/step on the "
        f"device, idle share {info['device_idle_share']:.3f}, "
        f"{info['device_events_per_step']:.0f} device events/step")
    for label, v in per_call.items():
        log(f"  {label}: {v['us_per_call']:.2f} us per call, "
            f"{v['calls_per_step']:.0f} per step")
    for t in info["top_device_time"]:
        log(f"  {t['ms_per_step']:.4f} ms x{t['calls_per_step']:.0f} "
            f"{t['name']}")
    return info


# ---------------------------------------------------------------------------
# live re-planning, layout-stamped checkpoints and elastic resume
# ---------------------------------------------------------------------------
REPLAN_FLAGS = SLICE_FLAGS + ["--fused-update", "--ckpt-every", "5"]


def _probe(cfg, dev, remapper=None):
    """A raw batch past the launcher's first 20 (sample ids of batch 21) on
    the card, through ``remapper`` when one is given."""
    from repro_torch.data.synthetic import criteo_batch
    from repro_torch.launch import train as launch
    ids = list(launch.sample_order(21, cfg.batch_size))[20]
    raw = criteo_batch(cfg, launch.DATA_SEED, ids)
    if remapper is not None:
        raw = remapper.remap_batch(raw)
    return launch.to_device(raw, dev)


def _loss(params, batch, cfg, plan):
    import torch
    from repro_torch.models.dlrm import dlrm_loss
    with torch.no_grad():
        return float(dlrm_loss(params, batch, cfg, plan))


def _sync_s(fn):
    """Wall seconds of ``fn()`` ending in a device synchronise; returns
    (result, seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_replan(report, dev, steps_per_s_plain):
    """Phase 12: the re-plan/resume path of the launcher at full width, the
    re-planning API bit for bit, K1 under the post-re-plan plan, and the
    ``replan`` timing line."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core.flash_checkpoint import FlashCheckpoint
    from repro_torch.core.sharding_service import HotTableTracker
    from repro_torch.data.synthetic import criteo_batch
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import fused_embedding as fe
    from repro_torch.launch import train as launch
    from repro_torch.models.dlrm import _pool2d
    from repro_torch.sharding import policy as pol
    from repro_torch.train import elastic, replan, trainer

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="replan_ckpt_", dir=ROOT / "build"))
    info = {}
    try:
        # 1. the launcher: 20 steps, a re-plan polled every 10, blobs every 5
        ck = str(tmp / "run")
        log("phase 12 replan: 20 steps, --replan-every 10, --ckpt-every 5")
        run, counts = _driven(
            REPLAN_FLAGS + ["--steps", "20", "--replan-every", "10",
                            "--ckpt-dir", ck],
            ("fused_embedding_bag", "adagrad_row_update"))
        check([d.observed_at for d in run.decisions] == [10],
              f"re-plans at {[d.observed_at for d in run.decisions]}, "
              "not one at step 10")
        decision = run.decisions[0]
        # 2 of each per step, every step: so also the 10 after the re-plan
        for k in ("fused_embedding_bag", "adagrad_row_update"):
            check(counts[k] == 2 * 20, f"{k}: {counts[k]} launches in 20 "
                  "steps, not 2 per step")
        check(run.exactly_once, "the 20-step run lost exactly-once coverage")
        check(run.layout == pol.padded_layout_for_ranges(
            decision.vocab_ranges), "the run did not end on the re-plan's "
              "padded ranges")
        blobs = FlashCheckpoint(ck).valid_steps()
        check(blobs == [15, 20], f"blobs on disk: {blobs}, not [15, 20]")
        info["run"] = {
            "losses": run.losses, "counts": counts, "blobs": blobs,
            "steps_per_s": len(run.losses) / run.seconds,
            "replan_at": decision.observed_at,
            "imbalance": [decision.imbalance_before,
                          decision.imbalance_after],
            "cache_rows": sum(decision.table_hot),
            "rows_per_shard": list(run.layout.shard_sizes),
            "max_range": run.layout.max_range}

        # 2. resume in the same directory: the stamped plan and layout
        log("phase 12 replan: --resume, 5 steps")
        res_run, res_counts = _driven(
            REPLAN_FLAGS + ["--steps", "5", "--replan-every", "10",
                            "--ckpt-dir", ck, "--resume"],
            ("fused_embedding_bag", "adagrad_row_update"))
        check(res_run.restored_step == 20 and res_run.state["step"] == 25,
              f"resumed from {res_run.restored_step} to step "
              f"{res_run.state['step']}, not 20 to 25")
        check(res_run.layout == run.layout and res_run.plan == run.plan,
              "--resume did not come back on the stamped plan and layout")
        check(res_run.exactly_once, "the resumed run lost coverage")
        info["resume"] = {"losses": res_run.losses, "counts": res_counts}
        del res_run
        shutil.rmtree(ck)

        # adam: K3 after a re-plan at step 5
        log("phase 12 replan: adam, 10 steps, --replan-every 5")
        adam_run, adam_counts = _driven(
            REPLAN_FLAGS + ["--optimizer", "adam", "--steps", "10",
                            "--replan-every", "5"],
            ("fused_embedding_bag", "adam_row_update"))
        check([d.observed_at for d in adam_run.decisions] == [5],
              f"adam re-plans at {[d.observed_at for d in adam_run.decisions]}")
        check(adam_counts["adam_row_update"] == 2 * 10,
              f"K3: {adam_counts['adam_row_update']} launches in 10 steps")
        info["adam"] = {"losses": adam_run.losses, "counts": adam_counts}
        del adam_run

        # launcher steps/s with --replan-every and no checkpoints
        replan_only, _ = _driven(
            SLICE_FLAGS + ["--fused-update", "--steps", "20",
                           "--replan-every", "10"],
            ("fused_embedding_bag", "adagrad_row_update"))
        steps_per_s_replan = len(replan_only.losses) / replan_only.seconds
        del replan_only

        # 3. the API from the state at step 10 (the run's own, recomputed:
        # the launcher and the step are deterministic) and the decision
        s10_run, _ = _driven(SLICE_FLAGS + ["--fused-update", "--steps", "10"],
                             ("fused_embedding_bag", "adagrad_row_update"))
        cfg, opt, old_plan = s10_run.cfg, s10_run.opt, s10_run.plan
        state = s10_run.state
        del s10_run
        remapper = replan.EmbeddingRemapper(cfg.table_rows)
        ckpt = FlashCheckpoint(str(tmp / "api"), keep=2)
        _, save_s = _sync_s(lambda: replan.save_with_layout(
            ckpt, state, 10, remapper, layout=old_plan.layout))
        ckpt.wait()
        persist_s = ckpt.last_persist_seconds
        probe = _probe(cfg, dev)
        loss_old = _loss(state["params"], probe, cfg, old_plan)
        res, apply_s = _sync_s(lambda: replan.apply_replan(
            state, cfg, opt, decision, remapper=remapper,
            layout=old_plan.layout, plan=old_plan))
        probe_new = _probe(cfg, dev, remapper)
        loss_new = _loss(res.state["params"], probe_new, cfg, res.plan)
        check(loss_new == loss_old, f"forward loss across the re-plan: "
              f"{loss_new!r} vs {loss_old!r}")
        # the post-re-plan stamped blob, before the step below updates the
        # pools in place
        replan.save_with_layout(ckpt, res.state, 11, remapper,
                                decision.table_hot, decision.vocab_ranges,
                                layout=res.layout)
        ckpt.wait()

        # 4. K1 under the post-re-plan plan: measured cache, unequal ranges
        k1_ulp = 0
        for key in ("tables", "wide"):
            pool = _pool2d(res.state["params"][key], res.layout)
            for combiner in ("sum", "mean", "max"):
                plan = res.plan.with_combiner(combiner)
                enc, cache = fe.kernel_inputs(pool, probe_new["sparse"], plan)
                got = fe.embedding_bag_cuda(pool, enc, None, cache, combiner)
                want = fe.embedding_bag_plain(pool, enc, None, cache,
                                              combiner)
                torch.cuda.synchronize()
                u = ulp_distance(got, want)
                k1_ulp = max(k1_ulp, u)
                check(u <= K1_ULP, f"K1 after the re-plan, {key} "
                      f"{combiner}: {u} ULP > {K1_ULP}")

        # one fused adagrad step under each plan
        cuda_lib.reset_launches()
        s_new, m_new = res.step_fn(res.state, probe_new)
        torch.cuda.synchronize()
        new_counts = dict(cuda_lib.LAUNCHES)
        for k in ("fused_embedding_bag", "adagrad_row_update"):
            check(new_counts[k] == 2, f"{k}: {new_counts[k]} launches in a "
                  "step under the re-planned plan")
        step_old = trainer.make_dlrm_train_step(cfg, opt, plan=old_plan)
        s_old, m_old = step_old(state, probe)
        check(float(m_new["loss"]) == float(m_old["loss"]),
              f"step loss {float(m_new['loss'])!r} vs "
              f"{float(m_old['loss'])!r}")
        check(torch.equal(s_new["params"]["mlp.w0"],
                          s_old["params"]["mlp.w0"]), "mlp.w0 differs")
        inv = torch.as_tensor(np.argsort(decision.permutation), device=dev)
        for key in ("tables", "wide"):
            for tree in ("params", "opt"):
                a = s_new[tree] if tree == "params" else s_new[tree]["acc"]
                b = s_old[tree] if tree == "params" else s_old[tree]["acc"]
                check(torch.equal(res.layout.unpad_rows(a[key]),
                                  old_plan.layout.unpad_rows(b[key])[inv]),
                      f"{tree} {key} differ after the inverse permutation")
        del s_new, s_old, state, res

        # restore_on_plan of the pre-re-plan snapshot, from disk
        ckpt.drop_memory_tier()
        (_, _, _, _, _, _), restore_s = _sync_s(
            lambda: replan.restore_with_layout(cfg, opt, ckpt, step=10,
                                               device=dev))
        st2, restored, _, _, rm2 = replan.restore_on_plan(
            cfg, opt, "adagrad", ckpt, decision, device=dev, step=10,
            plan=old_plan)
        check(restored == 10, f"restore_on_plan restored step {restored}")
        probe2 = _probe(cfg, dev, rm2)
        loss_restored = _loss(st2["params"], probe2, cfg,
                              old_plan.with_replan(decision.table_hot,
                                                   pol.padded_layout_for_ranges(
                                                       decision.vocab_ranges)))
        check(loss_restored == loss_old, f"restore_on_plan loss "
              f"{loss_restored!r} vs {loss_old!r}")
        del st2
        # the post-re-plan stamped blob onto 2 PS shards
        st3, _, rm3, hot3, _, lay3 = elastic.resume_dlrm_stamped(
            cfg, opt, ckpt, device=dev, onto_n_ps=2, step=11)
        check(lay3.n_ps == 2 and hot3 == decision.table_hot,
              f"resume_dlrm_stamped: n_ps {lay3.n_ps}, hot {hot3}")
        probe3 = _probe(cfg, dev, rm3)
        loss_n2 = _loss(st3["params"], probe3, cfg,
                        old_plan.with_replan(hot3, lay3))
        check(loss_n2 == loss_old, f"resume onto n_ps=2: loss {loss_n2!r} "
              f"vs {loss_old!r}")
        del st3

        # the tracker's host cost per batch at full width
        tracker = HotTableTracker(cfg.table_rows, n_ps=4, hot_budget=64)
        batches = [criteo_batch(cfg, launch.DATA_SEED, ids)["sparse"]
                   for ids in launch.sample_order(10, cfg.batch_size)]
        t0 = time.perf_counter()
        for sp in batches:
            tracker.observe(sp)
        observe_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    line = {
        "card": nvidia_smi_line(),
        "apply_replan_ms": apply_s * 1e3,
        "save_with_layout_memory_ms": save_s * 1e3,
        "persist_s": persist_s, "restore_with_layout_s": restore_s,
        "observe_ms_per_batch": observe_ms,
        "launcher_steps_per_s": {"plain": steps_per_s_plain,
                                 "replan_every_10": steps_per_s_replan,
                                 "replan_and_ckpt": info["run"][
                                     "steps_per_s"]},
        "replan_at": decision.observed_at,
        "imbalance": info["run"]["imbalance"],
        "cache_rows": info["run"]["cache_rows"],
        "rows_per_shard": info["run"]["rows_per_shard"],
        "k1_max_ulp_after_replan": k1_ulp}
    info["line"] = line
    report["replan"] = info
    log(f"phase 12 replan: re-plan at step {decision.observed_at} "
        f"(imbalance {line['imbalance'][0]:.3f} -> "
        f"{line['imbalance'][1]:.3f}, {line['cache_rows']} cache rows, "
        f"rows/shard {line['rows_per_shard']}); resume, restore_on_plan, "
        f"n_ps=2 and one step bit-identical; K1 {k1_ulp} ULP; apply "
        f"{line['apply_replan_ms']:.1f} ms, save {save_s * 1e3:.1f} ms, "
        f"persist {persist_s:.2f} s, restore {restore_s:.2f} s, observe "
        f"{observe_ms:.2f} ms/batch")
    return line


# ---------------------------------------------------------------------------
# the self-healing layer: supervisor, fault injection, job master, workers
# ---------------------------------------------------------------------------
SELFHEAL_STEPS = 30
SELFHEAL_CKPT_EVERY = 5
# ps_loss@22 is the crash after the corruption: it is what makes the
# restore fall back past the damaged step-20 blob to step 15
SELFHEAL_CHAOS = "ps_loss@8,hang@13,ckpt_corrupt@17,ps_loss@22"
SELFHEAL_WANT = [                 # (kind, step, detail) besides stragglers
    ("fault_detected", 8, {"fault": "ps_loss"}),
    ("recovered", 5, {"action": "elastic_shrink", "surviving_n_ps": 3,
                      "steps_lost": 3}),
    ("fault_detected", 13, {"fault": "hang"}),
    ("recovered", 10, {"action": "restore", "steps_lost": 3}),
    ("fault_detected", 22, {"fault": "ps_loss"}),
    ("recovered", 15, {"action": "elastic_shrink", "surviving_n_ps": 2,
                       "steps_lost": 7}),
]
SELFHEAL_ADAM = ["--optimizer", "adam", "--steps", "12", "--chaos",
                 "oom@5,oom@9"]
DEADLINE_FACTOR = 4.0         # step deadline over the slowest clean step
PROC_STEPS = 10
PROC_CKPT_EVERY = 3
PROC_HEARTBEAT_S = 8.0
PROC_CELLS = [("base", ""), ("kill_at4", "kill@4"), ("stop_at7", "stop@7"),
              ("killckpt_at3", "kill_ckpt@3")]


# ---------------------------------------------------------------------------
# the resource manager: the lifecycle example and the cloud simulator
# ---------------------------------------------------------------------------
LIFECYCLE_STEPS = 160
# what the reference's control plane gives for the lifecycle's events at
# --steps 160 (executed steps: the failover repeats part of a shard; the
# reference's stage 3 resizes nothing, its synthetic memory feed stays far
# below 16 GB); tests/test_torch_brain.py holds these to the reference
LIFECYCLE_WANT = {
    "steps": 164, "coverage": [True, 40960, 0],
    "stage1": {"w": 2, "p": 1, "cpu_w": 4, "cpu_p": 4, "mem_w": 8.0,
               "mem_p": 16.0},
    "stage2": {"dlrm-100m": {"w": 4, "p": 2, "cpu_w": 2.0, "cpu_p": 4.0,
                             "mem_w": 8.0, "mem_p": 16.0}},
    "stage3": {},
}


def _launched(counts, expect, what):
    """Fail unless every kernel of ``expect`` launched exactly as often as
    ``expect`` says."""
    for kernel, n in expect.items():
        check(counts[kernel] == n, f"{what}: {kernel} launched "
              f"{counts[kernel]} times, not {n}")


def _supervised_run(argv, kernels):
    """One supervised launcher run, counts set to 0 just before it and
    read just after, and the wall time of every completed step attempt.

    Every executed step launches each kernel of ``kernels`` twice (the deep
    and the wide pool), and so does the warm-up step of every step build
    (the start and each recovery); an attempt a fault stopped launches
    nothing."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import train as launch
    from repro_torch.train import supervisor as sup_mod

    times = {}
    observe = sup_mod.Supervisor._observe_step_time

    def record(self, gstep, dt):
        times[gstep] = dt             # the step's last completed attempt
        observe(self, gstep, dt)

    sup_mod.Supervisor._observe_step_time = record
    cuda_lib.reset_launches()
    try:
        run = launch.main(argv)
    finally:
        sup_mod.Supervisor._observe_step_time = observe
    counts = dict(cuda_lib.LAUNCHES)
    rep = run.report
    n_faults = sum(e.kind == "fault_detected" for e in rep.events)
    runs = rep.step_attempts - n_faults + 1 + rep.restarts
    _launched(counts, {k: 2 * runs for k in kernels}, f"{argv}")
    losses = [run.job.losses[s] for s in sorted(run.job.losses)]
    check(rep.completed and rep.final_step == int(argv[argv.index(
        "--steps") + 1]), f"supervised run did not complete: {rep}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    return run, counts, times


def _events(rep):
    return [(e.kind, e.step, e.detail) for e in rep.events
            if e.kind != "straggler_detected"]


def _stragglers(rep, ckpt_every):
    """Straggler events, each with whether its step wrote a checkpoint."""
    return [{"step": e.step, "step_time_s": e.detail["step_time_s"],
             "ewma_s": e.detail["ewma_s"],
             "checkpoint_step": (e.step + 1) % ckpt_every == 0}
            for e in rep.events if e.kind == "straggler_detected"]


def _supervision(rep):
    lat = rep.recovery_latencies_s
    return {"restarts": rep.restarts, "steps_lost": rep.steps_lost,
            "step_attempts": rep.step_attempts,
            "productive_steps": rep.productive_steps,
            "goodput": rep.goodput_fraction, "wall_s": rep.wall_seconds,
            "recovery_latencies_s": lat,
            "recovery_latency_mean_s": sum(lat) / len(lat) if lat else 0.0}


def phase_selfheal(report, dev):
    """Phase 13: the self-healing layer at full width in process (clean,
    chaos and OOM-degraded supervised runs through the launcher) and the
    job master's worker processes on the card; the ``selfheal`` line."""
    import shutil
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="selfheal_", dir=ROOT / "build"))
    flags = SLICE_FLAGS + ["--fused-update", "--n-ps", "4", "--ckpt-every",
                           str(SELFHEAL_CKPT_EVERY)]
    adagrad = ("fused_embedding_bag", "adagrad_row_update")
    try:
        # (a) clean: the step + checkpoint times the deadline is chosen from
        log(f"phase 13 selfheal: clean supervised run, {SELFHEAL_STEPS} "
            "steps")
        clean, c_clean, times = _supervised_run(
            flags + ["--steps", str(SELFHEAL_STEPS), "--supervise",
                     "--ckpt-dir", str(tmp / "clean")], adagrad)
        check(clean.report.restarts == 0, "the clean run restarted")
        batch = clean.job.cfg.batch_size
        ckpt_steps = [s for s in times
                      if (s + 1) % SELFHEAL_CKPT_EVERY == 0]
        plain = sorted(t for s, t in times.items() if s not in ckpt_steps)
        step_s = plain[len(plain) // 2]
        ckpt_step_s = max(times[s] for s in ckpt_steps)
        deadline = round(DEADLINE_FACTOR * max(times.values()), 3)
        clean_info = {
            **_supervision(clean.report), "step_s_median": step_s,
            "ckpt_step_s_max": ckpt_step_s,
            "ckpt_save_memory_s": clean.job.ckpt.last_save_seconds,
            "ckpt_persist_s": clean.job.ckpt.last_persist_seconds,
            "stragglers": _stragglers(clean.report, SELFHEAL_CKPT_EVERY),
            "launches": c_clean}
        shutil.rmtree(tmp / "clean")

        # (a) the same run under PS loss, a hang and a corrupted blob
        log(f"phase 13 selfheal: chaos {SELFHEAL_CHAOS}, step deadline "
            f"{deadline} s")
        chaos, c_chaos, _ = _supervised_run(
            flags + ["--steps", str(SELFHEAL_STEPS), "--chaos",
                     SELFHEAL_CHAOS, "--step-deadline", str(deadline),
                     "--ckpt-dir", str(tmp / "chaos")], adagrad)
        got = _events(chaos.report)
        check(len(got) == len(SELFHEAL_WANT) and all(
            g[:2] == w[:2] and all(g[2].get(k) == v for k, v in w[2].items())
            for g, w in zip(got, SELFHEAL_WANT)),
            f"chaos events {got}, not {SELFHEAL_WANT}")
        check(chaos.job.n_ps == 2, f"ended on {chaos.job.n_ps} PS shards")
        check(any(e["kind"] == "corrupt_blob_fallback"
                  for e in chaos.job.ckpt.events),
              "no fall-back past the corrupted blob")
        check(chaos.job.losses == clean.job.losses,
              "the recovered trajectory differs from the clean one: "
              f"{chaos.job.losses} vs {clean.job.losses}")
        chaos_info = {**_supervision(chaos.report), "plan": SELFHEAL_CHAOS,
                      "deadline_s": deadline,
                      "events": [list(e) for e in got],
                      "stragglers": _stragglers(chaos.report,
                                                SELFHEAL_CKPT_EVERY),
                      "launches": c_chaos}
        shutil.rmtree(tmp / "chaos")

        # (a) adam under two OOMs: the degradation ladder, K1 without cache
        log("phase 13 selfheal: adam under oom@5,oom@9")
        adam, c_adam, _ = _supervised_run(
            flags + SELFHEAL_ADAM + ["--ckpt-dir", str(tmp / "adam")],
            ("fused_embedding_bag", "adam_row_update"))
        actions = [e.detail.get("action") for e in adam.report.events
                   if e.kind == "recovered"]
        half = batch // 2                 # 256 at full width
        check(actions == ["drop_hot_cache", f"shrink_batch_to_{half}"]
              and adam.job.cfg.batch_size == half
              and adam.job.cfg.hot_rows_k == 0,
              f"OOM ladder: {actions}, batch {adam.job.cfg.batch_size}")
        check(adam.report.steps_lost == 0,
              f"OOM recovery lost {adam.report.steps_lost} steps")
        adam_info = {**_supervision(adam.report), "actions": actions,
                     "launches": c_adam}
        shutil.rmtree(tmp / "adam")
        chaos_timings = chaos.report.measured_timings()
        del clean, chaos, adam

        # (b) worker processes on the card under the job master, together
        log("phase 13 selfheal: job master, workers " +
            ", ".join(f"{n} ({c or 'no fault'})" for n, c in PROC_CELLS))
        proc_info, proc_timings = _proc_cells(tmp, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = {
        "card": nvidia_smi_line(),
        "supervised": {"arch": "wide_deep", "full": True,
                       "steps": SELFHEAL_STEPS,
                       "ckpt_every": SELFHEAL_CKPT_EVERY,
                       "clean": clean_info, "chaos": chaos_info,
                       "adam": adam_info},
        "process": proc_info}
    report["selfheal"] = line
    log(f"phase 13 selfheal: chaos bit-exact ({chaos_info['restarts']} "
        f"restarts, {chaos_info['steps_lost']} steps lost, goodput "
        f"{chaos_info['goodput']:.3f}, recovery "
        f"{chaos_info['recovery_latencies_s']} s); clean step "
        f"{step_s * 1e3:.1f} ms, checkpoint step {ckpt_step_s:.2f} s; "
        f"stragglers {[s['step'] for s in chaos_info['stragglers']]}; "
        f"re-exec {proc_info['reexec_latencies_s']} s, restore "
        f"{proc_info['restore_latencies_s']} s")
    counts = {k: c_clean[k] + c_chaos[k] + c_adam[k] for k in c_clean}
    return line, counts, (chaos_timings, proc_timings)


def _final_launches(spec, incarnation):
    """The launch counts the worker's last incarnation printed on exit."""
    text = (Path(spec.workdir) / f"{spec.name}.{incarnation}.log").read_text()
    found = [ln for ln in text.splitlines() if ln.startswith("launches ")]
    check(found, f"{spec.name}: no launch counts in its log")
    return json.loads(found[-1][len("launches "):])


def _proc_cells(tmp, dev):
    """Baseline and kill cells as workers of one job master on the card:
    each cell's merged loss log equals the baseline's to the ulp."""
    from repro_torch.train.job_master import (JobMaster, JobMasterConfig,
                                              WorkerSpec)

    specs = [WorkerSpec(name=name, workdir=str(tmp / "proc"),
                        ckpt_dir=str(tmp / "proc" / f"ckpt_{name}"),
                        steps=PROC_STEPS, ckpt_every=PROC_CKPT_EVERY,
                        n_ps=4, padded=True, chaos_proc=chaos,
                        device=dev.type)
             for name, chaos in PROC_CELLS]
    master = JobMaster(specs, JobMasterConfig(
        heartbeat_deadline_s=PROC_HEARTBEAT_S, run_deadline_s=300.0))
    report = master.run()
    check(report.completed, f"job master: {report.events}")
    for ev in master.events:
        if ev.kind == "spawned":
            try:
                os.killpg(ev.detail["pid"], 0)
            except ProcessLookupError:
                continue
            raise SmokeFailure(f"worker group {ev.detail['pid']} left alive")

    def merged(spec):
        best = {}
        for rec in sorted(spec.read_losses(),
                          key=lambda r: r["incarnation"]):
            best[rec["step"]] = rec["loss"]
        return [best[s] for s in sorted(best)]

    base = merged(specs[0])
    check(len(base) == PROC_STEPS and all(map(math.isfinite, base)),
          f"baseline losses {base}")
    check(report.exit_history["base"] == [0], "the baseline was re-exec'd")
    latencies, launches = {}, {}
    for spec in specs:
        history = report.exit_history[spec.name]
        if spec.chaos_proc:
            check(history[-1] == 0 and len(history) >= 2 and all(
                rc == -9 for rc in history[:-1]),
                f"{spec.name}: exits {history}")
            check(merged(spec) == base, f"{spec.name}: losses "
                  f"{merged(spec)} vs baseline {base}")
        latencies[spec.name] = [
            ev.detail["reexec_latency_s"] for ev in master.events
            if ev.kind == "reexec_ready" and ev.worker == spec.name]
        launches[spec.name] = _final_launches(spec, len(history) - 1)
        check(launches[spec.name]["fused_embedding_bag"] > 0,
              f"{spec.name}: K1 never launched in the worker")
    return {"cells": dict(PROC_CELLS), "steps": PROC_STEPS,
            "heartbeat_deadline_s": PROC_HEARTBEAT_S,
            "exit_history": report.exit_history, "reexecs": report.reexecs,
            "reexec_latencies_s": latencies,
            "restore_latencies_s": report.restore_latencies_s,
            "wall_s": report.wall_seconds,
            "final_incarnation_launches": launches}, \
        report.measured_timings()


def _load_lifecycle_example():
    """``examples/elastic_dlrm_train_torch.py`` as a module."""
    import importlib.util
    path = ROOT / "examples" / "elastic_dlrm_train_torch.py"
    spec = importlib.util.spec_from_file_location("elastic_dlrm_train_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def phase_lifecycle(report):
    """Phase 14 (a): the lifecycle example at its full config on the card,
    counts set to 0 just before it and read just after."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.kernels import cuda_lib

    ex = _load_lifecycle_example()
    cfg = ex.build_cfg()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="lifecycle_", dir=ROOT / "build")
    log(f"phase 14 lifecycle: examples/elastic_dlrm_train_torch.py --steps "
        f"{LIFECYCLE_STEPS} --device cuda")
    try:
        t0 = time.perf_counter()
        cuda_lib.reset_launches()
        lc = ex.run_lifecycle(cfg, steps=LIFECYCLE_STEPS,
                              device="cuda", ckpt_dir=tmp,
                              log=lambda msg: log("  " + msg))
        counts = dict(cuda_lib.LAUNCHES)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = {"steps": len(lc.losses), "coverage": list(lc.coverage),
           "stage1": dataclasses.asdict(lc.stage1_plan),
           "stage2": {k: dataclasses.asdict(v)
                      for k, v in lc.stage2_plans.items()},
           "stage3": dict(lc.stage3_scaled)}
    check(got == LIFECYCLE_WANT, f"lifecycle: {got}, the reference's "
          f"control plane gives {LIFECYCLE_WANT}")
    check(len(lc.brain.config_db) == 1,
          f"config DB holds {len(lc.brain.config_db)} records, not 1")
    check(all(math.isfinite(x) for x in lc.losses), "non-finite loss")
    last10 = float(np.mean(lc.losses[-10:]))
    check(last10 < lc.losses[0],
          f"loss did not fall: {lc.losses[0]} -> {last10}")
    check(0.5 < lc.auc <= 1.0, f"AUC {lc.auc}")
    # K1 on both pools in every executed step and in the eval; the dense
    # path's adagrad is plain, so nothing else launches
    _launched(counts, {"fused_embedding_bag": 2 * len(lc.losses) + 2,
                       "adagrad_row_update": 0, "adam_row_update": 0,
                       "flash_attention": 0, "decode_attention": 0},
              "lifecycle")
    steps_s = sorted(lc.step_seconds)
    line = {
        "card": nvidia_smi_line(), "config": cfg.name,
        "pooled_rows": cfg.total_embedding_rows,
        "batch": cfg.batch_size, "steps_arg": LIFECYCLE_STEPS,
        "steps": len(lc.losses), "coverage": list(lc.coverage),
        "stage1": got["stage1"], "stage2": got["stage2"],
        "stage3": got["stage3"], "first_loss": lc.losses[0],
        "last10_loss": last10, "auc": lc.auc,
        "launcher_steps_per_s": len(lc.losses) / lc.seconds,
        "step_ms_median": steps_s[len(steps_s) // 2] * 1e3,
        "step_ms_max": steps_s[-1] * 1e3,
        "peak_mem_gib": lc.peak_mem_bytes / 2**30,
        "ckpt_save_memory_s": lc.ckpt_save_s,
        "ckpt_persist_s": lc.ckpt_persist_s,
        "throughput_samples_per_s": lc.throughput, "wall_s": wall,
        "launches": counts}
    report["lifecycle"] = line
    log(f"phase 14 lifecycle: {len(lc.losses)} steps, "
        f"{line['launcher_steps_per_s']:.2f} steps/s, median step "
        f"{line['step_ms_median']:.2f} ms, peak {line['peak_mem_gib']:.2f} "
        f"GiB, checkpoint {lc.ckpt_save_s:.2f} s memory / "
        f"{lc.ckpt_persist_s:.2f} s disk, AUC {lc.auc:.4f}, K1 "
        f"{counts['fused_embedding_bag']} launches, {wall:.1f} s")
    return line


SIM_JOBS = 10                     # the first jobs of the port's trace copy
SIM_KW = dict(total_cpu=2048.0, total_mem_gb=16384.0, horizon_s=6 * 3600.0,
              seed=3, failure_seed=77, amplitude=0.15)
SIM_SCHEDULERS = ("dlrover_rm", "static_user")


def _sim_replay(task):
    """One replay of the trace slice (in a worker process): its summary,
    its event log and the host seconds it took."""
    scheduler, timings_kw = task
    from repro_torch.core.migration import MigrationTimings
    from repro_torch.sim.cluster import TIMINGS
    from repro_torch.sim.replay import replay, summarize
    from repro_torch.sim.trace import (default_trace_path, load_trace,
                                       trace_to_jobs)
    jobs = trace_to_jobs(load_trace(default_trace_path()), seed=3)[:SIM_JOBS]
    timings = (TIMINGS if timings_kw is None
               else MigrationTimings(**timings_kw))
    t0 = time.perf_counter()
    res = replay(jobs, scheduler, timings=timings, **SIM_KW)
    downtime = sum(r.downtime_s for r in res.records)
    return summarize(res), res.event_log(), downtime, \
        time.perf_counter() - t0


def phase_sim(report, selfheal_timings):
    """Phase 14 (b): the card's recovery costs (phase 13) in the cloud
    simulator, each replay in its own process, all at once."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    sup, proc = selfheal_timings
    card = {"flash_ckpt_load_s": sup.flash_ckpt_load_s,
            "worker_reexec_s": proc.worker_reexec_s}
    log(f"phase 14 sim: first {SIM_JOBS} trace jobs, 6 h, seed 3, failure "
        f"seed 77, amplitude 0.15; default timings and the card's {card}")
    tasks = [(name, kw) for name in SIM_SCHEDULERS
             for kw in (None, card, card)]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=len(tasks),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        results = list(pool.map(_sim_replay, tasks))
    wall = time.perf_counter() - t0
    out = {"card": nvidia_smi_line(), "jobs": SIM_JOBS,
           "settings": dict(SIM_KW),
           "card_timings": card, "wall_s": wall, "schedulers": {}}
    for i, name in enumerate(SIM_SCHEDULERS):
        (s_def, log_def, dt_def, t_def), (s_card, log_card, dt_card, t_card), \
            (s_again, log_again, _, t_again) = results[3 * i:3 * i + 3]
        check(s_again == s_card and log_again == log_card,
              f"sim {name}: a second run with the card's timings differs")
        check(s_def["jobs"] == SIM_JOBS and s_card["jobs"] == SIM_JOBS,
              f"sim {name}: {s_def['jobs']} jobs")
        out["schedulers"][name] = {
            "default_timings": s_def, "card_timings": s_card,
            "event_log_lines": [log_def.count("\n") + 1,
                                log_card.count("\n") + 1],
            "event_log_changed_by_timings": log_def != log_card,
            "downtime_s": [dt_def, dt_card],
            "host_s": [t_def, t_card, t_again]}
    report["sim"] = out
    log(f"phase 14 sim: {wall:.1f} s wall; " + "; ".join(
        f"{n} median JCT {v['default_timings']['median_jct_s']:.6g} -> "
        f"{v['card_timings']['median_jct_s']:.6g} s (host "
        f"{max(v['host_s']):.1f} s)" for n, v in out["schedulers"].items()))
    return out


# ---------------------------------------------------------------------------
# the LM slice: llama3.2-3b serving, K4 and K5
# ---------------------------------------------------------------------------
LM_ARCH = "llama3.2-3b"
LM_SEED = 0


def _lm_cfg(**overrides):
    from repro_torch.configs.registry import get_arch
    return dataclasses.replace(get_arch(LM_ARCH), **overrides)


def _randn(gen, shape, dtype, dev):
    import torch
    return torch.randn(shape, generator=gen, device=dev).to(getattr(
        torch, dtype))


def _attn_err(tag, got, want, tol):
    """Max abs difference; fails where ``|got - want|`` passes
    ``atol + rtol * |want|`` for ``tol = (atol, rtol)``."""
    import torch
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{tag}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    g, w = got.float(), want.float()
    atol, rtol = tol
    excess = float(((g - w).abs() - (atol + rtol * w.abs())).max())
    err = float((g - w).abs().max())
    check(excess <= 0, f"{tag}: max abs diff {err:.3g} beyond the "
          f"(abs, rel) bound {tol}")
    return err


def _cache_pos(kind, B, L, dev):
    """cache_pos (B, L) int32 and pos (B,) for a cache layout."""
    import torch
    slots = torch.arange(L, dtype=torch.int32, device=dev)
    if kind == "full":
        cp, pos = slots.expand(B, L), torch.full((B,), L - 1)
    elif kind == "padded":              # 1000 written slots, the rest -1
        cp = torch.where(slots < 1000, slots, -1).expand(B, L)
        pos = torch.full((B,), 999)
    elif kind == "ring":                # row 0 wrapped, row 1 still filling
        wrapped = torch.where(slots < 100, slots + L, slots)
        filling = torch.where(slots < 300, slots, -1)
        cp = torch.stack([wrapped, filling])
        pos = torch.tensor([L + 99, 299])
    elif kind == "empty-row":           # row 1 holds nothing valid
        cp = torch.stack([slots, torch.full_like(slots, -1)])
        pos = torch.tensor([L - 1, L - 1])
    else:
        raise ValueError(kind)
    return (cp.to(torch.int32).contiguous(),
            pos.to(device=dev, dtype=torch.int32))


def phase_lm_kernels(report, dev):
    """K4 and K5 against their plain versions on the card, full-width
    shapes (24 q-heads over 8 kv-heads, D=128)."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(5)
    Hq, Hkv, D = 24, 8, 128
    k4 = [  # dtype, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, q_offset
        ("float32", 1, 2048, 2048, Hq, Hkv, D, True, None, 0.0, 0),
        ("bfloat16", 1, 2048, 2048, Hq, Hkv, D, True, None, 0.0, 0),
        ("bfloat16", 1, 2048, 2048, Hq, Hkv, D, True, 512, 0.0, 0),
        ("float32", 1, 1024, 1024, Hq, Hkv, D, False, None, 30.0, 0),
        ("bfloat16", 1, 1000, 1000, Hq, Hkv, D, True, None, 0.0, 0),  # ragged
        ("float32", 1, 1000, 1000, Hq, Hkv, D, True, None, 0.0, 0),
        ("float32", 1, 256, 1280, Hq, Hkv, D, True, 700, 0.0, 1024),  # q_offset
        ("bfloat16", 1, 512, 64, Hq, Hkv, D, True, 32, 0.0, 0),  # keyless rows
        ("float32", 1, 512, 64, Hq, Hkv, D, True, 32, 0.0, 0),
        # more of the tensor-core route
        ("bfloat16", 2, 2048, 2048, Hq, Hkv, D, True, None, 0.0, 0),
        ("bfloat16", 1, 1024, 1024, Hq, Hkv, D, False, None, 30.0, 0),
        ("bfloat16", 1, 1024, 1024, 16, 4, 64, True, None, 0.0, 0),  # D=64, G=4
        ("bfloat16", 1, 1000, 1000, Hq, Hkv, D, True, 512, 0.0, 0),
    ]
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    rows = []
    for dtype, B, Sq, Skv, Hq_, Hkv_, D_, causal, window, softcap, \
            q_offset in k4:
        q = _randn(gen, (B, Sq, Hq_, D_), dtype, dev)
        k = _randn(gen, (B, Skv, Hkv_, D_), dtype, dev)
        v = _randn(gen, (B, Skv, Hkv_, D_), dtype, dev)
        kw = dict(causal=causal, window=window, softcap=softcap,
                  q_offset=q_offset)
        route = "tensor-core" if fa.tc_route(q, k) else "simt"
        if dtype == "bfloat16":
            check(route == "tensor-core", f"K4 bf16 D={D_} took the SIMT route")
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        tag = (f"K4 {route} {dtype} B={B} Sq={Sq} Skv={Skv} "
               f"heads={Hq_}/{Hkv_} D={D_} {kw}")
        err = _attn_err(tag, got, want, ATTN_TOL[dtype])
        if Skv == 64:
            check(bool((got[:, 96:] == 0).all()),
                  f"{tag}: rows with no valid key are not 0")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        rows.append({"kernel": "K4", "route": route, "case": tag,
                     "max_abs_err": err})
    check(da.split_plan(1, Hkv, 2048) > 1, "K5 does not split at B=1, L=2048")
    k5 = [  # q dtype, cache dtype, B, L, layout, window, softcap
        ("bfloat16", "float32", 1, 2048, "full", None, 0.0),  # the engine
        ("float32", "float32", 1, 2048, "full", None, 0.0),
        ("float32", "float32", 1, 2048, "padded", None, 0.0),  # empty splits
        ("bfloat16", "bfloat16", 8, 4096, "full", None, 30.0),
        ("bfloat16", "float32", 2, 512, "ring", 512, 0.0),
        ("float32", "bfloat16", 2, 2048, "ring", 400, 0.0),
        ("bfloat16", "float32", 2, 256, "empty-row", None, 0.0),
        ("bfloat16", "float32", 2, 2048, "empty-row", None, 0.0),
    ]
    for q_dt, c_dt, B, L, layout, window, softcap in k5:
        q = _randn(gen, (B, 1, Hq, D), q_dt, dev)
        kc = _randn(gen, (B, L, Hkv, D), c_dt, dev)
        vc = _randn(gen, (B, L, Hkv, D), c_dt, dev)
        cp, pos = _cache_pos(layout, B, L, dev)
        kw = dict(window=window, softcap=softcap)
        got = da.decode_attention_cuda(q, kc, vc, cp, pos, **kw)
        want = da.decode_attention_plain(q, kc, vc, cp, pos, **kw)
        torch.cuda.synchronize()
        n_split = da.split_plan(B, Hkv, L)
        tag = (f"K5 q={q_dt} cache={c_dt} B={B} L={L} {layout} {kw} "
               f"n_split={n_split}")
        err = _attn_err(tag, got, want, ATTN_TOL[q_dt])
        if layout == "empty-row":
            check(bool((got[1] == 0).all()), f"{tag}: empty row is not 0")
        errs["decode_attention"] = max(errs["decode_attention"], err)
        rows.append({"kernel": "K5", "case": tag, "n_split": n_split,
                     "max_abs_err": err})
    report["lm_kernels"] = {"cases": rows, "tolerance": ATTN_TOL}
    log(f"phase 7 K4/K5: {len(k4)} K4 and {len(k5)} K5 variants agree with "
        f"the plain versions (max abs err K4 {errs['flash_attention']:.3g}, "
        f"K5 {errs['decode_attention']:.3g}; bounds {ATTN_TOL})")
    return errs


def _profile_decode(params, cfg, dev, n_steps=8, max_len=128):
    """``torch.profiler`` over ``n_steps`` decode steps of the engine's
    shape (batch 1, f32 cache of ``max_len`` slots, 12 tokens in it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import transformer as tf
    cache = tf.init_cache_lm(cfg, 1, max_len, torch.float32, dev)
    toks = torch.arange(3, 15, dtype=torch.int32, device=dev)[None]
    cache, _ = tf.prefill_into_cache(params, cache, toks, cfg)
    tok = torch.full((1, 1), 7, dtype=torch.int32, device=dev)
    for _ in range(3):                                 # warm-up
        logits, cache = tf.decode_step_lm(params, cache, tok, cfg)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            logits, cache = tf.decode_step_lm(params, cache, tok, cfg)
            int(torch.argmax(logits[0, -1]))           # the engine's sync
        wall_us = (time.perf_counter() - t0) * 1e6
    launches = cuda_lib.LAUNCHES["decode_attention"]
    info, device = _device_summary(prof, wall_us, n_steps, top=8)
    info["cache_slots"] = max_len
    k5 = [(us, c) for k, us, c in device if "decode_split_kernel" in k]
    combine = sum(c for k, _, c in device if "decode_combine_kernel" in k)
    records = sum(c for _, c in k5)
    info["k5_ms_per_step"] = sum(us for us, _ in k5) / n_steps / 1e3
    # the wrapper's count is exact; the profiler's activity records are
    # not (runs of this phase saw 2,255-2,257 device records per step, and
    # one run 222 K5 records for 224 launches), so the profiler only bounds
    # the kernels from above and gives their time
    info["k5_kernels_per_step"] = launches / n_steps
    info["k5_profiler_records_per_step"] = records / n_steps
    check(da.split_plan(1, cfg.n_kv_heads, max_len) == 1,
          f"K5 splits a cache of {max_len} slots")
    check(launches == cfg.num_layers * n_steps,
          f"K5 launched {launches} times in {n_steps} decode steps over "
          f"{max_len} slots, not once per layer")
    if device:
        check(combine == 0, f"K5's combine kernel ran {combine} times over "
              f"{max_len} slots")
        check(0 < records <= launches, f"the profiler saw {records} K5 "
              f"kernels for {launches} launches")
    return info


def phase_lm_forward_decode(report, dev):
    """Full-width bf16 ``forward_lm`` against ``prefill_into_cache`` on one
    32-token prompt (K4 counted over the forward), then the decode-step
    profile."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import pad_vocab
    cfg = _lm_cfg()
    t0 = time.perf_counter()
    params = tf.init_lm(cfg, torch.Generator(device=dev).manual_seed(LM_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab_size, (1, 32)).astype(np.int32)).to(dev)
    cuda_lib.reset_launches()
    full, _ = tf.forward_lm(params, toks, cfg)
    torch.cuda.synchronize()
    counts = dict(cuda_lib.LAUNCHES)
    check(counts["flash_attention"] > 0, "K4 never launched by forward_lm")
    cache = tf.init_cache_lm(cfg, 1, 32, torch.float32, dev)
    _, seq = tf.prefill_into_cache(params, cache, toks, cfg)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(full).all() and torch.isfinite(seq).all()),
          "non-finite full-width logits")
    check(full.shape == seq.shape == (1, 32, pad_vocab(cfg.vocab_size)),
          f"logits shapes {tuple(full.shape)} / {tuple(seq.shape)}")
    rel = float((full.float() - seq.float()).abs().max()
                / full.float().abs().max())
    agree = float((full.argmax(-1) == seq.argmax(-1)).float().mean())
    check(rel < FWD_DEC_REL_BF16, f"forward vs decode rel {rel:.3g} >= "
          f"{FWD_DEC_REL_BF16}")
    prof = _profile_decode(params, cfg, dev)
    del params, cache
    torch.cuda.empty_cache()
    info = {"init_s": init_s, "prompt": 32, "rel_max_diff": rel,
            "rel_bound": FWD_DEC_REL_BF16, "argmax_agreement": agree,
            "forward_launches": counts,
            "decode_profile": prof}
    report["lm_forward_decode"] = info
    log(f"phase 8 forward vs decode (full width, bf16, 32 tokens): rel "
        f"{rel:.3g} (bound {FWD_DEC_REL_BF16}), argmax agreement {agree:.3f}"
        f"; K4 launches {counts['flash_attention']}")
    log(f"  decode step (batch 1, 128 f32 slots): "
        f"{prof['wall_ms_per_step']:.3f} ms wall (profiler on), "
        f"{prof['device_ms_per_step']:.3f} ms on the device, idle share "
        f"{prof['device_idle_share']}, K5 {prof['k5_ms_per_step']:.4f} "
        f"ms/step in {prof['k5_kernels_per_step']:.0f} launches "
        f"({prof['k5_profiler_records_per_step']:.3f} profiler records), "
        f"{prof['device_events_per_step']:.0f} device events/step")
    for t in prof["top_device_time"]:
        log(f"  {t['ms_per_step']:.4f} ms x{t['calls_per_step']:.0f} "
            f"{t['name']}")
    return counts, info


def phase_lm_card_cpu(report, dev):
    """Full width cut to 2 layers, f32: the card's logits against the CPU
    plain path from one weight set, over ``forward_lm`` and 8 decode
    steps."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as tf
    cfg = _lm_cfg(num_layers=2, param_dtype="float32",
                  compute_dtype="float32")
    cpu_params = tf.init_lm(cfg, torch.Generator().manual_seed(LM_SEED))
    params = tf.params_to(cpu_params, dev)
    toks = torch.from_numpy(np.random.default_rng(LM_SEED + 1).integers(
        0, cfg.vocab_size, (1, 32)).astype(np.int32))
    rels = {}
    for name in ("forward", "decode"):
        if name == "forward":
            got, _ = tf.forward_lm(params, toks.to(dev), cfg)
            want, _ = tf.forward_lm(cpu_params, toks, cfg)
        else:
            _, got = tf.prefill_into_cache(
                params, tf.init_cache_lm(cfg, 1, 8, torch.float32, dev),
                toks[:, :8].to(dev), cfg)
            _, want = tf.prefill_into_cache(
                cpu_params,
                tf.init_cache_lm(cfg, 1, 8, torch.float32, "cpu"),
                toks[:, :8], cfg)
        got = got.cpu()
        check(bool(torch.isfinite(got).all()), f"non-finite {name} logits")
        rels[name] = float((got - want).abs().max() / want.abs().max())
        check(rels[name] < CARD_CPU_REL, f"card vs CPU {name} logits rel "
              f"{rels[name]:.3g} >= {CARD_CPU_REL}")
    del params, cpu_params
    torch.cuda.empty_cache()
    report["lm_card_cpu"] = {"layers": 2, "dtype": "float32",
                             "rel_max_diff": rels, "rel_bound": CARD_CPU_REL}
    log(f"phase 9 card vs CPU (full width, 2 layers, f32): rel forward "
        f"{rels['forward']:.3g}, decode {rels['decode']:.3g} (bound "
        f"{CARD_CPU_REL})")
    return rels


SERVE_ARGV = ["--arch", LM_ARCH, "--full", "--requests", "8", "--slots", "4",
              "--max-new", "16"]


def phase_lm_serve(report, dev):
    """The serve launcher at full width, K5 counted over the run."""
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import serve
    cuda_lib.reset_launches()
    run = serve.main(SERVE_ARGV)
    counts = dict(cuda_lib.LAUNCHES)
    check(counts["decode_attention"] > 0, f"K5 never launched on {SERVE_ARGV}")
    check(len(run.outputs) == 8 and all(
        len(c.tokens) == 16 and all(0 <= t < run.cfg.vocab_size
                                    for t in c.tokens)
        for c in run.outputs.values()),
        f"serving did not finish 8 requests of 16 tokens: {run.outputs}")
    torch.cuda.empty_cache()
    decode_steps = counts["decode_attention"] // run.cfg.num_layers
    info = {"argv": SERVE_ARGV, "tokens": run.tokens, "seconds": run.seconds,
            "tokens_per_s": run.tokens / run.seconds,
            "engine_steps": run.steps, "decode_steps": decode_steps,
            "ms_per_decode_step": run.seconds / decode_steps * 1e3,
            "launches": counts,
            "k5_launches_per_request": counts["decode_attention"] / 8}
    report["lm_serve"] = info
    log(f"phase 10 serve: {run.tokens} tokens in {run.seconds:.2f} s "
        f"({info['tokens_per_s']:.1f} tok/s), {decode_steps} decode steps "
        f"({info['ms_per_decode_step']:.2f} ms each, prefill included); "
        f"launches {counts}")
    return counts, info


def phase_lm_timing(report, dev, k4_counts, k5_counts, errs):
    """K4 and K5 timed at fixed serving shapes, with plain, SDPA and bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    Hq, Hkv, D = 24, 8, 128
    out = {}

    # K4: B=1, S=2048, causal, bf16 (the tensor-core route)
    B, S = 1, 2048
    q = _randn(gen, (B, S, Hq, D), "bfloat16", dev)
    k = _randn(gen, (B, S, Hkv, D), "bfloat16", dev)
    v = _randn(gen, (B, S, Hkv, D), "bfloat16", dev)
    check(fa.tc_route(q, k), "K4 bf16 D=128 took the SIMT route")
    k_ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True),
                   flush)
    p_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True),
                   flush)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    _attn_err("SDPA yardstick vs K4", lib_out.transpose(1, 2).contiguous(),
              fa.flash_attention_cuda(q, k, v, causal=True), SDPA_TOL)
    l_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), flush)
    pairs = S * (S + 1) // 2
    k4_flops = 4 * D * Hq * B * pairs
    k4_bytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    k4_bound, k4_by = bound_ms(k4_bytes, k4_flops, BF16_FLOP_PER_S)
    del q, k, v, qt, kt, vt, lib_out
    # the SIMT route on f32 inputs of the same shape
    q, k, v = (_randn(gen, (B, S, H, D), "float32", dev)
               for H in (Hq, Hkv, Hkv))
    check(not fa.tc_route(q, k), "K4 f32 took the tensor-core route")
    simt_ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True),
                      flush)
    simt_bound, simt_by = bound_ms(2 * k4_bytes, k4_flops, F32_FLOP_PER_S)
    del q, k, v
    out["k4"] = {"shape": f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal",
                 "ms": k_ms, "plain_ms": p_ms, "sdpa_ms": l_ms,
                 "flops": k4_flops, "bytes": k4_bytes,
                 "tflop_per_s": k4_flops / k_ms / 1e9,
                 "simt_f32_ms": simt_ms, "simt_f32_bound_ms": simt_bound,
                 "simt_f32_tflop_per_s": k4_flops / simt_ms / 1e9}
    kernels = [{
        "name": "K4 flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "launches": k4_counts["flash_attention"],
        "max_abs_err": errs["flash_attention"], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": l_ms,
        "at": out["k4"]["shape"],
        "simt_source": "src/repro_torch/csrc/flash_attention.cu",
        "simt_f32_ms": simt_ms, "simt_f32_bound_ms": simt_bound,
        "simt_f32_bound_by": simt_by}]

    # K5: the engine's bf16 q over an f32 cache, every slot valid
    for B, L in ((1, 2048), (8, 4096)):
        q = _randn(gen, (B, 1, Hq, D), "bfloat16", dev)
        kc = _randn(gen, (B, L, Hkv, D), "float32", dev)
        vc = _randn(gen, (B, L, Hkv, D), "float32", dev)
        cp, pos = _cache_pos("full", B, L, dev)
        k_ms = time_ms(lambda: da.decode_attention_cuda(q, kc, vc, cp, pos),
                       flush)
        p_ms = time_ms(lambda: da.decode_attention_plain(q, kc, vc, cp, pos),
                       flush)
        q32 = q.float().transpose(1, 2).contiguous()
        kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
        mask = ((cp >= 0) & (cp <= pos[:, None]))[:, None, None, :]
        lib_out = F.scaled_dot_product_attention(q32, kt, vt, attn_mask=mask,
                                                 enable_gqa=True)
        _attn_err(f"SDPA yardstick vs K5 B={B} L={L}",
                  lib_out.transpose(1, 2).to(torch.bfloat16).contiguous(),
                  da.decode_attention_cuda(q, kc, vc, cp, pos), SDPA_TOL)
        l_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q32, kt, vt, attn_mask=mask, enable_gqa=True), flush)
        n_valid = int(((cp >= 0) & (cp <= pos[:, None])).sum())
        k5_bytes = (2 * n_valid * Hkv * D * 4 + B * L * 4 + B * 4
                    + 2 * B * Hq * D * 2)
        k5_flops = 4 * n_valid * Hq * D
        k5_bound, k5_by = bound_ms(k5_bytes, k5_flops)
        n_split = da.split_plan(B, Hkv, L)
        tag = (f"B={B} L={L} Hq={Hq} Hkv={Hkv} D={D} q bf16, cache f32, "
               f"n_split={n_split}")
        out[f"k5_B{B}_L{L}"] = {
            "shape": tag, "n_split": n_split, "ms": k_ms, "plain_ms": p_ms,
            "sdpa_ms": l_ms, "bytes": k5_bytes, "bound_ms": k5_bound,
            "bound_by": k5_by, "tb_per_s": k5_bytes / k_ms / 1e9}
        if B == 1:
            kernels.append({
                "name": "K5 decode_attention", "route": "cuda",
                "source": "src/repro_torch/csrc/decode_attention.cu",
                "replaces": "src/repro/kernels/decode_attention.py:23",
                "launches": k5_counts["decode_attention"],
                "max_abs_err": errs["decode_attention"], "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": k5_bound, "bound_by": k5_by,
                "library_ms": l_ms, "at": tag, "n_split": n_split})
        del q, kc, vc, kt, vt, q32, lib_out
    report["lm_timing"] = out
    log(f"phase 11 timing: K4 {out['k4']['ms']:.4f} ms (plain "
        f"{out['k4']['plain_ms']:.3f}, SDPA {out['k4']['sdpa_ms']:.4f}, "
        f"bound {k4_bound:.4f} by {k4_by}; SIMT route on f32 {simt_ms:.4f} "
        f"ms, bound {simt_bound:.4f}); K5 B=1 L=2048 "
        f"{out['k5_B1_L2048']['ms']:.4f} ms (SDPA "
        f"{out['k5_B1_L2048']['sdpa_ms']:.4f}, bound "
        f"{out['k5_B1_L2048']['bound_ms']:.4f}); K5 B=8 L=4096 "
        f"{out['k5_B8_L4096']['ms']:.4f} ms (SDPA "
        f"{out['k5_B8_L4096']['sdpa_ms']:.4f}, bound "
        f"{out['k5_B8_L4096']['bound_ms']:.4f})")
    return kernels


# ---------------------------------------------------------------------------
# phase 15: the rest of the LM zoo (MoE, SSM, hybrid, enc-dec, the other
# dense archs), K4/K5 at head dim 256, ten q-heads per kv-head and
# Whisper's shapes
# ---------------------------------------------------------------------------
ZOO_SEED = 0
ZOO_PROMPT = 32                   # forward vs decode prompt
ZOO_DECODE_STEPS = 8              # timed decode steps after the prompt
ZOO_FULL_DEPTH = ("granite-moe-1b-a400m", "mamba2-2.7b", "recurrentgemma-2b")
# Where bf16 rounding alone moves the logits past FWD_DEC_REL_BF16, the
# forward-vs-decode check runs on the same weights in f32, where the two
# algorithms must agree, against FWD_DEC_REL_F32, and the bf16 numbers
# (with the bf16 forward's distance from the f32 forward) are reported
# beside it. mamba2: its 64 SSM layers with seeded random weights amplify
# bf16 rounding (its bf16 forward is 0.63 rel from its f32 forward; the
# f32 forward and decode agree to 1.5e-4; H100 80GB HBM3, 700 W). The MoE
# archs: a top-k router is discontinuous, and one bf16 rounding of a
# router input between the forward and the decode can swap an expert
# (mixtral, 2 layers: rel 0.27 in bf16)
ZOO_CHECK_F32 = ("granite-moe-1b-a400m", "mamba2-2.7b", "mixtral-8x22b")
FWD_DEC_REL_F32 = 1e-3        # f32 forward vs decode, full width and depth
ZOO_SERVE = ["--full", "--requests", "4", "--slots", "2", "--max-new", "8"]
ZOO_ENCDEC = "whisper-medium"
ZOO_ENCDEC_TOKENS = 16
ZOO_EVAL_ARCH = "recurrentgemma-2b"   # (f): K4 at D=256 in its eval step
ZOO_EVAL_STEPS = 5
# the other five at full width, depth cut where the card's memory or the
# run's time asks for it: gemma3 to one 5-local + 1-global group, the
# 35B/34B dense models and mixtral (4.8 GB of experts per layer; 281 GB in
# all) to 2 layers
ZOO_WIDTH_ONLY = {"minitron-8b": None, "gemma3-27b": 6, "command-r-35b": 2,
                  "chameleon-34b": 2, "mixtral-8x22b": 2}
# card against CPU, f32, one weight set per family, full width; the hybrid
# keeps one whole (recurrent, recurrent, local) group
ZOO_CARD_CPU = {"granite-moe-1b-a400m": 2, "mamba2-2.7b": 2,
                "recurrentgemma-2b": 3, "whisper-medium": 2}


def _zoo_cfg(arch, **overrides):
    from repro_torch.configs.registry import get_arch
    return dataclasses.replace(get_arch(arch), **overrides)


def _n_attn(cfg):
    return sum(k in ("global", "local") for k in cfg.layer_kinds)


def phase_zoo_kernels(report, dev):
    """(a) K4 and K5 at the zoo's new shapes against their plain versions."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(15)
    k4 = [  # dtype, B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset, route
        ("float32", 1, 2048, 2048, 10, 1, 256, True, None, 0, "simt"),
        ("bfloat16", 1, 2048, 2048, 10, 1, 256, True, None, 0,
         "tensor-core"),
        ("float32", 1, 2048, 2048, 10, 1, 256, True, 2048, 0, "simt"),
        ("bfloat16", 1, 2048, 2048, 10, 1, 256, True, 2048, 0,
         "tensor-core"),
        ("bfloat16", 1, 1, 2048, 10, 1, 256, True, 2048, 2047,
         "tensor-core"),
        ("bfloat16", 1, 1000, 1000, 10, 1, 256, True, 256, 0, "tensor-core"),
        ("bfloat16", 1, 1500, 1500, 16, 16, 64, False, None, 0,
         "tensor-core"),
        ("float32", 1, 1500, 1500, 16, 16, 64, False, None, 0, "simt"),
        ("bfloat16", 1, 1, 1500, 16, 16, 64, False, None, 0, "tensor-core"),
        ("float32", 1, 1, 1500, 16, 16, 64, False, None, 0, "simt"),
        ("bfloat16", 1, 16, 1500, 16, 16, 64, False, None, 0, "tensor-core"),
    ]
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    rows = []
    for dtype, B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset, route in k4:
        q = _randn(gen, (B, Sq, Hq, D), dtype, dev)
        k = _randn(gen, (B, Skv, Hkv, D), dtype, dev)
        v = _randn(gen, (B, Skv, Hkv, D), dtype, dev)
        got_route = "tensor-core" if fa.tc_route(q, k) else "simt"
        check(got_route == route, f"K4 {dtype} D={D} took the {got_route} "
              f"route, not {route}")
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        n_split = fa.split_plan(q.dtype, B, Sq, Hq, Skv, D)
        tag = (f"K4 {route} {dtype} B={B} Sq={Sq} Skv={Skv} heads={Hq}/{Hkv}"
               f" D={D} {kw} n_split={n_split}")
        err = _attn_err(tag, got, want, ATTN_TOL[dtype])
        errs["flash_attention"] = max(errs["flash_attention"], err)
        rows.append({"kernel": "K4", "route": route, "case": tag,
                     "n_split": n_split, "max_abs_err": err})
        log(f"phase 15 (a) {tag}: max abs err {err:.3g}")
    # the split over the keys only where the unsplit grid is under one wave:
    # Whisper's cross-attention, not its encoder, llama or recurrentgemma
    bf16 = torch.bfloat16
    for shape, want_split in (((1, 1500, 16, 1500, 64), False),
                              ((1, 2048, 24, 2048, 128), False),
                              ((1, 2048, 10, 2048, 256), False),
                              ((1, 1, 16, 1500, 64), True),
                              ((1, 16, 16, 1500, 64), True)):
        n_split = fa.split_plan(bf16, *shape)
        check((n_split > 1) == want_split, f"K4 split_plan{shape} gives "
              f"{n_split}")
    Hq, Hkv, D = 10, 1, 256
    k5 = [  # q dtype, cache dtype, L, layout, window
        ("bfloat16", "float32", 128, "full", 2048),    # the engine's cache
        ("bfloat16", "bfloat16", 128, "full", 2048),
        ("bfloat16", "float32", 2048, "full", 2048),   # split
        ("bfloat16", "bfloat16", 2048, "full", 2048),
        ("float32", "float32", 2048, "ring", 2048),    # wrapped ring
        ("bfloat16", "float32", 2048, "padded", 2048),  # empty splits
    ]
    for q_dt, c_dt, L, layout, window in k5:
        B = 2 if layout == "ring" else 1
        q = _randn(gen, (B, 1, Hq, D), q_dt, dev)
        kc = _randn(gen, (B, L, Hkv, D), c_dt, dev)
        vc = _randn(gen, (B, L, Hkv, D), c_dt, dev)
        cp, pos = _cache_pos(layout, B, L, dev)
        got = da.decode_attention_cuda(q, kc, vc, cp, pos, window=window)
        want = da.decode_attention_plain(q, kc, vc, cp, pos, window=window)
        torch.cuda.synchronize()
        n_split = da.split_plan(B, Hkv, L)
        tag = (f"K5 q={q_dt} cache={c_dt} B={B} L={L} heads={Hq}/{Hkv} D={D}"
               f" {layout} window={window} n_split={n_split}")
        err = _attn_err(tag, got, want, ATTN_TOL[q_dt])
        errs["decode_attention"] = max(errs["decode_attention"], err)
        rows.append({"kernel": "K5", "case": tag, "n_split": n_split,
                     "max_abs_err": err})
    check(da.split_plan(1, Hkv, 2048) > 1, "K5 does not split L=2048")
    report["zoo_kernels"] = {"cases": rows, "tolerance": ATTN_TOL}
    log(f"phase 15 (a) K4/K5: {len(k4)} K4 and {len(k5)} K5 cases at the "
        f"zoo's shapes agree with the plain versions (max abs err K4 "
        f"{errs['flash_attention']:.3g}, K5 {errs['decode_attention']:.3g})")
    return errs


def _decode_timed(params, cfg, cache, dev, n_steps):
    """ms per decode step (batch 1) over ``n_steps`` greedy steps."""
    import torch
    from repro_torch.models import transformer as tf
    tok = torch.full((1, 1), 7, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        logits, cache = tf.decode_step_lm(params, cache, tok, cfg)
        tok = torch.argmax(logits[0, -1]).to(torch.int32).reshape(1, 1)
        int(tok)                                       # the engine's sync
    return (time.perf_counter() - t0) / n_steps * 1e3


def _zoo_decoder(arch, dev, num_layers=None, serve_it=False):
    """Full-width bf16 ``forward_lm`` against ``prefill_into_cache`` on a
    32-token prompt, K4 and K5 counted exactly; then timed decode steps;
    then, for a served arch, the serve launcher with K5 counted."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import transformer as tf
    overrides = {} if num_layers is None else {"num_layers": num_layers}
    cfg = _zoo_cfg(arch, **overrides)
    if cfg.n_experts:      # the forward drops no pair, as decoding cannot
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    n_attn = _n_attn(cfg)
    t0 = time.perf_counter()
    params = tf.init_lm(cfg, torch.Generator(device=dev).manual_seed(
        ZOO_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    toks = torch.from_numpy(np.random.default_rng(ZOO_SEED).integers(
        0, cfg.vocab_size, (1, ZOO_PROMPT)).astype(np.int32)).to(dev)
    torch.cuda.reset_peak_memory_stats()          # forward and decode only
    cuda_lib.reset_launches()
    full, _ = tf.forward_lm(params, toks, cfg)
    torch.cuda.synchronize()
    fwd_counts = dict(cuda_lib.LAUNCHES)
    max_len = ZOO_PROMPT + ZOO_DECODE_STEPS
    cache = tf.init_cache_lm(cfg, 1, max_len, torch.float32, dev)
    cuda_lib.reset_launches()
    cache, seq = tf.prefill_into_cache(params, cache, toks, cfg)
    torch.cuda.synchronize()
    dec_counts = dict(cuda_lib.LAUNCHES)
    check(fwd_counts["flash_attention"] == n_attn and sum(
        fwd_counts.values()) == n_attn, f"{arch}: forward launched "
        f"{fwd_counts}, want K4 x {n_attn} and nothing else")
    check(dec_counts["decode_attention"] == n_attn * ZOO_PROMPT and sum(
        dec_counts.values()) == n_attn * ZOO_PROMPT, f"{arch}: decode "
        f"launched {dec_counts}, want K5 x {n_attn * ZOO_PROMPT}")
    check(bool(torch.isfinite(full).all() and torch.isfinite(seq).all()),
          f"{arch}: non-finite logits")
    check(full.shape == seq.shape, f"{arch}: {full.shape} vs {seq.shape}")
    rel = _rel(full, seq)
    agree = float((full.argmax(-1) == seq.argmax(-1)).float().mean())
    ms = _decode_timed(params, cfg, cache, dev, ZOO_DECODE_STEPS)
    info = {"layers": cfg.num_layers, "attention_layers": n_attn,
            "params": n_params, "init_s": init_s, "prompt": ZOO_PROMPT,
            "rel_max_diff": rel, "argmax_agreement": agree,
            "forward_launches": fwd_counts, "decode_launches": dec_counts,
            "ms_per_decode_step": ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del cache, seq
    if arch == ZOO_EVAL_ARCH:
        info["eval"] = _zoo_eval(params, cfg, dev)
    if arch in ZOO_CHECK_F32:
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype="float32")
        p32 = tf._map_leaves(lambda t: t.float(), params)
        del params
        full32, _ = tf.forward_lm(p32, toks, cfg32)
        _, seq32 = tf.prefill_into_cache(
            p32, tf.init_cache_lm(cfg32, 1, ZOO_PROMPT, torch.float32, dev),
            toks, cfg32)
        info["f32"] = {"rel_max_diff": _rel(full32, seq32),
                       "bound": FWD_DEC_REL_F32,
                       "bf16_forward_vs_f32_forward_rel": _rel(full32, full)}
        check(info["f32"]["rel_max_diff"] < FWD_DEC_REL_F32, f"{arch}: f32 "
              f"forward vs decode rel {info['f32']['rel_max_diff']:.3g} >= "
              f"{FWD_DEC_REL_F32}")
        del p32, full32, seq32
    else:
        check(rel < FWD_DEC_REL_BF16, f"{arch}: forward vs decode rel "
              f"{rel:.3g} >= {FWD_DEC_REL_BF16}")
        del params
    del full
    torch.cuda.empty_cache()
    if serve_it:
        from repro_torch.launch import serve
        argv = ["--arch", arch] + ZOO_SERVE
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        run = serve.main(argv)
        counts = dict(cuda_lib.LAUNCHES)
        n_req, max_new = 4, 8
        want = n_attn * (run.prompt_tokens + n_req * max_new)
        check(len(run.outputs) == n_req and all(
            len(c.tokens) == max_new for c in run.outputs.values()),
            f"{arch}: serving did not finish {n_req} requests of {max_new} "
            f"tokens: {run.outputs}")
        check(counts["decode_attention"] == want and sum(counts.values())
              == want, f"{arch}: serving launched {counts}, want K5 x {want}"
              f" ({n_attn} attention layers x ({run.prompt_tokens} prompt +"
              f" {n_req * max_new} decoded tokens))")
        info["serve"] = {
            "argv": argv, "tokens": run.tokens, "seconds": run.seconds,
            "tokens_per_s": run.tokens / run.seconds,
            "prompt_tokens": run.prompt_tokens, "engine_steps": run.steps,
            "launches": counts,
            "peak_gib_with_init": torch.cuda.max_memory_allocated() / 2 ** 30}
        torch.cuda.empty_cache()
    f32_note = "" if "f32" not in info else (
        f" (f32: forward vs decode rel {info['f32']['rel_max_diff']:.3g}, "
        f"bound {FWD_DEC_REL_F32}; bf16 vs f32 forward rel "
        f"{info['f32']['bf16_forward_vs_f32_forward_rel']:.3g})")
    log(f"phase 15 {arch} ({cfg.num_layers} layers, {n_params / 1e9:.2f} B "
        f"params, bf16): forward vs decode rel {rel:.3g}{f32_note}, argmax "
        f"agreement {agree:.3f}; K4 {fwd_counts['flash_attention']}, K5 "
        f"{dec_counts['decode_attention']}; {ms:.2f} ms per decode step; "
        f"peak {info['peak_gib']:.2f} GiB" + (
            f"; served {info['serve']['tokens']} tokens at "
            f"{info['serve']['tokens_per_s']:.1f} tok/s"
            if serve_it else ""))
    return info


def _zoo_eval(params, cfg, dev):
    """(f) the eval step at B=1, S=LM_LONG_SEQ: K4 once per attention
    layer and nothing else, its loss against the training route's on the
    same batch, and the median of ZOO_EVAL_STEPS synchronised steps."""
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.models.registry import build_model
    from repro_torch.train import optim, trainer
    api = build_model(cfg)
    batch = _lm_batch(cfg, dev, 1, LM_LONG_SEQ)
    step = trainer.make_eval_step(api)
    state = {"params": params}
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    eval_loss = float(step(state, batch))
    counts = dict(cuda_lib.LAUNCHES)
    n_attn = _n_attn(cfg)
    check(counts["flash_attention"] == n_attn and sum(counts.values()) ==
          n_attn, f"{cfg.name} eval launched {counts}, want K4 x {n_attn}")
    ms = []
    for _ in range(ZOO_EVAL_STEPS):
        _, sec = _sync_s(lambda: float(step(state, batch)))
        ms.append(sec * 1e3)
    with torch.enable_grad():
        leaves = optim.tree_map(lambda t: t.detach().requires_grad_(),
                                params)
        cuda_lib.reset_launches()
        train_loss = float(api.loss(leaves, batch, remat=False))
        train_counts = dict(cuda_lib.LAUNCHES)
        del leaves
    check(sum(train_counts.values()) == 0, f"the training route launched "
          f"{train_counts}")
    rel = abs(eval_loss - train_loss) / abs(train_loss)
    check(math.isfinite(eval_loss) and rel < LM_EVAL_REL, f"{cfg.name} eval "
          f"loss {eval_loss} vs training route {train_loss}: rel {rel:.3g}")
    med = sorted(ms)[len(ms) // 2]
    log(f"phase 15 (f) {cfg.name} eval step B=1 S={LM_LONG_SEQ}: loss "
        f"{eval_loss:.5f} on the K4 route ({counts['flash_attention']} K4 "
        f"launches), {train_loss:.5f} on the training route (rel {rel:.3g},"
        f" bound {LM_EVAL_REL}); {med:.2f} ms (median of {len(ms)})")
    return {"batch": 1, "seq": LM_LONG_SEQ, "loss_k4_route": eval_loss,
            "loss_training_route": train_loss, "rel": rel,
            "bound": LM_EVAL_REL, "launches": counts, "step_ms": ms,
            "median_ms": med}


def _rel(want, got):
    return float((want.float() - got.float()).abs().max()
                 / want.float().abs().max())


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _zoo_encdec(dev):
    """Whisper at full width and depth through its ModelAPI: the
    teacher-forced pass on 1,500 frames and 16 tokens against
    ``fill_cross_cache`` and 16 ``decode_step`` calls, K4 and K5 exact."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import encdec
    from repro_torch.models.registry import build_model
    cfg = _zoo_cfg(ZOO_ENCDEC)
    api = build_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(ZOO_SEED))
    n_params = sum(t.numel() for t in _leaves(params))
    gen = torch.Generator(device=dev).manual_seed(ZOO_SEED + 1)
    frames = _randn(gen, (1, cfg.n_frames, cfg.d_model), "bfloat16", dev)
    S = ZOO_ENCDEC_TOKENS
    toks = torch.from_numpy(np.random.default_rng(ZOO_SEED).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int32)).to(dev)
    L_enc, L_dec = cfg.encoder_layers, cfg.num_layers
    torch.cuda.reset_peak_memory_stats()          # forward and decode only
    cuda_lib.reset_launches()
    full = api.prefill(params, {"frames": frames, "tokens": toks})
    torch.cuda.synchronize()
    fwd_counts = dict(cuda_lib.LAUNCHES)
    check(fwd_counts["flash_attention"] == L_enc + 2 * L_dec and sum(
        fwd_counts.values()) == L_enc + 2 * L_dec, f"whisper forward "
        f"launched {fwd_counts}, want K4 x {L_enc + 2 * L_dec}")
    cache = api.init_cache(1, S, torch.float32, dev)
    cuda_lib.reset_launches()
    encdec.fill_cross_cache(params, cache, frames, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = []
    for t in range(S):
        logits, cache = api.decode_step(params, cache, toks[:, t:t + 1])
        seq.append(logits[:, 0])
        int(torch.argmax(logits[0, -1]))               # the engine's sync
    ms = (time.perf_counter() - t0) / S * 1e3
    dec_counts = dict(cuda_lib.LAUNCHES)
    want = {"flash_attention": L_enc + S * L_dec,
            "decode_attention": S * L_dec}
    check({k: v for k, v in dec_counts.items() if v} == want,
          f"whisper decode launched {dec_counts}, want {want}")
    seq = torch.stack(seq, 1)
    check(bool(torch.isfinite(full).all() and torch.isfinite(seq).all()),
          "whisper: non-finite logits")
    rel = float((full.float() - seq.float()).abs().max()
                / full.float().abs().max())
    agree = float((full.argmax(-1) == seq.argmax(-1)).float().mean())
    check(rel < FWD_DEC_REL_BF16, f"whisper: teacher-forced vs decoded rel "
          f"{rel:.3g} >= {FWD_DEC_REL_BF16}")
    info = {"encoder_layers": L_enc, "decoder_layers": L_dec,
            "params": n_params, "frames": cfg.n_frames, "tokens": S,
            "rel_max_diff": rel, "argmax_agreement": agree,
            "forward_launches": fwd_counts, "decode_launches": dec_counts,
            "ms_per_decode_step": ms, "tokens_per_s": 1e3 / ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del params, cache, full, seq, frames
    torch.cuda.empty_cache()
    log(f"phase 15 {ZOO_ENCDEC} ({L_enc}+{L_dec} layers, "
        f"{n_params / 1e9:.2f} B params, bf16, {cfg.n_frames} frames, {S} "
        f"tokens): teacher-forced vs decoded rel {rel:.3g}, argmax agreement"
        f" {agree:.3f}; K4 {fwd_counts['flash_attention']} + "
        f"{dec_counts['flash_attention']}, K5 "
        f"{dec_counts['decode_attention']}; {ms:.2f} ms per decode step; "
        f"peak {info['peak_gib']:.2f} GiB")
    return info


def _zoo_card_cpu(arch, layers, dev):
    """(d) one f32 weight set at full width cut to ``layers``: forward and
    8 decode steps on the card against the CPU's plain path."""
    import numpy as np
    import torch
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import build_model
    cfg = _zoo_cfg(arch, num_layers=layers, param_dtype="float32",
                   compute_dtype="float32")
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, encoder_layers=layers)
    api = build_model(cfg)
    cpu_params = api.init(torch.Generator().manual_seed(ZOO_SEED))
    params = tf.params_to(cpu_params, dev)
    rng = np.random.default_rng(ZOO_SEED + 2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 8))
                            .astype(np.int32))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (1, cfg.n_frames, cfg.d_model)).astype(np.float32))
    rels = {}
    got = api.prefill(params, {k: v.to(dev) for k, v in batch.items()})
    want = api.prefill(cpu_params, batch)
    rels["forward"] = float((got.cpu() - want).abs().max()
                            / want.abs().max())
    seqs = []
    for p, device in ((params, dev), (cpu_params, "cpu")):
        cache = api.init_cache(1, 8, torch.float32, device)
        if cfg.family == "encdec":
            encdec.fill_cross_cache(p, cache, batch["frames"].to(device),
                                    cfg)
        out = []
        for t in range(8):
            logits, cache = api.decode_step(p, cache,
                                            toks[:, t:t + 1].to(device))
            out.append(logits[:, 0].cpu())
        seqs.append(torch.stack(out, 1))
    rels["decode"] = float((seqs[0] - seqs[1]).abs().max()
                           / seqs[1].abs().max())
    for name, rel in rels.items():
        check(math.isfinite(rel) and rel < CARD_CPU_REL, f"{arch} card vs "
              f"CPU {name} rel {rel:.3g} >= {CARD_CPU_REL}")
    del params, cpu_params
    torch.cuda.empty_cache()
    return {"layers": layers, "rel_max_diff": rels}


def _zoo_timing(dev):
    """(e) K5 at recurrentgemma's shapes, K4 at Whisper's and at head dim
    256, timed as in phase 11, with the plain version, SDPA and the
    bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(16)
    rows = []
    k4_cases = [  # tag, B, Sq, Skv, Hq, Hkv, D, causal, dtype
        ("whisper encoder", 1, 1500, 1500, 16, 16, 64, False, "bfloat16"),
        ("whisper cross-attention, one decode step", 1, 1, 1500, 16, 16, 64,
         False, "bfloat16"),
        ("whisper cross-attention, teacher-forced", 1, 16, 1500, 16, 16, 64,
         False, "bfloat16"),
        ("recurrentgemma local, tensor-core D=256", 1, 2048, 2048, 10, 1,
         256, True, "bfloat16"),
        ("recurrentgemma local, SIMT D=256 (f32)", 1, 2048, 2048, 10, 1,
         256, True, "float32"),
    ]
    for tag, B, Sq, Skv, Hq, Hkv, D, causal, dtype in k4_cases:
        q = _randn(gen, (B, Sq, Hq, D), dtype, dev)
        k = _randn(gen, (B, Skv, Hkv, D), dtype, dev)
        v = _randn(gen, (B, Skv, Hkv, D), dtype, dev)
        route = "tensor-core" if fa.tc_route(q, k) else "simt"
        check(route == ("tensor-core" if dtype == "bfloat16" else "simt"),
              f"K4 {tag} took the {route} route")
        kw = dict(causal=causal, window=2048 if D == 256 else None)
        k_ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw), flush)
        p_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                       flush, iters=10)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=True)
        _attn_err(f"SDPA yardstick vs K4 {tag}",
                  lib_out.transpose(1, 2).contiguous(),
                  fa.flash_attention_cuda(q, k, v, **kw), SDPA_TOL)
        l_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), flush)
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
        flops = 4 * D * Hq * B * pairs
        n_bytes = q.element_size() * 2 * B * (Sq * Hq + Skv * Hkv) * D
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOP_PER_S
                              if dtype == "bfloat16" else F32_FLOP_PER_S)
        n_split = fa.split_plan(q.dtype, B, Sq, Hq, Skv, D)
        rows.append({"kernel": "K4", "at": f"{tag}: B={B} Sq={Sq} Skv={Skv}"
                     f" Hq={Hq} Hkv={Hkv} D={D} {dtype} causal={causal} "
                     f"n_split={n_split}", "n_split": n_split,
                     "route": route, "ms": k_ms, "plain_ms": p_ms,
                     "sdpa_ms": l_ms, "flops": flops, "bytes": n_bytes,
                     "bound_ms": b_ms, "bound_by": b_by})
        del q, k, v, qt, kt, vt, lib_out
    Hq, Hkv, D = 10, 1, 256
    for L in (128, 2048):
        q = _randn(gen, (1, 1, Hq, D), "bfloat16", dev)
        kc = _randn(gen, (1, L, Hkv, D), "float32", dev)
        vc = _randn(gen, (1, L, Hkv, D), "float32", dev)
        cp, pos = _cache_pos("full", 1, L, dev)
        kw = dict(window=2048)
        k_ms = time_ms(lambda: da.decode_attention_cuda(q, kc, vc, cp, pos,
                                                        **kw), flush)
        p_ms = time_ms(lambda: da.decode_attention_plain(q, kc, vc, cp, pos,
                                                         **kw), flush,
                       iters=10)
        q32 = q.float().transpose(1, 2).contiguous()
        kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
        mask = ((cp >= 0) & (cp <= pos[:, None]))[:, None, None, :]
        lib_out = F.scaled_dot_product_attention(q32, kt, vt, attn_mask=mask,
                                                 enable_gqa=True)
        _attn_err(f"SDPA yardstick vs K5 L={L}",
                  lib_out.transpose(1, 2).to(torch.bfloat16).contiguous(),
                  da.decode_attention_cuda(q, kc, vc, cp, pos, **kw),
                  SDPA_TOL)
        l_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q32, kt, vt, attn_mask=mask, enable_gqa=True), flush)
        n_valid = int(((cp >= 0) & (cp <= pos[:, None])).sum())
        n_bytes = 2 * n_valid * Hkv * D * 4 + L * 4 + 4 + 2 * Hq * D * 2
        b_ms, b_by = bound_ms(n_bytes, 4 * n_valid * Hq * D)
        rows.append({"kernel": "K5", "at": f"recurrentgemma local decode: "
                     f"B=1 L={L} Hq={Hq} Hkv={Hkv} D={D} q bf16, cache f32, "
                     f"window 2048, n_split={da.split_plan(1, Hkv, L)}",
                     "ms": k_ms, "plain_ms": p_ms, "sdpa_ms": l_ms,
                     "bytes": n_bytes, "bound_ms": b_ms, "bound_by": b_by})
        del q, kc, vc, kt, vt, q32, lib_out
    for r in rows:
        log(f"phase 15 (e) {r['kernel']} {r['at']}: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.3f}, SDPA {r['sdpa_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']})")
    return rows


def _zoo_launches(zoo_line, kernel):
    """A kernel's launches on each zoo model's path in phase 15 (forward,
    decode and serving runs)."""
    out = {}
    for arch, info in zoo_line["models"].items():
        n = info["forward_launches"][kernel] + \
            info["decode_launches"][kernel]
        if "serve" in info:
            n += info["serve"]["launches"][kernel]
        out[arch] = n
    return out


def phase_zoo(report, dev):
    """Phase 15: the rest of the LM zoo at full width on the card."""
    import torch
    t0 = time.perf_counter()
    errs = phase_zoo_kernels(report, dev)
    models = {}
    for arch in ZOO_FULL_DEPTH:
        models[arch] = _zoo_decoder(arch, dev, serve_it=True)
    models[ZOO_ENCDEC] = _zoo_encdec(dev)
    for arch, layers in ZOO_WIDTH_ONLY.items():
        models[arch] = _zoo_decoder(arch, dev, num_layers=layers)
    card_cpu = {}
    for arch, layers in ZOO_CARD_CPU.items():
        card_cpu[arch] = _zoo_card_cpu(arch, layers, dev)
        log(f"phase 15 (d) {arch} card vs CPU (full width, {layers} layers,"
            f" f32): rel forward "
            f"{card_cpu[arch]['rel_max_diff']['forward']:.3g}, decode "
            f"{card_cpu[arch]['rel_max_diff']['decode']:.3g} (bound "
            f"{CARD_CPU_REL})")
    timing = _zoo_timing(dev)
    torch.cuda.empty_cache()
    line = {"models": models, "card_vs_cpu": card_cpu, "timing": timing,
            "max_abs_err": errs, "seconds": time.perf_counter() - t0}
    report["lm_zoo"] = line
    log(f"phase 15 zoo: {time.perf_counter() - t0:.1f} s")
    return line


# ---------------------------------------------------------------------------
# phase 16: LM training (train and eval steps, remat, adamw leaf by leaf,
# the launcher's LM mode, LM checkpoints and resume) at llama3.2-3b's full
# width
# ---------------------------------------------------------------------------
# adamw's rate for the full-width models: at the launcher's default 3e-3,
# tuned for the reduced configs, llama3.2-3b's loss rose over 10 steps
# (12.28 -> 14.66; at 3e-4 12.28 -> 12.03; H100 80GB HBM3, 700 W)
LM_LR = 3e-4
LM_TRAIN_ARGV = ["--arch", "llama3.2-3b", "--full", "--batch", "8", "--seq",
                 "64", "--lr", str(LM_LR), "--device", "cuda"]
LM_TRAIN_STEPS = 10
LM_TRAIN_TIMED_FROM = 2           # the median over steps 3-10
LM_EVAL_REL = 1e-2                # K4 route vs the training route, bf16
LM_PEAK_BYTES = 80e9              # the card's 80 GB
LM_LONG_SEQ = 2048                # (b): one sequence of 2,048 tokens
LM_FAMILIES = ("granite-moe-1b-a400m", "mamba2-2.7b", "recurrentgemma-2b",
               "whisper-medium")
LM_FAMILY_STEPS = 3
LM_CARD_CPU_LAYERS = 2            # (e): full width, f32, B=2, S=64
LM_CARD_CPU_LOSS_REL = 1e-5
LM_CARD_CPU_GRAD_REL = 1e-4       # per leaf, ||card - cpu|| / ||cpu||
LM_CARD_CPU_STEP_LOSS_REL = 1e-4  # the loss after one adamw step
LM_CKPT_LAYERS = 2                # (f): full width; the full-depth state is
                                  # 38.5 GB of host memory and disk
# the trainer's profiler ranges (host-side spans, not device time)
TRAIN_RANGES = ("train_step.forward_backward", "train_step.optimizer")


def _lm_batch(cfg, dev, B, S, start=0):
    import numpy as np
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch import train as launch
    batch = launch.to_device(lm_batch(0, np.arange(start, start + B), S,
                                      cfg.vocab_size), dev)
    if cfg.family == "encdec":
        import torch
        batch["frames"] = torch.zeros((B, cfg.n_frames, cfg.d_model),
                                      dtype=torch.float32, device=dev)
    return batch


def _profiled(fn, top=8):
    """``torch.profiler`` over ``fn()`` ending in a synchronise: its
    result and the device summary of that one window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    info, device = _device_summary(prof, wall_us, 1, top)
    check(device, "phase 16: torch.profiler showed no device events")
    info["host_gap_ms"] = info["wall_ms_per_step"] - info["device_ms_per_step"]
    return out, info


def _lm_train_full(report, dev):
    """(a) the launcher at full width and depth, (c) eval on its state,
    the profiler split, (b) one sequence of 2,048 tokens."""
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.train import optim, trainer
    info = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = LM_TRAIN_ARGV + ["--steps", str(LM_TRAIN_STEPS)]
    log(f"phase 16 (a) launcher: {' '.join(argv)}")
    run, counts = _driven(argv, ())
    peak = torch.cuda.max_memory_allocated()
    cfg, api, opt = run.cfg, run.api, run.opt
    B, S = 8, 64
    losses = run.losses
    check(sum(counts.values()) == 0, f"LM training launched kernels: "
          f"{counts} (attention trains on the chunked route)")
    check(len(losses) == LM_TRAIN_STEPS and run.state["step"] ==
          LM_TRAIN_STEPS, f"{len(losses)} steps, state at step "
          f"{run.state['step']}, want {LM_TRAIN_STEPS}")
    check(run.exactly_once and run.covered == LM_TRAIN_STEPS * B
          and run.dup == 0, f"coverage exact={run.exactly_once} covered="
          f"{run.covered} dup={run.dup}")
    last3 = sum(losses[-3:]) / 3
    check(last3 < losses[0], f"loss did not fall: first {losses[0]}, mean of"
          f" the last 3 {last3}")
    check(peak < LM_PEAK_BYTES, f"peak memory {peak / 1e9:.2f} GB")
    timed = sorted(run.step_seconds[LM_TRAIN_TIMED_FROM:])
    med = timed[len(timed) // 2] if len(timed) % 2 else \
        (timed[len(timed) // 2 - 1] + timed[len(timed) // 2]) / 2
    n_params = sum(t.numel() for t in _leaves(run.state["params"]))
    info["launcher"] = {
        "argv": argv, "params": n_params, "losses": losses,
        "grad_norms": run.grad_norms, "step_ms": [s * 1e3 for s in
                                                  run.step_seconds],
        "median_step_ms_3_10": med * 1e3, "tokens_per_s": B * S / med,
        "launcher_seconds": run.seconds, "peak_bytes": peak,
        "peak_gb": peak / 1e9, "launches": counts,
        "coverage": {"exact": run.exactly_once, "covered": run.covered,
                     "dup": run.dup}}
    log(f"phase 16 (a) {n_params / 1e9:.3f} B params: loss {losses[0]:.4f} ->"
        f" {losses[-1]:.4f} (last 3 {last3:.4f}); {med * 1e3:.1f} ms per "
        f"step (median of steps 3-10), {B * S / med:.0f} tokens/s; peak "
        f"{peak / 1e9:.2f} GB; launches {counts}")

    # (c) eval on the trained state: K4 once per layer, against the
    # training route's loss on the same params and batch
    state = run.state
    del run
    batch = _lm_batch(cfg, dev, B, S, start=LM_TRAIN_STEPS * B)
    cuda_lib.reset_launches()
    eval_loss = float(trainer.make_eval_step(api)(state, batch))
    eval_counts = dict(cuda_lib.LAUNCHES)
    with torch.enable_grad():
        leaves = optim.tree_map(lambda t: t.detach().requires_grad_(),
                                state["params"])
        cuda_lib.reset_launches()
        train_loss = float(api.loss(leaves, batch, remat=False))
        train_counts = dict(cuda_lib.LAUNCHES)
        del leaves
    n_attn = _n_attn(cfg)
    check(eval_counts["flash_attention"] == n_attn and sum(
        eval_counts.values()) == n_attn, f"eval launched {eval_counts}, want "
          f"K4 x {n_attn}")
    check(sum(train_counts.values()) == 0, f"the training route launched "
          f"{train_counts}")
    rel = abs(eval_loss - train_loss) / abs(train_loss)
    check(math.isfinite(eval_loss) and rel < LM_EVAL_REL, f"eval loss "
          f"{eval_loss} vs training route {train_loss}: rel {rel:.3g}")
    info["eval"] = {"loss_k4_route": eval_loss,
                    "loss_training_route": train_loss, "rel": rel,
                    "bound": LM_EVAL_REL, "launches": eval_counts}
    log(f"phase 16 (c) eval: loss {eval_loss:.5f} on the K4 route "
        f"({eval_counts['flash_attention']} K4 launches), {train_loss:.5f} "
        f"on the training route (rel {rel:.3g}, bound {LM_EVAL_REL})")

    # the profiler split of one step: the whole (donated) step, then its
    # forward + backward and its optimizer in windows of their own
    step = trainer.make_train_step(api, opt, remat=True, donate=True)
    (state, _), whole = _profiled(lambda: step(state, batch))
    (loss, grads), fb = _profiled(lambda: trainer.loss_and_grads(
        api, state["params"], batch, remat=True))

    def optimizer_part():
        optim.global_norm(grads)
        return optim.update_and_apply(opt, grads, state["opt"],
                                      state["params"], donate=True)
    (params, opt_state), op = _profiled(optimizer_part)
    state = {"params": params, "opt": opt_state, "step": state["step"] + 1}
    del grads, params, opt_state, loss
    info["profile"] = {"step": whole, "forward_backward": fb,
                       "optimizer": op}
    for name, p in info["profile"].items():
        log(f"phase 16 profile {name}: {p['wall_ms_per_step']:.1f} ms wall, "
            f"{p['device_ms_per_step']:.1f} ms device, host gaps "
            f"{p['host_gap_ms']:.1f} ms, idle share "
            f"{p['device_idle_share']:.3f}, {p['device_events_per_step']:.0f}"
            " device events")
        for t in p["top_device_time"][:4]:
            log(f"    {t['ms_per_step']:.3f} ms x{t['calls_per_step']:.0f} "
                f"{t['name']}")

    # (b) one sequence of 2,048 tokens, remat, two donated steps
    long_batch = _lm_batch(cfg, dev, 1, LM_LONG_SEQ)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    ms = []
    for _ in range(2):
        (state, m), sec = _sync_s(lambda: step(state, long_batch))
        ms.append(sec * 1e3)
        check(math.isfinite(float(m["loss"])), "non-finite loss at S=2048")
    long_peak = torch.cuda.max_memory_allocated()
    check(sum(cuda_lib.LAUNCHES.values()) == 0, "a kernel launched in the "
          f"S=2048 train step: {dict(cuda_lib.LAUNCHES)}")
    check(long_peak < LM_PEAK_BYTES, f"S=2048: peak {long_peak / 1e9:.2f} GB")
    info["long"] = {"batch": 1, "seq": LM_LONG_SEQ, "step_ms": ms,
                    "tokens_per_s": LM_LONG_SEQ / (ms[-1] / 1e3),
                    "peak_gb": long_peak / 1e9}
    log(f"phase 16 (b) B=1 S={LM_LONG_SEQ}: {ms[0]:.1f}, {ms[1]:.1f} ms per "
        f"step, peak {long_peak / 1e9:.2f} GB")
    del state, batch, long_batch, step
    torch.cuda.empty_cache()
    return info


def _lm_train_families(dev):
    """(d) three launcher steps of each other family at full width and
    depth."""
    import torch
    out = {}
    for arch in LM_FAMILIES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        argv = ["--arch", arch, "--full", "--batch", "8", "--seq", "64",
                "--lr", str(LM_LR), "--steps", str(LM_FAMILY_STEPS),
                "--device", "cuda"]
        run, counts = _driven(argv, ())
        check(sum(counts.values()) == 0, f"{arch} training launched "
              f"{counts}")
        check(len(run.losses) == LM_FAMILY_STEPS, f"{arch}: "
              f"{len(run.losses)} steps")
        ms = [s * 1e3 for s in run.step_seconds]
        out[arch] = {"layers": run.cfg.num_layers, "params": sum(
            t.numel() for t in _leaves(run.state["params"])),
            "losses": run.losses, "step_ms": ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts}
        del run
        log(f"phase 16 (d) {arch}: losses {[round(x, 4) for x in out[arch]['losses']]}"
            f", {ms[-1]:.1f} ms at step {LM_FAMILY_STEPS}, peak "
            f"{out[arch]['peak_gb']:.2f} GB, K4 {counts['flash_attention']}")
    torch.cuda.empty_cache()
    return out


def _lm_train_card_cpu(dev):
    """(e) card against CPU: f32, full width, 2 layers, B=2, S=64, TF32 off:
    loss, every gradient leaf, one adamw step, the loss after it."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import build_model
    from repro_torch.train import optim, trainer
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    cfg = _zoo_cfg("llama3.2-3b", num_layers=LM_CARD_CPU_LAYERS,
                   param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg)
    opt = optim.adamw(LM_LR)
    cpu_params = api.init(torch.Generator().manual_seed(ZOO_SEED))
    params = tf.params_to(cpu_params, dev)
    cpu_batch = _lm_batch(cfg, "cpu", 2, 64)
    batch = {k: v.to(dev) for k, v in cpu_batch.items()}
    loss, grads = trainer.loss_and_grads(api, params, batch, remat=True)
    closs, cgrads = trainer.loss_and_grads(api, cpu_params, cpu_batch,
                                           remat=True)
    loss_rel = abs(float(loss) - float(closs)) / abs(float(closs))
    grad_rel = {}
    got, want = _flat_named(grads), _flat_named(cgrads)
    for name, w in want.items():
        grad_rel[name] = float((got[name].cpu() - w).norm() / w.norm())
    worst = max(grad_rel, key=grad_rel.get)
    del got, want
    # one adamw step from the gradients above, on each device
    state = {"step": 1}
    state["params"], state["opt"] = optim.update_and_apply(
        opt, grads, opt.init(params), params)
    cstate = {"step": 1}
    cstate["params"], cstate["opt"] = optim.update_and_apply(
        opt, cgrads, opt.init(cpu_params), cpu_params)
    del grads, cgrads
    dp, rel_dp = 0.0, 0.0
    new, cnew = _flat_named(state["params"]), _flat_named(cstate["params"])
    old = _flat_named(cpu_params)
    for name, c in cnew.items():
        d = new[name].cpu() - c
        dp = max(dp, float(d.abs().max()))
        rel_dp = max(rel_dp, float(d.norm() / (c - old[name]).norm()))
    ev = trainer.make_eval_step(api)
    after = float(ev(state, batch))
    cafter = float(ev(cstate, cpu_batch))
    after_rel = abs(after - cafter) / abs(cafter)
    info = {"layers": LM_CARD_CPU_LAYERS, "loss_rel": loss_rel,
            "loss_bound": LM_CARD_CPU_LOSS_REL, "grad_rel_max": grad_rel[
                worst], "grad_rel_worst_leaf": worst,
            "grad_bound": LM_CARD_CPU_GRAD_REL,
            "params_after_step_max_abs_diff": dp,
            "params_after_step_diff_over_update_max": rel_dp,
            "loss_after_step": [after, cafter], "loss_after_step_rel":
            after_rel, "loss_after_step_bound": LM_CARD_CPU_STEP_LOSS_REL}
    check(loss_rel < LM_CARD_CPU_LOSS_REL, f"card vs CPU loss rel "
          f"{loss_rel:.3g}")
    check(grad_rel[worst] < LM_CARD_CPU_GRAD_REL, f"card vs CPU gradient "
          f"{worst}: rel {grad_rel[worst]:.3g}")
    # the first adam step moves an element by lr |mh / (sqrt(vh) + eps)|
    # <= lr besides the weight decay, which both devices apply to the same
    # params: they differ by at most 2 lr (a vanishing gradient whose sign
    # differs), plus rounding
    check(dp <= 2 * LM_LR + 1e-6, f"params after one step differ by {dp}")
    check(after_rel < LM_CARD_CPU_STEP_LOSS_REL, f"loss after one step: "
          f"card {after} vs CPU {cafter} (rel {after_rel:.3g})")
    del state, cstate, params, cpu_params
    torch.cuda.empty_cache()
    log(f"phase 16 (e) card vs CPU (f32, full width, {LM_CARD_CPU_LAYERS} "
        f"layers, B=2, S=64): loss rel {loss_rel:.3g}, worst gradient leaf "
        f"{worst} rel {grad_rel[worst]:.3g}; after one adamw step params "
        f"max |diff| {dp:.3g} ({rel_dp:.3g} of the update), loss rel "
        f"{after_rel:.3g}")
    return info


def _flat_named(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat_named(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _lm_train_ckpt(dev):
    """(f) --ckpt-dir/--ckpt-every 5 for 10 steps at full width cut to 2
    layers, then --resume for 5 more: the restored state equals the saved
    one bit for bit, and the resumed run's first loss equals a step of the
    saved state in process. The launcher's checkpoint times: the memory
    tier (the reference's tree stacked on the host, then copied), the disk
    persist, the restore onto the card."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core.flash_checkpoint import FlashCheckpoint
    from repro_torch.train import state_tree, trainer
    tmp = Path(tempfile.mkdtemp(prefix="lm_ckpt_", dir=ROOT / "build"))
    try:
        ck = str(tmp / "run")
        argv = LM_TRAIN_ARGV + ["--layers", str(LM_CKPT_LAYERS),
                                "--ckpt-dir", ck, "--ckpt-every", "5"]
        first, _ = _driven(argv + ["--steps", "10"], ())
        check(sorted(os.listdir(ck)) == ["ckpt_000000000005",
                                         "ckpt_000000000010"],
              f"blobs {sorted(os.listdir(ck))}")
        cfg, api, opt = first.cfg, first.api, first.opt
        disk = FlashCheckpoint(ck)
        restored, _ = disk.restore(state_tree.lm_like_tree(api, opt), 10)
        restored = state_tree.lm_from_tree(restored, cfg, dev)
        saved, back = _flat_named(first.state), _flat_named(restored)
        check(set(saved) == set(back), "restored leaves differ")
        for k, v in saved.items():
            same = torch.equal(back[k], v) and back[k].dtype == v.dtype \
                if torch.is_tensor(v) else back[k] == v
            check(same, f"restored leaf {k} differs from the saved one")
        del restored, back
        resumed, _ = _driven(argv + ["--steps", "5", "--resume"], ())
        check(resumed.restored_step == 10 and resumed.state["step"] == 15,
              f"resumed from {resumed.restored_step} to "
              f"{resumed.state['step']}")
        batch = _lm_batch(cfg, dev, 8, 64)            # samples 0-7 again
        _, m = trainer.make_train_step(api, opt, remat=True)(first.state,
                                                             batch)
        check(float(m["loss"]) == resumed.losses[0], f"resumed first loss "
              f"{resumed.losses[0]} vs in process {float(m['loss'])}")
        n_bytes = sum(v.numel() * v.element_size()
                      for v in saved.values() if torch.is_tensor(v))
        info = {"layers": LM_CKPT_LAYERS, "state_bytes": n_bytes,
                "losses": first.losses, "resumed_losses": resumed.losses,
                "memory_tier_s": first.ckpt_seconds["memory_tier"]
                + resumed.ckpt_seconds["memory_tier"],
                "persist_s": [first.ckpt_seconds["persist"],
                              resumed.ckpt_seconds["persist"]],
                "restore_disk_s": disk.last_restore_seconds,
                "resume_onto_card_s": resumed.ckpt_seconds["restore"]}
        del first, resumed, saved
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"phase 16 (f) checkpoint ({LM_CKPT_LAYERS} layers, "
        f"{info['state_bytes'] / 1e9:.2f} GB): restored bit for bit, resumed "
        f"first loss equal; memory tier "
        f"{', '.join(f'{x * 1e3:.0f}' for x in info['memory_tier_s'])} ms, "
        f"persist {', '.join(f'{x:.2f}' for x in info['persist_s'])} s, "
        f"restore {info['restore_disk_s']:.2f} s from disk, resume onto the "
        f"card {info['resume_onto_card_s']:.2f} s")
    return info


def phase_lm_train(report, dev):
    """Phase 16: LM training on the card."""
    t0 = time.perf_counter()
    line = _lm_train_full(report, dev)
    line["families"] = _lm_train_families(dev)
    line["card_vs_cpu"] = _lm_train_card_cpu(dev)
    line["checkpoint"] = _lm_train_ckpt(dev)
    line["seconds"] = time.perf_counter() - t0
    report["lm_train"] = line
    log(f"phase 16 LM training: {line['seconds']:.1f} s")
    return line


# ---------------------------------------------------------------------------
# phase 17: the single-table embedding bag on K1, the batched-serving
# example, the one-card cost tool, and K3 inside the fused adam step
# ---------------------------------------------------------------------------
BAG_B = 512                       # (a): Wide&Deep's batch, one table
BAG_N = 4                         # its multi_hot: K1's vector / wide routes
BAG_N_GENERIC = 3                 # any other n: the generic route
BAG_ALPHA = 1.05
SERVE_ARCHS = ("llama3.2-3b", "mamba2-2.7b")
COST_TRAIN = (8, 64)              # (c): phase 16's train shape (B, S)
COST_CELL = "train_4k"
# the adam step's kernels, by fragments of the names the profiler gives them
PROFILED_ADAM_KERNELS = {
    "K1 D=16": ("bag_vec16_kernel",),
    "K1 D=1": ("bag_wide_kernel",),
    "K3 D=16": ("rows_vec16_kernel", "AdamOp"),
    "K3 D=1": ("rows_wide_kernel", "AdamOp"),
}


def _bag_inputs(dev, R, n, seed):
    """(BAG_B, n) zipf(BAG_ALPHA) int32 ids over ``R`` rows and weights in
    [0.5, 1.5), on the card."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import zipf_indices
    rng = np.random.default_rng(seed)
    idx = zipf_indices(rng, R, (BAG_B, n), BAG_ALPHA).astype(np.int32)
    w = rng.random((BAG_B, n)).astype(np.float32) + 0.5
    return torch.from_numpy(idx).to(dev), torch.from_numpy(w).to(dev)


def _bag_cases(dev):
    """(a) ``ops.embedding_bag`` on the card: the largest Wide&Deep table
    at D=16 and D=1, n=4 (vector / wide route) and n=3 (generic route),
    sum/mean/max, unweighted and weighted. The counts are set to 0 just
    before the calls and read just after: one K1 launch per call. Each
    output is then held to K1's plain version on the same inputs, bit for
    bit (K1_ULP)."""
    import torch
    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.kernels import fused_embedding as fe
    from repro_torch.sharding.policy import EmbeddingPlan
    R = max(_full_cfg().table_rows)
    gen = torch.Generator(device=dev).manual_seed(17)
    tables = {D: torch.randn((R, D), generator=gen, device=dev)
              for D in (16, 1)}
    inputs = {n: _bag_inputs(dev, R, n, seed=n) for n in (BAG_N,
                                                          BAG_N_GENERIC)}
    cases = [(D, n, c, weighted) for D in (16, 1)
             for n in (BAG_N, BAG_N_GENERIC) for c in ("sum", "mean", "max")
             for weighted in (False, True)]
    cuda_lib.reset_launches()
    outs = []
    for D, n, c, weighted in cases:
        idx, w = inputs[n]
        outs.append(ops.embedding_bag(tables[D], idx, w if weighted else None,
                                      plan=EmbeddingPlan(combiner=c)))
    torch.cuda.synchronize()
    counts = dict(cuda_lib.LAUNCHES)
    check(counts["fused_embedding_bag"] == len(cases) and sum(
        counts.values()) == len(cases), f"phase 17 (a): {len(cases)} calls "
          f"launched {counts}, want one K1 launch each")
    max_ulp, max_err, routes = 0, 0.0, {}
    for (D, n, c, weighted), got in zip(cases, outs):
        idx, w = inputs[n]
        enc = idx[:, None, :].contiguous()
        ww = w[:, None, :].contiguous() if weighted else None
        want = fe.embedding_bag_plain(tables[D], enc, ww, None, c)[:, 0]
        tag = f"K1 single table D={D} n={n} {c} weighted={weighted}"
        u = ulp_distance(got, want)
        check(u <= K1_ULP, f"{tag}: {u} ULP > {K1_ULP}")
        max_ulp = max(max_ulp, u)
        max_err = max(max_err, float((got - want).abs().max()))
        route = fe.bag_route(D, n, tables[D], enc, got, *(
            [ww] if weighted else []))
        want_route = ("vector" if D == 16 else "wide") if n == BAG_N \
            else "generic"
        check(route == want_route, f"{tag}: {route} route, want "
              f"{want_route}")
        routes[f"D={D} n={n}"] = route
    return {"rows": R, "batch": BAG_B, "zipf_alpha": BAG_ALPHA,
            "cases": len(cases), "launches": counts["fused_embedding_bag"],
            "max_ulp": max_ulp, "ulp_bound": K1_ULP, "max_abs_err": max_err,
            "routes": routes, "timing": _time_bag(dev, tables, inputs)}


def _time_bag(dev, tables, inputs):
    """K1 through ``ops.embedding_bag`` (unweighted sum, n=4) on both
    widths, timed as in phase 5 beside the kernel alone, its plain version,
    ``F.embedding_bag`` (one library call of the same function) and the
    bytes bound: the distinct rows read, the ids and the output."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import fused_embedding as fe
    from repro_torch.sharding.policy import EmbeddingPlan
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    plan = EmbeddingPlan(combiner="sum")
    idx, _ = inputs[BAG_N]
    enc = idx[:, None, :].contiguous()
    out = {}
    for D, table in tables.items():
        lib = F.embedding_bag(idx.long(), table, mode="sum")
        ours = ops.embedding_bag(table, idx, plan=plan)
        check(float((lib - ours).abs().max()) < 1e-5,
              f"embedding_bag yardstick at D={D} computes another function")
        w_ms = time_ms(lambda: ops.embedding_bag(table, idx, plan=plan),
                       flush)
        k_ms = time_ms(lambda: fe.embedding_bag_cuda(table, enc, None, None,
                                                     "sum"), flush)
        p_ms = time_ms(lambda: fe.embedding_bag_plain(table, enc, None, None,
                                                      "sum"), flush)
        l_ms = time_ms(lambda: F.embedding_bag(idx.long(), table,
                                               mode="sum"), flush)
        n_rows = int(torch.unique(idx).numel())
        n_bytes = n_rows * D * 4 + idx.numel() * 4 + BAG_B * D * 4
        b_ms, b_by = bound_ms(n_bytes, idx.numel() * D)
        out[D] = {"ms": k_ms, "wrapper_ms": w_ms, "plain_ms": p_ms,
                  "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
                  "distinct_rows": n_rows, "bytes": n_bytes,
                  "route": fe.bag_route(D, BAG_N, table, enc, ours)}
    return out


def _load_serve_example():
    """``examples/serve_batched_torch.py`` as a module."""
    import importlib.util
    path = ROOT / "examples" / "serve_batched_torch.py"
    spec = importlib.util.spec_from_file_location("serve_batched_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _example_tokens(stdout):
    """``{rid: tokens}`` from the example's ``  req i: [...]`` lines."""
    out = {}
    for line in stdout.splitlines():
        if line.startswith("  req "):
            rid, toks = line[len("  req "):].split(": ", 1)
            out[int(rid)] = json.loads(toks)
    return out


def _serve_example(dev, procs):
    """(b) the example as subprocesses (``procs``, already started) on the
    card and on the CPU: each exits 0 and the card's
    tokens equal the CPU's; then its ``serve`` in process on the card with
    the counts set to 0 just before and read just after: llama launches K5
    and nothing else, mamba2 nothing."""
    import torch
    from repro_torch.kernels import cuda_lib
    ex = _load_serve_example()
    info = {}
    for arch in SERVE_ARCHS:
        runs = {}
        for device in ("cuda", "cpu"):
            proc = procs[(arch, device)]
            stdout, stderr = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"serve_batched_torch --arch {arch} "
                  f"--device {device} exited {proc.returncode}: "
                  f"{stderr[-2000:]}")
            runs[device] = _example_tokens(stdout)
        check(runs["cuda"] == runs["cpu"] and runs["cuda"], f"{arch}: card "
              f"tokens {runs['cuda']} != CPU tokens {runs['cpu']}")
        cfg = ex.reduce_config(ex.get_arch(arch))
        params = ex.tf.params_to(ex.build_model(cfg).init(
            torch.Generator().manual_seed(ex.SEED)), dev)
        reqs = ex.make_requests(cfg, 6)
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        outs, steps = ex.serve(cfg, params, reqs, 3, dev)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = dict(cuda_lib.LAUNCHES)
        got = {rid: c.tokens for rid, c in outs.items()}
        check(got == runs["cuda"], f"{arch}: in-process tokens differ from "
              "the subprocess's")
        if arch == "llama3.2-3b":
            check(counts["decode_attention"] > 0 and sum(counts.values()) ==
                  counts["decode_attention"], f"{arch} launched {counts}, "
                  "want K5 only")
        else:
            check(sum(counts.values()) == 0, f"{arch} launched {counts}")
        n_tok = sum(len(t) for t in got.values())
        info[arch] = {"tokens": n_tok, "engine_steps": steps,
                      "in_process_s": sec, "launches": counts,
                      "card_equals_cpu": True}
        log(f"phase 17 (b) {arch}: card tokens == CPU tokens ({n_tok} "
            f"tokens, {steps} engine steps, {sec:.2f} s in process); "
            f"launches {counts}")
        del params
    return info


def _cost_tool(lm_train_line, cost_proc, smi):
    """(c) the cost tool on full-width llama3.2-3b, on meta tensors on the
    host: phase 16's train shape in process, ``train_4k`` through the CLI
    (``cost_proc``); the step's shares of the bf16 dense peak and of the
    HBM bandwidth at phase 16's measured median step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import costs
    cfg = get_arch(LM_ARCH)
    B, S = COST_TRAIN
    shape = ShapeConfig("phase16", S, B, "train")
    t0 = time.perf_counter()
    flops = costs.step_flops(cfg, shape)
    count_s = time.perf_counter() - t0
    hbm = costs.analytic_hbm_bytes(cfg, shape, costs.param_bytes(cfg), flops)
    mflops = costs.model_flops(cfg, shape)
    step_ms = lm_train_line["launcher"]["median_step_ms_3_10"]
    sec = step_ms / 1e3
    b_ms, b_by = bound_ms(hbm["total"], flops, BF16_FLOP_PER_S)
    info = {"arch": LM_ARCH, "batch": B, "seq": S, "model_flops": mflops,
            "step_flops": flops, "count_s": count_s, "analytic_hbm": hbm,
            "step_ms_phase16": step_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bf16_peak_share": flops / sec / BF16_FLOP_PER_S,
            "hbm_share": hbm["total"] / sec / HBM_BYTES_PER_S,
            "peaks": {"bf16_flop_per_s": BF16_FLOP_PER_S,
                      "hbm_bytes_per_s": HBM_BYTES_PER_S}, "card": smi}
    stdout, stderr = cost_proc.communicate(timeout=600)
    check(cost_proc.returncode == 0, f"repro_torch.launch.costs exited "
          f"{cost_proc.returncode}: {stderr[-2000:]}")
    cell = json.loads(stdout.strip().splitlines()[-1])
    check("error" not in cell and cell["step_flops"] > cell["model_flops"]
          > 0, f"cost cell {cell}")
    info[COST_CELL] = cell
    log(f"phase 17 (c) {LM_ARCH} B={B} S={S}: {flops / 1e12:.4f} TFLOP "
        f"counted (6·N·tokens {mflops / 1e12:.4f}; counted in "
        f"{count_s:.1f} s on the host), HBM {hbm['total'] / 1e9:.2f} GB; at "
        f"phase 16's {step_ms:.1f} ms: {info['bf16_peak_share']:.4f} of the "
        f"bf16 peak, {info['hbm_share']:.4f} of the HBM bandwidth (bound "
        f"{b_ms:.2f} ms by {b_by}; {smi})")
    log(f"phase 17 (c) {LM_ARCH} {COST_CELL}: "
        f"{cell['step_flops'] / 1e15:.4f} PFLOP counted, 6·N·tokens "
        f"{cell['model_flops'] / 1e15:.4f}, HBM "
        f"{cell['analytic_hbm']['total'] / 1e9:.1f} GB")
    return info


def _adam_profile(report, dev):
    """(d) K3 inside the fused adam step: the launcher's 5 adam steps
    (counts set to 0 before, read after), then phase 6's profile of that
    step."""
    log("phase 17 (d) slice: 5 steps, fused update, adam")
    run, counts = _driven(SLICE_FLAGS + ["--fused-update", "--optimizer",
                                         "adam", "--steps", "5"],
                          ("fused_embedding_bag", "adam_row_update"))
    info = phase_profile(report, dev, run, kernels=PROFILED_ADAM_KERNELS,
                         tag="phase 17 (d)", key="profile_adam")
    info["launches"] = counts
    del run
    return info


def phase_single_table(report, dev, lm_train_line, smi):
    """Phase 17: (a) the single-table bag on K1, (d) K3's profile inside
    the adam step, (c) the cost tool, (b) the batched-serving example. The
    cost CLI's subprocess (host only) starts first; the example's start
    after (a) and (d), so that no other process uses the card while those
    are timed, and run beside (c)'s count on the host."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cost_proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.costs", "--arch", LM_ARCH,
         "--shape", COST_CELL], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    procs = {}
    try:
        line = {"bag": _bag_cases(dev)}
        bag = line["bag"]
        for D, t in bag["timing"].items():
            log(f"phase 17 (a) K1 single table D={D} ({t['route']} route, "
                f"{bag['rows']:,} rows, B={BAG_B}, n={BAG_N}): kernel "
                f"{t['ms'] * 1e3:.2f} us, through ops.embedding_bag "
                f"{t['wrapper_ms'] * 1e3:.2f} us, plain "
                f"{t['plain_ms'] * 1e3:.1f} us, F.embedding_bag "
                f"{t['library_ms'] * 1e3:.2f} us, bound "
                f"{t['bound_ms'] * 1e3:.3f} us ({t['distinct_rows']} "
                "distinct rows)")
        log(f"phase 17 (a) {bag['cases']} single-table calls, "
            f"{bag['launches']} K1 launches, max {bag['max_ulp']} ULP from "
            f"the plain version (bound {K1_ULP}); routes {bag['routes']}")
        line["profile_adam"] = _adam_profile(report, dev)
        procs.update({(arch, device): subprocess.Popen(
            [sys.executable, str(ROOT / "examples" /
                                 "serve_batched_torch.py"),
             "--arch", arch, "--device", device], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for arch in SERVE_ARCHS for device in ("cuda", "cpu")})
        line["costs"] = _cost_tool(lm_train_line, cost_proc, smi)
        line["serve_example"] = _serve_example(dev, procs)
    finally:
        for p in list(procs.values()) + [cost_proc]:
            if p.poll() is None:
                p.kill()
                p.wait()
    line["seconds"] = time.perf_counter() - t0
    report["single_table"] = line
    log(f"phase 17: {line['seconds']:.1f} s")
    return line


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; the port's kernels "
              "run only on a CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"FAIL: {SRC / 'repro_torch'} not found; run chip_smoke.py "
              "from the root of a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report = {"card": None}
    t0 = time.perf_counter()
    try:
        phase_build(report)
        smi = nvidia_smi_line()
        report["card"] = smi
        log(smi)
        errs = {"k1": phase_k1(report, dev)}
        errs["k2_k3"] = phase_k2_k3(report, dev)
        run, c_main, c_adam, slice_info = phase_slice(report, dev)
        kernels = phase_timing(report, dev, run, c_main, c_adam, errs)
        slice_info["profile"] = phase_profile(report, dev, run)
        del run
        torch.cuda.empty_cache()
        replan_line = phase_replan(report, dev,
                                   slice_info["launcher_steps_per_s"])
        lm_errs = phase_lm_kernels(report, dev)
        k4_counts, fwd = phase_lm_forward_decode(report, dev)
        card_cpu = phase_lm_card_cpu(report, dev)
        k5_counts, served = phase_lm_serve(report, dev)
        kernels += phase_lm_timing(report, dev, k4_counts, k5_counts,
                                   lm_errs)
        torch.cuda.empty_cache()
        selfheal_line, selfheal_counts, selfheal_timings = phase_selfheal(
            report, dev)
        torch.cuda.empty_cache()
        lifecycle_line = phase_lifecycle(report)
        sim_line = phase_sim(report, selfheal_timings)
        torch.cuda.empty_cache()
        zoo_line = phase_zoo(report, dev)
        torch.cuda.empty_cache()
        lm_train_line = phase_lm_train(report, dev)
        torch.cuda.empty_cache()
        single_line = phase_single_table(report, dev, lm_train_line, smi)
        for entry in kernels:
            name = entry["name"].split()[1]
            if name in selfheal_counts and name in (
                    "fused_embedding_bag", "adagrad_row_update",
                    "adam_row_update"):
                entry["launches_selfheal"] = selfheal_counts[name]
            if name == "fused_embedding_bag":
                entry["launches_lifecycle"] = lifecycle_line["launches"][name]
                entry["launches_single_table"] = single_line["bag"][
                    "launches"]
                entry["max_abs_err_single_table"] = single_line["bag"][
                    "max_abs_err"]
                entry["at_single_table"] = {
                    f"D={D}, n={BAG_N}, B={BAG_B}": t
                    for D, t in single_line["bag"]["timing"].items()}
            if name == "adam_row_update":
                entry["in_step_us_per_call"] = {
                    k: v["us_per_call"] for k, v in single_line[
                        "profile_adam"]["kernel_us_per_call"].items()}
            if name == "flash_attention":
                entry["launches_lm_train"] = {
                    "train_step": lm_train_line["launcher"]["launches"][name]
                    // LM_TRAIN_STEPS,
                    "eval": lm_train_line["eval"]["launches"][name]}
                entry["launches_lm_zoo_eval"] = {
                    ZOO_EVAL_ARCH: zoo_line["models"][ZOO_EVAL_ARCH]["eval"][
                        "launches"][name]}
            if name in ("flash_attention", "decode_attention"):
                entry["launches_lm_zoo"] = _zoo_launches(zoo_line, name)
                entry["max_abs_err_lm_zoo"] = zoo_line["max_abs_err"][name]
                entry["at_lm_zoo_shapes"] = [
                    {k: v for k, v in r.items() if k != "kernel"}
                    for r in zoo_line["timing"]
                    if r["kernel"] == entry["name"].split()[0]]
        lm_info = {"arch": LM_ARCH, "forward_vs_decode_rel": fwd[
            "rel_max_diff"], "card_vs_cpu_rel": card_cpu, "serve": served,
            "decode_profile": fwd["decode_profile"]}
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 1
    finally:
        report["seconds"] = time.perf_counter() - t0
        out_dir = ROOT / "build"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(
            json.dumps(report, indent=1, default=str))
    log(f"card: {smi}; total {report['seconds']:.1f} s")
    print(json.dumps({"slice": slice_info}))
    print(json.dumps({"lm": lm_info}))
    print(json.dumps({"replan": replan_line}))
    print(json.dumps({"selfheal": selfheal_line}))
    print(json.dumps({"lifecycle": lifecycle_line}))
    print(json.dumps({"sim": sim_line}))
    print(json.dumps({"lm_zoo": zoo_line}))
    print(json.dumps({"lm_train": lm_train_line}))
    print(json.dumps({"single_table": single_line}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
