#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA. It imports nothing of JAX or of ``repro``.
Phases, each of which fails the run (exit 1, no ``ok`` line):

1. build: compile K1-K3 from ``src/repro_torch/csrc`` into ``build/``;
   print the card's name and power limit (``nvidia-smi``).
2. K1 against its plain version on the card at the full Wide&Deep shapes
   (B=512, T=26, H=4, R=3,294,238, D=16 and the wide D=1), over
   sum/mean/max x weighted/unweighted x cache off/64/26*512 rows x flat/
   padded (n_ps=4): max exact, sum/mean within K1_ULP; cache-on and padded
   outputs equal cache-off flat outputs bit for bit.
3. K2 and K3 against their plain versions on the deduped rows of a real
   full-width batch, from fresh and from carried moment pools: params
   within 64 ULP, moments within 4 ULP; rows not touched stay
   bit-identical.
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
6. a ``torch.profiler`` breakdown of the fused adagrad step: device time,
   idle share and the kernels that take the most device time.

Prints the ``kernels`` JSON line, a ``slice`` JSON line, and last
``{"ok": true, "device": {...}}``. Full details go to
``build/chip_smoke.json``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

K1_ULP = 2            # K1 vs plain, sum/mean (both are unfused, same order)
PARAM_ULP = 64        # K2/K3 vs plain, params (the bounds of the
MOMENT_ULP = 4        # reference's fused-update tests), moments
LOSS_ATOL = 1e-4      # card vs CPU loss, 3 full-width steps
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published peak at 700 W
F32_FLOP_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
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


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOP_PER_S * 1e3
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
def phase_build(report):
    from repro_torch.kernels import cuda_lib
    t0 = time.perf_counter()
    lib = cuda_lib.build()
    cuda_lib.load()
    report["build"] = {"seconds": time.perf_counter() - t0,
                       "library": str(lib.relative_to(ROOT)),
                       "log": cuda_lib.build_log()}
    log(f"phase 1 build: {lib.name} in {report['build']['seconds']:.1f} s")
    for line in (cuda_lib.build_log() or "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")


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
                        if combiner == "max":
                            check(torch.equal(got, want), f"{tag}: max differs")
                        else:
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
                    "max_ulp_sum_mean": max_ulp, "ulp_bound": K1_ULP}
    log(f"phase 2 K1: {n_checked} variants agree with the plain version "
        f"(max {max_ulp} ULP, bound {K1_ULP}; max exact; cache and padded "
        "outputs bit-identical)")
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
    PARAM_ULP and moments within MOMENT_ULP ULPs (the kernels avoid FMA
    contraction, so 0 is expected); untouched rows stay bit-identical.
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
                          ("fused_embedding_bag", "adagrad_row_update"))
    log("phase 4 slice: 5 steps, fused update, adam")
    _, c_adam = _driven(SLICE_FLAGS + ["--fused-update", "--optimizer",
                                       "adam", "--steps", "5"],
                        ("fused_embedding_bag", "adam_row_update"))
    log("phase 4 slice: 5 steps, dense path")
    _, c_dense = _driven(SLICE_FLAGS + ["--steps", "5"],
                         ("fused_embedding_bag",))

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
    import torch.nn.functional as F
    from repro_torch.kernels import fused_embedding as fe
    from repro_torch.kernels import fused_update as fu
    from repro_torch.models.dlrm import _pool2d

    cfg, plan = run.cfg, run.plan
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    batch = _real_batch(cfg, dev)
    idx = batch["sparse"]
    B, T, H = idx.shape
    N = B * T * H
    kernels = []

    # K1 on the main path: the deep pool, unweighted sum, 64 hot rows, padded
    pool = _pool2d(run.state["params"]["tables"], plan.layout)
    D = pool.shape[1]
    enc, cache = fe.kernel_inputs(pool, idx, plan)
    k_ms = time_ms(lambda: fe.embedding_bag_cuda(pool, enc, None, cache,
                                                 "sum"), flush)
    p_ms = time_ms(lambda: fe.embedding_bag_plain(pool, enc, None, cache,
                                                  "sum"), flush)
    # the yardstick: one library call on the same rows (cache-off indices)
    store_rows, _ = fe.kernel_inputs(
        pool, idx, dataclasses.replace(plan, table_hot=None))
    bag_idx = store_rows.reshape(B * T, H).long()
    ones = torch.ones(bag_idx.shape, device=dev)
    lib_out = F.embedding_bag(bag_idx, pool, mode="sum",
                              per_sample_weights=ones)
    ours = fe.embedding_bag_cuda(pool, enc, None, cache, "sum")
    check(float((lib_out.reshape(B, T, D) - ours).abs().max()) < 1e-5,
          "embedding_bag yardstick computes another function")
    l_ms = time_ms(lambda: F.embedding_bag(bag_idx, pool, mode="sum",
                                           per_sample_weights=ones), flush)
    cold = enc[enc >= 0]
    n_cold_rows = int(torch.unique(cold).numel())
    k1_bytes = (n_cold_rows * D * 4 + cache.numel() * 4 + N * 4
                + B * T * D * 4)
    k1_bound, k1_by = bound_ms(k1_bytes, N * D)
    kernels.append({
        "name": "K1 fused_embedding_bag", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_embedding.cu",
        "replaces": "src/repro/kernels/fused_embedding.py:249",
        "launches": c_main["fused_embedding_bag"], "max_abs_err": errs["k1"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": k1_bound,
        "bound_by": k1_by, "library_ms": l_ms})
    wide = _pool2d(run.state["params"]["wide"], plan.layout)
    wenc, wcache = fe.kernel_inputs(wide, idx, plan.with_combiner("sum"))
    wide_ms = time_ms(lambda: fe.embedding_bag_cuda(wide, wenc, None, wcache,
                                                    "sum"), flush)

    # K2/K3 on the deduped rows of the same batch (scratch copies of pools)
    p0, rows, vals = _sparse_rows(cfg, dev, D)
    R = p0.shape[0]
    n_live = int((rows < R).sum())
    acc = torch.rand(p0.shape, device=dev)
    p_k, a_k = p0.clone(), acc.clone()
    k2_ms = time_ms(lambda: fu.adagrad_rows_cuda(
        p_k, a_k, rows, vals, lr=3e-3, eps=1e-10), flush)
    k2_plain = time_ms(lambda: fu.adagrad_rows_plain(
        p_k, a_k, rows, vals, lr=3e-3, eps=1e-10), flush)
    k2_bound, k2_by = bound_ms(n_live * D * 4 * 5 + N * 4, n_live * D * 6)
    kernels.append({
        "name": "K2 adagrad_row_update", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_update.cu",
        "replaces": "src/repro/kernels/fused_update.py:72",
        "launches": c_main["adagrad_row_update"],
        "max_abs_err": errs["k2_k3"]["adagrad_row_update"],
        "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
        "bound_by": k2_by, "library_ms": None})
    bias = fu.adam_bias(7, 0.9, 0.999, dev)
    kw = dict(lr=3e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.0)
    m_k, v_k = acc.clone() - 0.5, acc.clone()
    k3_ms = time_ms(lambda: fu.adam_rows_cuda(p_k, m_k, v_k, rows, vals,
                                              bias, **kw), flush)
    k3_plain = time_ms(lambda: fu.adam_rows_plain(p_k, m_k, v_k, rows, vals,
                                                  bias, **kw), flush)
    k3_bound, k3_by = bound_ms(n_live * D * 4 * 7 + N * 4 + 8,
                               n_live * D * 14)
    kernels.append({
        "name": "K3 adam_row_update", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_update.cu",
        "replaces": "src/repro/kernels/fused_update.py:180",
        "launches": c_adam["adam_row_update"],
        "max_abs_err": errs["k2_k3"]["adam_row_update"],
        "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
        "bound_by": k3_by, "library_ms": None})
    report["kernels"] = kernels
    report["timing"] = {
        "l2_flushed": True, "iters": TIMING_ITERS,
        "k1_deep_cold_rows": n_cold_rows, "k1_deep_bytes": k1_bytes,
        "k1_wide_ms": wide_ms, "k2_k3_live_rows": n_live,
        "launches_per_step": {
            "fused_embedding_bag": c_main["fused_embedding_bag"] / 20,
            "adagrad_row_update": c_main["adagrad_row_update"] / 20,
            "adam_row_update": c_adam["adam_row_update"] / 5}}
    log(f"phase 5 timing: K1 {k_ms:.4f} ms (wide {wide_ms:.4f} ms), "
        f"K2 {k2_ms:.4f} ms, K3 {k3_ms:.4f} ms; "
        f"{n_live} live rows, {n_cold_rows} cold K1 rows")
    return kernels


def phase_profile(report, dev, run, n_steps=10):
    """Where the fused adagrad step's time goes: ``torch.profiler`` over
    ``n_steps`` steps with batches already on the card. Device time is the
    sum of the CUDA kernel and copy events (one stream, so they do not
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
    device = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        device.append((evt.key, us, evt.count))
    busy_us = sum(us for _, us, _ in device)
    top = sorted(device, key=lambda x: -x[1])[:10]
    ours = {name: [us / max(c, 1) for k, us, c in device if name in k]
            for name in ("fused_embedding_bag_kernel", "adagrad_rows_kernel")}
    info = {
        "kernel_us_per_call": {k: v for k, v in ours.items() if v},
        "steps": n_steps, "wall_ms_per_step": wall_us / n_steps / 1e3,
        "device_ms_per_step": busy_us / n_steps / 1e3,
        "device_idle_share": (1 - busy_us / wall_us) if device else None,
        "device_events_per_step": sum(c for *_, c in device) / n_steps,
        "top_device_time": [
            {"name": k[:90], "ms_per_step": us / n_steps / 1e3,
             "calls_per_step": c / n_steps} for k, us, c in top],
    }
    report["profile"] = info
    if not device:
        log("phase 6 profile: torch.profiler showed no device events")
    else:
        log(f"phase 6 profile: {info['wall_ms_per_step']:.3f} ms/step wall "
            f"(profiler on), {info['device_ms_per_step']:.3f} ms/step on the "
            f"device, idle share {info['device_idle_share']:.3f}, "
            f"{info['device_events_per_step']:.0f} device events/step")
        for t in info["top_device_time"]:
            log(f"  {t['ms_per_step']:.4f} ms x{t['calls_per_step']:.0f} "
                f"{t['name']}")
    return info


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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
