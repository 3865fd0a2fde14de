#!/usr/bin/env python3
"""Time K4 (flash attention) at the LM zoo's shapes, recurrentgemma-2b's
eval step and whisper-medium's decode step, for one tree of the port.

    python3 scripts/k4_turns.py [--src DIR] [--label NAME] [--eval-steps N]
                                [--decode-steps N]

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
``--src`` imports ``repro_torch`` from another tree's ``src`` (a parent
commit unpacked with ``git archive`` under ``build/``), so that two trees
are compared in one call, in turns (parent, change, change, parent); the
timing helpers always come from this checkout's ``chip_smoke.py``.

For each shape it launches ``flash_attention_cuda`` (the route that tree's
``tc_route`` picks), holds it against the plain version within
``chip_smoke.ATTN_TOL``, and records its median time
(``chip_smoke.time_ms``: 50 launches, the L2 evicted before each) beside
``F.scaled_dot_product_attention``'s (the yardstick; the port never calls
it) and the bound, with the tree's ``split_plan`` count (1 for a tree
that has none) and each K4 kernel's device time per call from a
``torch.profiler`` window of 20 calls. At recurrentgemma's local shape it also times the SIMT
kernel on the same bf16 inputs through its C entry point, the route that
bf16 at head dim 256 took before the tensor-core kernel took it. Then
recurrentgemma-2b at full width and depth (seeded random bf16 weights):
its eval step (``trainer.make_eval_step``) at B=1, S=2048 on an
``lm_batch``, K4 launches counted over one step, and the median of
``--eval-steps`` synchronised steps after one warm-up step. Last
whisper-medium at full width and depth (seeded random bf16 weights,
1,500 random frames through ``fill_cross_cache``): one warm-up decode
step, then the median of ``--decode-steps`` synchronised decode steps
(each ending in the serving engine's argmax), launches counted over them,
and K4's device time per step (the union of its kernels' spans) from a
``torch.profiler`` window of 4 more steps.

Prints the card's name and power limit, one line per measurement, and
last one JSON object with every number.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EVAL_ARCH = "recurrentgemma-2b"
EVAL_SEQ = 2048
DECODE_ARCH = "whisper-medium"
PROFILE_CALLS = 20
PROFILE_STEPS = 4
# tag, B, Sq, Skv, Hq, Hkv, D, causal, window, dtype
SHAPES = (
    ("recurrentgemma local", 1, 2048, 2048, 10, 1, 256, True, 2048,
     "bfloat16"),
    ("recurrentgemma local, f32", 1, 2048, 2048, 10, 1, 256, True, 2048,
     "float32"),
    ("llama3.2-3b", 1, 2048, 2048, 24, 8, 128, True, None, "bfloat16"),
    ("whisper encoder", 1, 1500, 1500, 16, 16, 64, False, None, "bfloat16"),
    ("whisper cross-attention", 1, 1, 1500, 16, 16, 64, False, None,
     "bfloat16"),
    ("whisper cross-attention, teacher-forced", 1, 16, 1500, 16, 16, 64,
     False, None, "bfloat16"),
)


def k4_device_us(prof):
    """K4's kernels (the tensor-core and SIMT kernels) in a
    ``torch.profiler`` window: {kernel name: (device us, calls)}."""
    import torch
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or "flash_" not in evt.key:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        out[evt.key[:60]] = (us, evt.count)
    return out


def k4_busy_us(prof):
    """The device time in a ``torch.profiler`` window during which some K4
    kernel ran: the union of their spans, in us (kernels that overlap count
    once)."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "flash_" in e.name)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def profile_calls(fn, flush, n):
    """K4's kernels' device us per call over ``n`` calls, the L2 evicted
    before each, by kernel and (``busy``) as the union of their spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {k: us / n for k, (us, _) in k4_device_us(prof).items()}
    out["busy"] = k4_busy_us(prof) / n
    return out


def time_shapes(cs, dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import flash_attention as fa
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(16)
    rows = []
    for tag, B, Sq, Skv, Hq, Hkv, D, causal, window, dtype in SHAPES:
        q = cs._randn(gen, (B, Sq, Hq, D), dtype, dev)
        k = cs._randn(gen, (B, Skv, Hkv, D), dtype, dev)
        v = cs._randn(gen, (B, Skv, Hkv, D), dtype, dev)
        kw = dict(causal=causal, window=window)
        plan = getattr(fa, "split_plan", None)
        n_split = 1 if plan is None else plan(q.dtype, B, Sq, Hq, Skv, D)
        want = fa.flash_attention_plain(q, k, v, **kw)
        err = cs._attn_err(f"K4 {tag}", fa.flash_attention_cuda(q, k, v, **kw),
                           want, cs.ATTN_TOL[dtype])
        row = {"at": f"{tag}: B={B} Sq={Sq} Skv={Skv} Hq={Hq} Hkv={Hkv} "
               f"D={D} {dtype} causal={causal} window={window}",
               "route": "tensor-core" if fa.tc_route(q, k) else "simt",
               "n_split": n_split, "max_abs_err": err,
               "ms": cs.time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                                flush),
               "kernel_us": profile_calls(
                   lambda: fa.flash_attention_cuda(q, k, v, **kw), flush,
                   PROFILE_CALLS)}
        if D == 256 and dtype == "bfloat16":
            lib = cuda_lib.load()
            out = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream

            def simt():
                cuda_lib.check(lib.repro_flash_attention(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, Sq, Skv, Hq, Hkv, D, 0, int(causal),
                    -1 if window is None else window, 0.0, D ** -0.5, 1,
                    stream), "flash_attention")

            simt()
            torch.cuda.synchronize()
            row["simt_bf16_max_abs_err"] = cs._attn_err(
                f"K4 SIMT {tag}", out, want, cs.ATTN_TOL[dtype])
            row["simt_bf16_ms"] = cs.time_ms(simt, flush)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        # window >= Skv masks nothing beyond causality here
        row["sdpa_ms"] = cs.time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), flush)
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
        flops = 4 * D * Hq * B * pairs
        n_bytes = q.element_size() * 2 * B * (Sq * Hq + Skv * Hkv) * D
        row["bound_ms"], row["bound_by"] = cs.bound_ms(
            n_bytes, flops, cs.BF16_FLOP_PER_S if dtype == "bfloat16"
            else cs.F32_FLOP_PER_S)
        rows.append(row)
        print(f"{row['at']}: {row['route']} n_split={n_split} "
              f"{row['ms']:.4f} ms"
              + (f" (SIMT bf16 {row['simt_bf16_ms']:.4f})"
                 if "simt_bf16_ms" in row else "")
              + f", SDPA {row['sdpa_ms']:.4f}, bound {row['bound_ms']:.4f} "
              f"by {row['bound_by']}, max abs err {err:.3g}; profiler us "
              f"per call {row['kernel_us']}", flush=True)
        del q, k, v, qt, kt, vt, want
    return rows


def time_eval(cs, dev, n_steps):
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import cuda_lib
    from repro_torch.models.registry import build_model
    from repro_torch.train import trainer
    cfg = get_arch(EVAL_ARCH)
    api = build_model(cfg)
    state = {"params": api.init(torch.Generator(device=dev).manual_seed(0))}
    batch = cs._lm_batch(cfg, dev, 1, EVAL_SEQ)
    step = trainer.make_eval_step(api)
    cuda_lib.reset_launches()
    loss = float(step(state, batch))
    counts = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    ms = []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(state, batch))
        ms.append((time.perf_counter() - t0) * 1e3)
    med = sorted(ms)[len(ms) // 2]
    print(f"{EVAL_ARCH} eval step B=1 S={EVAL_SEQ}: loss {loss:.5f}, "
          f"launches {counts}, median {med:.2f} ms of {ms}", flush=True)
    return {"arch": EVAL_ARCH, "batch": 1, "seq": EVAL_SEQ, "loss": loss,
            "launches": counts, "step_ms": ms, "median_ms": med}


def time_decode(cs, dev, n_steps):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import encdec
    from repro_torch.models.registry import build_model
    cfg = get_arch(DECODE_ARCH)
    api = build_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = cs._randn(gen, (1, cfg.n_frames, cfg.d_model), "bfloat16", dev)
    n_tok = 1 + n_steps + PROFILE_STEPS
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, n_tok)).astype(np.int32)).to(dev)
    cache = api.init_cache(1, n_tok, torch.float32, dev)
    encdec.fill_cross_cache(params, cache, frames, cfg)

    def step(t):
        nonlocal cache
        logits, cache = api.decode_step(params, cache, toks[:, t:t + 1])
        return int(torch.argmax(logits[0, -1]))        # the engine's sync

    step(0)                                            # warm-up
    cuda_lib.reset_launches()
    ms = []
    for t in range(1, 1 + n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(t)
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(1 + n_steps, n_tok):
            step(t)
        torch.cuda.synchronize()
    k4 = k4_device_us(prof)
    k4_us = k4_busy_us(prof) / PROFILE_STEPS
    med = sorted(ms)[len(ms) // 2]
    print(f"{DECODE_ARCH} decode step B=1 ({cfg.n_frames} frames): launches "
          f"over {n_steps} steps {counts}, median {med:.2f} ms of {ms}; K4 "
          f"device {k4_us:.1f} us per step ({k4})", flush=True)
    return {"arch": DECODE_ARCH, "batch": 1, "launches": counts,
            "step_ms": ms, "median_ms": med, "k4_device_us_per_step": k4_us,
            "k4_kernels": {k: {"us_per_step": us / PROFILE_STEPS,
                               "calls_per_step": c / PROFILE_STEPS}
                           for k, (us, c) in k4.items()}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--eval-steps", type=int, default=5)
    ap.add_argument("--decode-steps", type=int, default=16)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    import chip_smoke as cs
    import repro_torch
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.nvidia_smi_line()
    print(f"{args.label}: repro_torch from {Path(repro_torch.__file__).parent}"
          f"; {card}", flush=True)
    out = {"label": args.label, "card": card,
           "k4": time_shapes(cs, dev),
           "eval": time_eval(cs, dev, args.eval_steps),
           "decode": time_decode(cs, dev, args.decode_steps)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
