#!/usr/bin/env python3
"""Time K4 (flash attention) at the LM zoo's shapes, and recurrentgemma-2b's
eval step, for one tree of the port.

    python3 scripts/k4_turns.py [--src DIR] [--label NAME] [--eval-steps N]

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
it) and the bound. At recurrentgemma's local shape it also times the SIMT
kernel on the same bf16 inputs through its C entry point, the route that
bf16 at head dim 256 took before the tensor-core kernel took it. Then
recurrentgemma-2b at full width and depth (seeded random bf16 weights):
its eval step (``trainer.make_eval_step``) at B=1, S=2048 on an
``lm_batch``, K4 launches counted over one step, and the median of
``--eval-steps`` synchronised steps after one warm-up step.

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
)


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
        want = fa.flash_attention_plain(q, k, v, **kw)
        err = cs._attn_err(f"K4 {tag}", fa.flash_attention_cuda(q, k, v, **kw),
                           want, cs.ATTN_TOL[dtype])
        row = {"at": f"{tag}: B={B} Sq={Sq} Skv={Skv} Hq={Hq} Hkv={Hkv} "
               f"D={D} {dtype} causal={causal} window={window}",
               "route": "tensor-core" if fa.tc_route(q, k) else "simt",
               "max_abs_err": err,
               "ms": cs.time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                                flush)}
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
        print(f"{row['at']}: {row['route']} {row['ms']:.4f} ms"
              + (f" (SIMT bf16 {row['simt_bf16_ms']:.4f})"
                 if "simt_bf16_ms" in row else "")
              + f", SDPA {row['sdpa_ms']:.4f}, bound {row['bound_ms']:.4f} "
              f"by {row['bound_by']}, max abs err {err:.3g}", flush=True)
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--eval-steps", type=int, default=5)
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
           "eval": time_eval(cs, dev, args.eval_steps)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
