#!/usr/bin/env python3
"""Time K5 (decode attention) over split counts on one CUDA card.

    python3 scripts/k5_split_sweep.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
For each cache shape (the engine's bf16 q over an f32 cache, 24/8 heads of
128, every slot valid) it launches the kernel through its C entry point
with each split count, checks the output against the plain version and
prints the median time (``chip_smoke.time_ms``: 50 launches, the L2 evicted
before each) beside ``split_plan``'s choice. This is the measurement that
sizes ``repro_torch.kernels.decode_attention.split_plan``.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((1, 2048), (8, 4096), (4, 4096), (2, 8192), (16, 2048), (1, 32768))
SPLITS = (1, 2, 3, 4, 5, 8, 16, 24, 32, 64)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import decode_attention as da
    dev = torch.device("cuda", 0)
    lib = cuda_lib.load()
    print(cs.nvidia_smi_line())
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    Hq, Hkv, D = 24, 8, 128
    G = Hq // Hkv
    for B, L in SHAPES:
        q = cs._randn(gen, (B, 1, Hq, D), "bfloat16", dev)
        kc = cs._randn(gen, (B, L, Hkv, D), "float32", dev)
        vc = cs._randn(gen, (B, L, Hkv, D), "float32", dev)
        cp, pos = cs._cache_pos("full", B, L, dev)
        want = da.decode_attention_plain(q, kc, vc, cp, pos)
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        times = []
        for n in SPLITS:
            part_m = torch.empty((B, Hkv, n, G), device=dev)
            part_l = torch.empty_like(part_m)
            part_acc = torch.empty((B, Hkv, n, G, D), device=dev)

            def launch():
                cuda_lib.check(lib.repro_decode_attention(
                    q.data_ptr(), kc.data_ptr(), vc.data_ptr(), cp.data_ptr(),
                    pos.data_ptr(), out.data_ptr(), part_m.data_ptr(),
                    part_l.data_ptr(), part_acc.data_ptr(), B, L, Hkv, G, D,
                    n, -1, 0.0, D ** -0.5, 1, 0, stream), "decode_attention")

            launch()
            torch.cuda.synchronize()
            cs._attn_err(f"K5 B={B} L={L} n_split={n}", out, want,
                         cs.ATTN_TOL["bfloat16"])
            times.append(f"{n}: {cs.time_ms(launch, flush):.4f}")
        print(f"B={B} L={L} split_plan={da.split_plan(B, Hkv, L)} ms by "
              f"n_split: " + ", ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
