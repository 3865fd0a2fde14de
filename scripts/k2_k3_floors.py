#!/usr/bin/env python3
"""Take apart where the time of K2 (row-wise adagrad) and K3 (lazy row-wise
adam) goes on one CUDA card.

    python3 scripts/k2_k3_floors.py [--baseline-lib PATH]

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
On the deduped rows of a real full-width Wide&Deep batch (the deep D=16
pool on the vector route, the wide D=1 pool on the scalar route), each
kernel through its C entry point at ``update_plan``'s grid, first held bit
for bit against the plain version, then timed:

1. floors: the call with the L2 evicted by a write (``chip_smoke.time_ms``'s
   way, which leaves the L2 full of dirty lines), by a read (clean lines),
   and not evicted; the call with every entry padding (row-id loads only);
   one padding entry (a launch and one load).
2. with ``--baseline-lib``: the same inputs through the one-thread-per-
   (entry, d) kernels of commit 0c234bb, from a library built from that
   commit (``repro_adagrad_rows_f32(params, acc, R, D, rows, vals, N,
   neg_lr, eps, stream)`` and its adam twin), held bit for bit against the
   plain version too.

Times are medians of 50 launches, each timed alone with CUDA events
(``chip_smoke.time_ms``).
"""
import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B1, B2, LR = 0.9, 0.999, 3e-3
_VP, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_float)


class _Evict:
    """Stands in for ``chip_smoke.time_ms``'s flush tensor: its ``zero_``
    runs ``fn`` before each timed launch instead."""

    def __init__(self, fn):
        self.zero_ = fn


def _baseline(path):
    """The 0c234bb library, with its C signatures."""
    lib = ctypes.CDLL(str(path))
    lib.repro_adagrad_rows_f32.argtypes = [_VP, _VP, _LL, _I, _VP, _VP, _LL,
                                           _F, _F, _VP]
    lib.repro_adam_rows_f32.argtypes = [_VP, _VP, _VP, _LL, _I, _VP, _VP,
                                        _VP, _LL] + [_F] * 7 + [_VP]
    for fn in (lib.repro_adagrad_rows_f32, lib.repro_adam_rows_f32):
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline-lib", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import fused_update as fu
    dev = torch.device("cuda", 0)
    lib = cuda_lib.load()
    base = _baseline(args.baseline_lib) if args.baseline_lib else None
    print(cs.nvidia_smi_line())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    flushes = {"write-evicted": flush,
               "read-evicted": _Evict(lambda: flush.max()),
               "warm": _Evict(lambda: None)}
    stream = torch.cuda.current_stream().cuda_stream
    cfg = cs._full_cfg()
    bias = fu.adam_bias(7, B1, B2, dev)
    for D in (cfg.embed_dim, 1):
        p0, rows, vals = cs._sparse_rows(cfg, dev, D)
        R, N = p0.shape[0], rows.shape[0]
        route = fu.update_route(D, p0, vals)
        vec = int(route == "vector")
        a0 = torch.rand(p0.shape, device=dev)
        m0 = a0 - 0.5
        n_live = int((rows < R).sum())
        blocks = fu.update_plan(N, D, sms, route)
        padding = torch.full_like(rows, R)
        print(f"D={D} route={route} N={N} live rows={n_live} "
              f"blocks={blocks} of {fu.THREADS}", flush=True)
        for name in ("K2", "K3"):
            adam = int(name == "K3")
            pools = (p0, m0, a0) if adam else (p0, a0)
            hyper = ([-LR, B1, 1 - B1, B2, 1 - B2, 1e-8, 0.01] if adam
                     else [-LR, 1e-10])
            extra = [bias.data_ptr()] if adam else []

            def entry(ps, rows=rows, n=N):
                fn = lib.repro_adam_rows_f32 if adam else \
                    lib.repro_adagrad_rows_f32
                cuda_lib.check(fn(*[x.data_ptr() for x in ps], R, D,
                                  rows.data_ptr(), vals.data_ptr(), *extra,
                                  n, *hyper, vec,
                                  fu.update_plan(n, D, sms, route), stream),
                               name)

            def baseline(ps):
                fn = base.repro_adam_rows_f32 if adam else \
                    base.repro_adagrad_rows_f32
                cuda_lib.check(fn(*[x.data_ptr() for x in ps], R, D,
                                  rows.data_ptr(), vals.data_ptr(), *extra,
                                  N, *hyper, stream), f"{name} baseline")

            want = [x.clone() for x in pools]
            if adam:
                fu.adam_rows_plain(*want, rows, vals, bias, lr=LR, b1=B1,
                                   b2=B2, eps=1e-8, wd=0.01)
            else:
                fu.adagrad_rows_plain(*want, rows, vals, lr=LR, eps=1e-10)

            def exact(launch, tag):
                got = [x.clone() for x in pools]
                launch(got)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise RuntimeError(f"{name} D={D} {tag}: differs from "
                                       "the plain version")

            scratch = [x.clone() for x in pools]
            exact(entry, "kernel")
            floors = {k: cs.time_ms(lambda: entry(scratch), f)
                      for k, f in flushes.items()}
            floors["all padding"] = cs.time_ms(
                lambda: entry(scratch, rows=padding), flush)
            floors["one padding entry"] = cs.time_ms(
                lambda: entry(scratch, rows=padding, n=1), flush)
            if base is not None:
                exact(baseline, "0c234bb kernel")
                for k, f in flushes.items():
                    floors[f"0c234bb kernel, {k}"] = cs.time_ms(
                        lambda: baseline(scratch), f)
            print(f"{name} D={D}: " + "; ".join(
                f"{k} {ms * 1e3:.2f} us" for k, ms in floors.items()),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
