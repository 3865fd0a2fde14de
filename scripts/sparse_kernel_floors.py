#!/usr/bin/env python3
"""Take apart where the time of the sparse kernels goes on one CUDA card:
K1 (fused embedding bag), K2 (row-wise adagrad) and K3 (lazy row-wise
adam).

    python3 scripts/sparse_kernel_floors.py [--baseline-lib PATH]

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
On a real full-width Wide&Deep batch (the deep D=16 pool and the wide D=1
pool, padded over 4 shards, 64 hot rows), each kernel is first held bit
for bit against its plain version, then timed:

1. K1 (unweighted sum, the main path's call) on the route and grid of
   ``bag_route``/``bag_plan``: with the L2 evicted by a write
   (``chip_smoke.time_ms``'s way, which leaves the L2 full of dirty
   lines), by a read (clean lines), and not evicted; an all-hot call
   (every lookup reads the 64-row cache, so no pool row is read).
2. K2 and K3 on the deduped rows of the same batch (vector route at D=16,
   scalar at D=1), at ``update_plan``'s grid: the same three evictions;
   the call with every entry padding (row-id loads only); one padding
   entry (a launch and one load).
3. with ``--baseline-lib``: K1 of a library built from commit 42dbb14 (one
   thread per output element; ``repro_fused_embedding_bag_f32(pool, R,
   enc, weights, cache, K, out, n_bags, H, D, combiner, stream)``) on the
   same inputs and the same three evictions, held bit for bit too. (K2/K3
   are unchanged since that commit; their comparison with 0c234bb is the
   same script as it stood at 42dbb14, `scripts/k2_k3_floors.py`.)

Times are medians of 50 launches, each timed alone with CUDA events
(``chip_smoke.time_ms``).
"""
import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B1, B2, LR = 0.9, 0.999, 3e-3
_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


class _Evict:
    """Stands in for ``chip_smoke.time_ms``'s flush tensor: its ``zero_``
    runs ``fn`` before each timed launch instead."""

    def __init__(self, fn):
        self.zero_ = fn


def _baseline(path):
    """K1 of the 42dbb14 library, with its C signature."""
    fn = ctypes.CDLL(str(path)).repro_fused_embedding_bag_f32
    fn.argtypes = [_VP, _LL, _VP, _VP, _VP, _LL, _VP, _LL, _I, _I, _I, _VP]
    fn.restype = ctypes.c_int
    return fn


def _report(name, floors):
    print(f"{name}: " + "; ".join(f"{k} {ms * 1e3:.2f} us"
                                  for k, ms in floors.items()), flush=True)


def k1_floors(cs, dev, flushes, base):
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import fused_embedding as fe
    from repro_torch.sharding import policy as pol
    cfg = cs._full_cfg()
    idx = cs._real_batch(cfg, dev)["sparse"]
    B, T, H = idx.shape
    layout = pol.padded_layout_for_ranges(
        pol.uniform_vocab_ranges(cfg.total_embedding_rows, 4))
    plan = cfg.embedding_plan(layout=layout)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(4)
    for D in (cfg.embed_dim, 1):
        pool = layout.pad_rows(torch.randn(
            (cfg.total_embedding_rows, D), generator=gen, device=dev)
        ).reshape(layout.padded_rows, D)
        enc, cache = fe.kernel_inputs(pool, idx, plan)
        K = cache.shape[0]
        all_hot = (-(torch.arange(enc.numel(), device=dev) % K) - 1).to(
            torch.int32).reshape(enc.shape)
        out = torch.empty((B, T, D), device=dev)
        route = fe.bag_route(D, H, pool, enc, out, cache)
        print(f"K1 D={D} route={route} bags={B * T} K={K} blocks="
              f"{fe.bag_plan(B * T, route)} of {fe.BAG_THREADS[route]}",
              flush=True)

        def kernel(e=enc):
            return fe.embedding_bag_cuda(pool, e, None, cache, "sum")

        def baseline(e=enc):
            cuda_lib.check(base(pool.data_ptr(), pool.shape[0], e.data_ptr(),
                                None, cache.data_ptr(), K, out.data_ptr(),
                                B * T, H, D, 0, stream), "K1 baseline")
            return out

        def exact(launch, e, tag):
            got = launch(e).clone()
            torch.cuda.synchronize()
            want = fe.embedding_bag_plain(pool, e, None, cache, "sum")
            if not torch.equal(got, want):
                raise RuntimeError(f"K1 D={D} {tag}: differs from the plain "
                                   "version")

        exact(kernel, enc, "kernel")
        exact(kernel, all_hot, "kernel, all hot")
        floors = {k: cs.time_ms(kernel, f) for k, f in flushes.items()}
        floors["all hot"] = cs.time_ms(lambda: kernel(all_hot),
                                       flushes["write-evicted"])
        if base is not None:
            exact(baseline, enc, "42dbb14 kernel")
            for k, f in flushes.items():
                floors[f"42dbb14 kernel, {k}"] = cs.time_ms(baseline, f)
        _report(f"K1 D={D}", floors)


def k2_k3_floors(cs, dev, flushes, sms):
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import fused_update as fu
    lib = cuda_lib.load()
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
        padding = torch.full_like(rows, R)
        print(f"D={D} route={route} N={N} live rows={n_live} "
              f"blocks={fu.update_plan(N, D, sms, route)} of {fu.THREADS}",
              flush=True)
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

            want = [x.clone() for x in pools]
            if adam:
                fu.adam_rows_plain(*want, rows, vals, bias, lr=LR, b1=B1,
                                   b2=B2, eps=1e-8, wd=0.01)
            else:
                fu.adagrad_rows_plain(*want, rows, vals, lr=LR, eps=1e-10)
            got = [x.clone() for x in pools]
            entry(got)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"{name} D={D}: differs from the plain "
                                   "version")
            scratch = [x.clone() for x in pools]
            floors = {k: cs.time_ms(lambda: entry(scratch), f)
                      for k, f in flushes.items()}
            floors["all padding"] = cs.time_ms(
                lambda: entry(scratch, rows=padding), flushes["write-evicted"])
            floors["one padding entry"] = cs.time_ms(
                lambda: entry(scratch, rows=padding, n=1),
                flushes["write-evicted"])
            _report(f"{name} D={D}", floors)


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
    dev = torch.device("cuda", 0)
    base = _baseline(args.baseline_lib) if args.baseline_lib else None
    print(cs.nvidia_smi_line())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    flushes = {"write-evicted": flush,
               "read-evicted": _Evict(lambda: flush.max()),
               "warm": _Evict(lambda: None)}
    # load each eviction's kernel now: a first launch inside a timed run
    # stalls the host past the spin kernel, and the events then time it
    for f in flushes.values():
        f.zero_()
    k1_floors(cs, dev, flushes, base)
    k2_k3_floors(cs, dev, flushes, sms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
