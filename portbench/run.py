"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

    python3 portbench/run.py --workload wide_deep.zipf105.b65536 \\
        --seed 12345 --seconds 10 --trace 0

From the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics; ``--trace 1`` its per-layer metrics, with the device's busy time
and a breakdown. The last line of standard output is one JSON object; the
last lines of standard error give each number that decided ``correct``
beside its limit. Exits non-zero, printing no result, without enough CUDA
devices, when the program cannot be imported, or when JAX or the JAX
package is loaded once the window has closed.

Caches: the program builds its kernels under ``build/`` of the checkout;
Python's bytecode and CUDA's, Triton's and PyTorch's extension caches are
pointed under ``build/portbench-cache/``, so that only a checkout's first
run compiles (an environment with ``PYTHONDONTWRITEBYTECODE`` set would
otherwise compile every module of PyTorch from source in every run).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "portbench-cache")
sys.pycache_prefix = os.path.join(CACHE, "pycache")
sys.dont_write_bytecode = False
for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(CACHE, sub)
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness
    spec = harness.load_spec()
    chips = int(harness.cell(spec, args.workload)["chips"])

    import torch
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False: no result",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: {torch.cuda.device_count()} CUDA devices, the "
              f"cell needs {chips}: no result", file=sys.stderr)
        return 2
    torch.set_num_threads(1)

    line = harness.run_workload(spec, args.workload, seed=args.seed,
                                seconds=args.seconds, trace=bool(args.trace),
                                device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package is loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for text in harness.check_lines(line["checks"]):
        print(text, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
