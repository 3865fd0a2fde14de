"""A traced run of one cell with the program's spans among the readings.

    python3 portbench/spans_run.py --workload wide_deep.zipf105.b65536 \\
        --seed 12345 --seconds 20 [--src build/parent/src]

Runs the cell as ``run.py --trace 1`` does, on the card, with two
readings added to those of the cell's ``drivers/`` module: ``spans``, the
profiled steps' trace reduced by ``yardstick/spans.py`` (which
``trace.profile`` does not return yet), and the wall time of the profiled
steps, ended by a device synchronise. Prints one JSON object: the window's
end-to-end metrics, every per-layer metric of ``BENCHMARK.json`` and of
``SPAN_METRICS``, the spans per profiled step, the device operations and
the host ops that synchronised in each span, the program's row counts
and ``correct``. ``--src`` imports the program from another checkout's
``src`` (a parent unpacked by ``git archive``), so that two versions of
the program run under the same benchmark code.
"""
import argparse
import importlib
import json
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the span readers whose reading ``trace.profile`` does not carry yet
SPAN_METRICS = ("embed_ms_per_step", "dense_ms_per_step",
                "sparse_grad_ms_per_step", "optimizer_ms_per_step",
                "host_syncs_per_step")


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args(argv)
    for path in (ROOT, os.path.abspath(args.src)):
        sys.path.insert(0, path)

    import torch
    if not torch.cuda.is_available():
        print("spans_run: torch.cuda.is_available() is False: no result",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from portbench import harness
    from portbench.yardstick import spans, trace

    box = {}
    reduce, profile = trace.reduce, trace.profile

    def reduce_with_spans(events):
        out = reduce(events)
        if out:
            out["spans"] = spans.reduce(events)
            box["ops"] = spans.kernels_by_span(events)
            box["syncs"] = spans.syncs_by_op(events)
        return out

    def timed_profile(fn):
        def steps():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            box["profiled_wall_s"] = time.perf_counter() - t0
        return profile(steps)

    trace.reduce, trace.profile = reduce_with_spans, timed_profile

    spec = harness.load_spec()
    found = harness.resolve(spec, args.workload)
    driver = importlib.import_module(
        f"portbench.drivers.{found.config['driver']}")
    kind = torch.cuda.get_device_name(0)
    ctx = SimpleNamespace(config=found.config, traffic=found.traffic,
                          limits=found.limits, seed=args.seed,
                          seconds=args.seconds, trace=True, device="cuda",
                          t_start=t_start, peaks=harness.peaks_for(kind))
    out = driver.run(ctx)
    r = out["readings"]
    names = [m["name"] for m in spec["per_layer"]
             if harness.applies(m, args.workload)] + list(SPAN_METRICS)
    steps = r["profiled_steps"]
    table = spans.of(r) or {}
    lib = sys.modules.get("repro_torch.kernels.cuda_lib")
    result = {
        "workload": args.workload, "seed": args.seed,
        "src": os.path.relpath(os.path.abspath(args.src), ROOT),
        "device": kind, "correct": out["correct"],
        "end_to_end": out["end_to_end"],
        "metrics": {n: importlib.import_module(f"portbench.metrics.{n}")
                    .read(r) for n in names},
        "busy_ms_per_step": (r["trace"] or {}).get("busy_s", 0) / steps * 1e3,
        "profiled_ms_per_step": box.get("profiled_wall_s", 0) / steps * 1e3,
        "spans_per_step": {s: {k: v / steps for k, v in row.items()}
                           for s, row in table.items()},
        "ops_by_span": {s: trace.top(ops, len(ops))
                        for s, ops in box.get("ops", {}).items()},
        "syncs_by_op": {s: {op: n / steps for op, n in row.items()}
                        for s, row in box.get("syncs", {}).items()},
        "row_counts": dict(getattr(lib, "ROW_COUNTS", {})),
        "checks": out["checks"]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
