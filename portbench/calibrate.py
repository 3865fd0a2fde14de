"""Readings that a cell's limits are set from: the program's own on many
seeds, the control's and each fault's, at the cell's own sizes.

    python3 portbench/calibrate.py --workload wide_deep.zipf105.b65536 \\
        --seeds 11,12,13 --control-seeds 11,12,13 --fault-seeds 11,12,13 \\
        --device cuda --out build/calibrate.json

For every seed it builds the program on the benchmark's weights, runs its
checked steps on the first batches of the cell's pool (no window: a
training cell's checks need none) and the reference's in float32; on the
control seeds the reference again with TF32 products (the control, put in
the program's place); on the fault seeds the program with each fault of
``yardstick/faults.py`` planted. Each is read by ``yardstick/check.py``
against the float32 reference. The benchmark's own runs do not run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    from portbench.drivers import dlrm_train
    from portbench.reference import dlrm as reference
    from portbench.yardstick import check, faults
    from portbench.yardstick import traffic as gen

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    found = harness.resolve(harness.load_spec(), args.workload)
    config, traffic = found.config, dict(found.traffic)
    n = int(traffic["checked_steps"])
    traffic["pool_batches"] = n          # the first n batches of the pool
    lookups = traffic["lookups_per_table"]
    lr, eps = float(traffic["lr"]), float(traffic["eps"])
    kinds = {"program": args.seeds, "control": args.control_seeds}
    kinds.update({f: args.fault_seeds for f in faults.FAULTS})
    out = {"workload": args.workload, "device": (
        torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"),
        "limits": found.limits, "runs": []}

    def weights(seed):
        return reference.make_weights(
            config, lookups, gen.generator(seed, gen.WEIGHTS_STREAM, dev))

    def program(seed, batches):
        state, step = dlrm_train.build(config, traffic, weights(seed))
        state, prog = dlrm_train.checked_steps(state, step, batches)
        del state, step
        return prog

    for seed in sorted(set().union(*kinds.values())):
        t0 = time.perf_counter()
        batches = gen.make_pool(config, traffic, seed, dev)
        ref = reference.train(weights(seed), batches, config, lr=lr, eps=eps)
        for kind, seeds in kinds.items():
            if seed not in seeds:
                continue
            if kind == "program":
                got = program(seed, batches)
            elif kind == "control":
                got = reference.train(weights(seed), batches, config, lr=lr,
                                      eps=eps, precision="tf32")
            else:
                with faults.planted(dlrm_train, kind):
                    got = program(seed, batches)
            found_ = check.readings(got, ref)
            out["runs"].append({
                "seed": seed, "kind": kind, "numbers": found_,
                "losses": got["losses"], "ref_losses": ref["losses"],
                "change_leaves": check.leaf_gaps(
                    got["change_norm"], ref["change_norm"],
                    check.moved_leaves(ref["grad_norm"])),
                "grad_leaves": check.leaf_gaps(got["grad_norm"],
                                               ref["grad_norm"])})
            print(json.dumps({"seed": seed, "kind": kind, **{
                k: v["value"] for k, v in found_.items()}}), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)

    summary = {}
    for kind in kinds:
        runs = [r for r in out["runs"] if r["kind"] == kind]
        if runs:
            summary[kind] = {num: {
                "max": max(r["numbers"][num]["value"] for r in runs),
                "min": min(r["numbers"][num]["value"] for r in runs)}
                for num in runs[0]["numbers"]}
    out["summary"] = summary
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
