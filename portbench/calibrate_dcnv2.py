"""Readings that the DLRM-DCNv2 cell's limits are set from: the program's
own on many seeds, the control's and each fault's.

    python3 portbench/calibrate_dcnv2.py \\
        --workload dlrm_dcnv2.multihot.zipf105.b8192 --seeds 11,12,13 \\
        --control-seeds 11,12 --fault-seeds 11,12 --fault-rows 1000000 \\
        --device cuda --out build/calibrate_dcnv2.json

``calibrate.py``'s procedure on ``drivers/dlrm_dcnv2.py`` and
``reference/dlrm_dcnv2.py`` (``calibrate.py`` builds ``dlrm_train``'s
program by name): for every seed the program's checked steps on the first
batches of the cell's pool and the reference's in float32; on the control
seeds the reference again with TF32 products (the control, in the
program's place); on the fault seeds the program with each fault of
``yardstick/faults.py`` planted. Each is read by ``yardstick/check.py``
against the float32 reference.

``--fault-rows N`` runs the faults that copy the store (``COPYING``) with
each table of more than N rows cut to N (the ids drawn from those rows):
``faults.shifted_rows`` holds a copy of the store and its accumulator and
two temporaries of the store's size besides the state, and ``flipped`` a
copy of the store and two such temporaries, more than a card of 80 GB
holds beside a 14.94 GB table and its accumulator. The program's, the
control's and the other faults' runs keep the cell's sizes (``unchanged``
holds one copy of the state: ~60 GB in all). The benchmark's own runs do
not run this.
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


COPYING = ("flipped", "shifted_rows")


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-rows", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    from portbench.drivers import dlrm_dcnv2 as driver
    from portbench.drivers import dlrm_train
    from portbench.reference import dlrm_dcnv2 as reference
    from portbench.yardstick import check, faults, multihot
    from portbench.yardstick import traffic as gen

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    found = harness.resolve(harness.load_spec(), args.workload)
    config, traffic = found.config, dict(found.traffic)
    n = int(traffic["checked_steps"])
    traffic["pool_batches"] = n          # the first n batches of the pool
    lr, eps = float(traffic["lr"]), float(traffic["eps"])
    cut = dict(config)
    if args.fault_rows:
        cut["table_rows"] = [min(int(r), args.fault_rows)
                             for r in config["table_rows"]]
    kinds = {"program": args.seeds, "control": args.control_seeds}
    kinds.update({f: args.fault_seeds for f in faults.FAULTS})
    out = {"workload": args.workload, "device": (
        torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"),
        "fault_rows": args.fault_rows, "limits": found.limits, "runs": []}

    def weights(conf, seed):
        return reference.make_weights(
            conf, gen.generator(seed, gen.WEIGHTS_STREAM, dev))

    def program(conf, seed, batches):
        cfg = driver.program_config(conf, traffic)
        state, step, layout = driver.build(cfg, traffic, weights(conf, seed))
        rows = driver.padded_rows(batches, conf, traffic, layout)
        state, prog = driver.checked_steps(state, step, batches, rows)
        del state, step
        return prog

    def reference_run(conf, seed, batches, precision="f32"):
        return reference.train(weights(conf, seed), batches, conf, lr=lr,
                               eps=eps, precision=precision)

    for seed in sorted(set().union(*kinds.values())):
        t0 = time.perf_counter()
        full = tuple(k for k in kinds if k not in COPYING)
        for conf, names in ((config, full), (cut, COPYING)):
            todo = [k for k in names if seed in kinds[k]]
            if not todo:
                continue
            batches = multihot.make_pool(conf, traffic, seed, dev)
            ref = reference_run(conf, seed, batches)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            for kind in todo:
                if kind == "program":
                    got = program(conf, seed, batches)
                elif kind == "control":
                    got = reference_run(conf, seed, batches, "tf32")
                else:
                    with faults.planted(dlrm_train, kind):
                        got = program(conf, seed, batches)
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
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
