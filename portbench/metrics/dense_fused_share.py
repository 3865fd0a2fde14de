"""The share of the floating dense leaves the dense adagrad update took
that its multi-tensor kernel updated, in %: the program's own counts
(``repro_torch.kernels.cuda_lib.LEAF_COUNTS``), summed over every step of
the run; read in a traced run (readings with profiled steps). None where
the program has no such counts."""
import sys


def read(r: dict):
    lib = sys.modules.get("repro_torch.kernels.cuda_lib")
    counts = getattr(lib, "LEAF_COUNTS", None)
    if not r.get("profiled_steps") or not counts \
            or not counts.get("dense_leaves"):
        return None
    return counts["dense_leaves_fused"] / counts["dense_leaves"] * 100.0
