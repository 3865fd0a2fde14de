"""The share of the entries the row updates walk that are live rows, in %:
the distinct rows the sparse backward deduped over the entries K2 was
handed, padding included. Both are the program's own counts
(``repro_torch.kernels.cuda_lib.ROW_COUNTS``), summed over every step of
the run; they are read in a traced run (readings with profiled steps).
None where the program has no such counts."""
import sys


def read(r: dict):
    lib = sys.modules.get("repro_torch.kernels.cuda_lib")
    counts = getattr(lib, "ROW_COUNTS", None)
    if not r.get("profiled_steps") or not counts \
            or not counts.get("row_update_entries"):
        return None
    return counts["rows_deduped"] / counts["row_update_entries"] * 100.0
