"""K2's share of its roofline at D=128, in %: the bytes its adagrad calls
need (``yardstick/counts_dcnv2.k2_bytes``: distinct rows x (5 x 128 x 4
+ 4) B over the profiled steps' batches) at the card's HBM bandwidth, over
the device time of K2's adagrad kernels (``rows_*_kernel<AdagradOp...>``;
the D=128 store is the cell's only sparse store)."""
from portbench.yardstick.trace import kernel_seconds


def is_k2(name: str) -> bool:
    return "AdagradOp" in name and "rows_" in name


def read(r: dict):
    reduced, peaks = r.get("trace"), r.get("peaks")
    if not reduced or not peaks or not r.get("k2_d128_bytes"):
        return None
    s = kernel_seconds(reduced, is_k2)
    if s <= 0:
        return None
    return r["k2_d128_bytes"] / peaks["hbm_bytes_per_s"] / s * 100.0
