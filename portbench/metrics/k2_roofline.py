"""K2's share of its roofline, in %: the bytes its adagrad calls need
(``yardstick/counts.k2_bytes`` over the profiled steps' batches) at the
card's HBM bandwidth, over the device time of K2's adagrad kernels
(``rows_*_kernel<AdagradOp>``)."""
from portbench.yardstick.trace import kernel_seconds


K2_KERNELS = ("rows_vec16_kernel", "rows_wide_kernel", "rows_any_kernel")


def is_k2(name: str) -> bool:
    return "AdagradOp" in name and any(k in name for k in K2_KERNELS)


def read(r: dict):
    reduced, peaks = r.get("trace"), r.get("peaks")
    if not reduced or not peaks or not r.get("k2_bytes"):
        return None
    s = kernel_seconds(reduced, is_k2)
    if s <= 0:
        return None
    return r["k2_bytes"] / peaks["hbm_bytes_per_s"] / s * 100.0
