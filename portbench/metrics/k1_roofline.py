"""K1's share of its roofline, in %: the bytes its calls need
(``yardstick/counts.k1_bytes`` over the profiled steps' batches) at the
card's HBM bandwidth, over the device time of K1's kernels
(``bag_*_kernel``)."""
from portbench.yardstick.trace import kernel_seconds


K1_KERNELS = ("bag_vec16_kernel", "bag_wide_kernel", "bag_any_kernel")


def is_k1(name: str) -> bool:
    return any(k in name for k in K1_KERNELS)


def read(r: dict):
    reduced, peaks = r.get("trace"), r.get("peaks")
    if not reduced or not peaks or not r.get("k1_bytes"):
        return None
    s = kernel_seconds(reduced, is_k1)
    if s <= 0:
        return None
    return r["k1_bytes"] / peaks["hbm_bytes_per_s"] / s * 100.0
