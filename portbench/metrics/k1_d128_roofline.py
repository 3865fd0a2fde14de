"""K1's share of its roofline at D=128, in %: the bytes its calls on
ragged bags need (``yardstick/counts_dcnv2.k1_bytes``: distinct rows x
512 B, the int32 lookups, the bags written, over the profiled steps'
batches) at the card's HBM bandwidth, over the device time of K1's D=128
route (``bag_d128_kernel``). None where that kernel did not run."""
from portbench.yardstick.trace import kernel_seconds


def is_k1_d128(name: str) -> bool:
    return "bag_d128_kernel" in name


def read(r: dict):
    reduced, peaks = r.get("trace"), r.get("peaks")
    if not reduced or not peaks or not r.get("k1_d128_bytes"):
        return None
    s = kernel_seconds(reduced, is_k1_d128)
    if s <= 0:
        return None
    return r["k1_d128_bytes"] / peaks["hbm_bytes_per_s"] / s * 100.0
