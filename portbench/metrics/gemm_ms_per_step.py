"""Device milliseconds of the dense network's matrix products (cuBLAS GEMM
and GEMV kernels and their split-K reductions), forward and backward, per
profiled step."""
from portbench.yardstick.trace import kernel_seconds


def is_gemm(name: str) -> bool:
    low = name.lower()
    return "gemm" in low or "gemv" in low or "splitkreduce" in low


def read(r: dict):
    reduced, steps = r.get("trace"), r.get("profiled_steps")
    if not reduced or not steps:
        return None
    s = kernel_seconds(reduced, is_gemm)
    return s / steps * 1e3 if s > 0 else None
