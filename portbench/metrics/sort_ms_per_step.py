"""Device milliseconds of the radix-sort kernels (the sparse backward's
dedupe sorts the looked-up rows), per profiled step."""
from portbench.yardstick.trace import kernel_seconds


def is_sort(name: str) -> bool:
    return "radixsort" in name.lower()


def read(r: dict):
    reduced, steps = r.get("trace"), r.get("profiled_steps")
    if not reduced or not steps:
        return None
    s = kernel_seconds(reduced, is_sort)
    return s / steps * 1e3 if s > 0 else None
