"""Device milliseconds of the sparse backward's segment sum, per profiled
step: the program's segment-sum kernels (``segment_sum_*_kernel``, from
``csrc/segment_sum.cu``), or, in a program without them, the kernels of
``torch.segment_reduce`` (``segment_reduce*``) that summed the dedupe's
segments before. None where the trace holds neither."""
from portbench.yardstick.trace import kernel_seconds


def is_segment_sum(name: str) -> bool:
    return "segment_sum_" in name or "segment_reduce" in name


def read(r: dict):
    reduced, steps = r.get("trace"), r.get("profiled_steps")
    if not reduced or not steps:
        return None
    s = kernel_seconds(reduced, is_segment_sum)
    return s / steps * 1e3 if s > 0 else None
