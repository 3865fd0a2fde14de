"""Device milliseconds launched inside the program's ``train_step.cross``
span (DLRM-DCNv2's low-rank cross network, its forward and its backward),
per profiled step (``yardstick/spans.py``). None where the trace has no
such span."""
from portbench.yardstick import spans


def read(r: dict):
    s = spans.per_step(r, "train_step.cross", "device_s")
    return None if s is None else s * 1e3
