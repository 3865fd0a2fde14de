"""Device milliseconds launched inside the program's
``train_step.sparse_grads`` span (row cotangents, the dedupe's sort,
sorted gather and segment sum), per profiled step
(``yardstick/spans.py``)."""
from portbench.yardstick import spans


def read(r: dict):
    s = spans.per_step(r, "train_step.sparse_grads", "device_s")
    return None if s is None else s * 1e3
