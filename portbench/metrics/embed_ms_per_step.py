"""Device milliseconds launched inside the program's
``train_step.embeddings`` span (the bags: the hot-row encoding, its
host-to-device copies and K1), per profiled step
(``yardstick/spans.py``)."""
from portbench.yardstick import spans


def read(r: dict):
    s = spans.per_step(r, "train_step.embeddings", "device_s")
    return None if s is None else s * 1e3
