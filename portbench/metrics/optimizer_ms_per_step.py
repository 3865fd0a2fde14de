"""Device milliseconds launched inside the program's
``train_step.optimizer`` span (the global norm, the dense update and the
row updates, K2/K3), per profiled step (``yardstick/spans.py``)."""
from portbench.yardstick import spans


def read(r: dict):
    s = spans.per_step(r, "train_step.optimizer", "device_s")
    return None if s is None else s * 1e3
