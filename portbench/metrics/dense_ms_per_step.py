"""Device milliseconds launched inside the program's
``train_step.forward_backward`` span (the dense network's forward, the
loss and their backward, on any thread), per profiled step
(``yardstick/spans.py``)."""
from portbench.yardstick import spans


def read(r: dict):
    s = spans.per_step(r, "train_step.forward_backward", "device_s")
    return None if s is None else s * 1e3
