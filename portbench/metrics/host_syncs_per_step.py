"""Blocking CUDA calls (stream, device and event synchronises, synchronous
copies) the host made inside the program's ``train_step.*`` spans, per
profiled step (``yardstick/spans.py``)."""
from portbench.yardstick import spans


def read(r: dict):
    return spans.summed(r, "syncs")
