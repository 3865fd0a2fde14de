"""The whole step's share of the card's peak, in %: the benchmark's count of
the model FLOPs (``yardstick/counts.py``) over the traced run's window with
the profiler off, against the peak of the config's arithmetic (float32
outside the tensor cores)."""


def read(r: dict):
    peak = r.get("peak_flop_per_s")
    wall = r.get("untraced_wall_s")
    if not peak or not wall or "train_flops" not in r:
        return None
    return r["train_flops"] / wall / peak * 100.0
