"""The share of the profiled window in which no operation ran on the
device, in %: 1 - busy / window, from the profiler's trace."""


def read(r: dict):
    reduced = r.get("trace")
    if not reduced or not reduced.get("window_s"):
        return None
    return (1.0 - reduced["busy_s"] / reduced["window_s"]) * 100.0
