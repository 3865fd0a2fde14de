"""Host milliseconds spent inside the step calls, per step, in the traced
run's window with the profiler off (layer: train step)."""


def read(r: dict):
    steps = r.get("untraced_steps")
    if not steps or "host_step_s" not in r:
        return None
    return r["host_step_s"] / steps * 1e3
