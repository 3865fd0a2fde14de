"""Reduce a ``torch.profiler`` trace of the traced window to numbers.

``profile(fn)`` runs ``fn`` under the profiler (CPU and CUDA activities)
inside a ``portbench.window`` span that ends with a device synchronise,
writes the Chrome trace to a temporary file under ``TMPDIR``, reads it back
and deletes it. ``reduce`` turns the trace's events into:

- ``window_s``: the length of the ``portbench.window`` span;
- ``busy_s``: the union of the device's kernel, copy and set intervals that
  fall inside the window (one stream: nothing overlaps);
- ``kernels``: ``{kernel name: device seconds}``;
- ``gaps``: ``{host op: idle device seconds}``: each stretch of the window
  in which no device operation ran, named by the innermost host operation
  (an ``aten`` op or a benchmark span) that was running at its midpoint.
  ``portbench.step`` there means Python inside the step, between ops;
  ``(no host op)`` the benchmark's own loop between steps.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple

WINDOW = "portbench.window"
STEP = "portbench.step"            # the span around each profiled step
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
NAME_CHARS = 120


def profile(fn: Callable[[], None]) -> dict:
    """Run ``fn`` under the profiler; its trace reduced by ``reduce``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce(events)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce(events: List[dict]) -> dict:
    """``{window_s, busy_s, kernels, gaps}`` of Chrome-trace ``events``
    (times in microseconds); an empty dict when no device event lies in the
    window."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in complete if e.get("name") == WINDOW
               and e.get("cat") in HOST_CATS]
    device = [e for e in complete if e.get("cat") in DEVICE_CATS]
    if not device:
        return {}
    if windows:
        w0 = float(windows[0]["ts"])
        w1 = w0 + float(windows[0]["dur"])
    else:
        w0 = min(float(e["ts"]) for e in device)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in device)
    kernels: Dict[str, float] = {}
    spans = []
    for e in device:
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        name = str(e.get("name", "?"))[:NAME_CHARS]
        kernels[name] = kernels.get(name, 0.0) + (t - s) * 1e-6
        spans.append((s, t))
    if not spans:
        return {}
    busy = _merge(spans)
    busy_us = sum(t - s for s, t in busy)

    edges = [w0] + [x for st in busy for x in st] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   str(e["name"])[:NAME_CHARS]) for e in complete
                  if e.get("cat") in HOST_CATS and e.get("name") != WINDOW)
    named: Dict[str, float] = {}
    active: List[Tuple[float, float, str]] = []
    j = 0
    for s, t in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (s + t)
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= mid]
        name = min(active, key=lambda h: h[1] - h[0])[2] if active \
            else "(no host op)"
        named[name] = named.get(name, 0.0) + (t - s) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "kernels": kernels, "gaps": named}


def top(table: Dict[str, float], n: int = 10) -> List[list]:
    """The ``n`` largest entries of ``{name: seconds}`` as ``[name, s]``."""
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]


def kernel_seconds(reduced: dict, match: Callable[[str], bool]) -> float:
    """Device seconds of the traced kernels whose name ``match`` accepts."""
    return sum(s for name, s in reduced.get("kernels", {}).items()
               if match(name))
