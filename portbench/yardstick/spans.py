"""Reduce a ``torch.profiler`` trace to the program's ``train_step.*`` spans.

The port's train steps record ``record_function`` spans named
``train_step.<layer>`` at their layer boundaries
(``repro_torch/train/trainer.py``). ``reduce(events)`` turns the
Chrome-trace events that ``trace.profile`` exports into
``{span: {device_s, idle_s, syncs, launches, host_s}}``, summed over every
step in the trace:

- ``device_s``: device time of the kernels, copies and sets launched in
  the span. A device event is linked through ``args.correlation`` to the
  CUDA runtime or driver call that launched it, and counts under the
  innermost ``train_step.*`` span whose host interval holds that call's
  timestamp, whatever thread made the call: autograd's device thread
  launches the backward while the main thread waits inside
  ``train_step.forward_backward``;
- ``launches``: those device events, counted;
- ``idle_s``: the time inside the window in which no device operation ran
  while the span was the innermost ``train_step.*`` span on the host;
- ``syncs``: blocking CUDA calls made in the span (``SYNC_CALLS``);
- ``host_s``: the span's self time, the time in which it was the innermost
  span (the profiler inflates it).

Two more keys hold the rest: ``(unattributed)``, device events that no
launching call in the trace links to; ``(outside spans)``, device events,
idle time and syncs outside every span. The window is ``trace.WINDOW``'s
span when the trace has one, as in ``trace.reduce``; device time is cut to
it.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

from portbench.yardstick.trace import DEVICE_CATS, HOST_CATS, NAME_CHARS, \
    WINDOW, _merge

PREFIX = "train_step."
UNATTRIBUTED = "(unattributed)"
OUTSIDE = "(outside spans)"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the runtime calls that return only once the device has caught up
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})

Piece = Tuple[float, float, str]


def _innermost(spans: List[Piece]) -> List[Piece]:
    """The host timeline cut into pieces, each named by the shortest span
    that covers it; time no span covers is left out."""
    edges = sorted({x for s, t, _ in spans for x in (s, t)})
    pieces = []
    for a, b in zip(edges, edges[1:]):
        mid = 0.5 * (a + b)
        inside = [sp for sp in spans if sp[0] <= mid < sp[1]]
        if inside:
            pieces.append((a, b, min(inside, key=lambda sp: sp[1] - sp[0])[2]))
    return pieces


class _Trace:
    """The window, the span pieces and the linked device events of a
    trace; times in microseconds."""

    def __init__(self, events: List[dict]):
        complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  str(e["name"])) for e in complete
                 if e.get("cat") in HOST_CATS
                 and str(e.get("name", "")).startswith(PREFIX)]
        device = [e for e in complete if e.get("cat") in DEVICE_CATS]
        self.calls = [e for e in complete if e.get("cat") in LAUNCH_CATS]
        windows = [e for e in complete if e.get("name") == WINDOW
                   and e.get("cat") in HOST_CATS]
        ends = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in device] + [(s, t) for s, t, _ in spans]
        if windows:
            self.w0 = float(windows[0]["ts"])
            self.w1 = self.w0 + float(windows[0]["dur"])
        elif ends:
            self.w0 = min(s for s, _ in ends)
            self.w1 = max(t for _, t in ends)
        else:
            self.w0 = self.w1 = 0.0
        self.pieces = _innermost(spans)
        self._starts = [p[0] for p in self.pieces]
        launched = {e["args"]["correlation"]: float(e["ts"])
                    for e in self.calls
                    if "correlation" in e.get("args", {})}
        # (span, name, start, end) of each device event in the window
        self.device: List[Tuple[str, str, float, float]] = []
        for e in device:
            s = max(float(e["ts"]), self.w0)
            t = min(float(e["ts"]) + float(e["dur"]), self.w1)
            if t <= s:
                continue
            call = launched.get(e.get("args", {}).get("correlation"))
            span = UNATTRIBUTED if call is None else self.span_at(call)
            self.device.append((span, str(e.get("name", "?"))[:NAME_CHARS],
                                s, t))

    def span_at(self, ts: float) -> str:
        """The innermost span on the host at ``ts``."""
        i = bisect_right(self._starts, ts) - 1
        if i >= 0 and ts < self.pieces[i][1]:
            return self.pieces[i][2]
        return OUTSIDE

    def idle(self) -> Dict[str, float]:
        """``{span: us}`` of the window's device-idle time."""
        busy = _merge([(s, t) for _, _, s, t in self.device])
        edges = [self.w0] + [x for st in busy for x in st] + [self.w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        out: Dict[str, float] = {}
        j = 0
        for s, t in gaps:
            while j < len(self.pieces) and self.pieces[j][1] <= s:
                j += 1
            covered = 0.0
            k = j
            while k < len(self.pieces) and self.pieces[k][0] < t:
                a, b, name = self.pieces[k]
                part = min(t, b) - max(s, a)
                if part > 0:
                    out[name] = out.get(name, 0.0) + part
                    covered += part
                k += 1
            if t - s > covered:
                out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (t - s - covered)
        return out


def _row(table: dict, span: str) -> dict:
    return table.setdefault(span, {"device_s": 0.0, "idle_s": 0.0,
                                   "syncs": 0, "launches": 0, "host_s": 0.0})


def reduce(events: List[dict]) -> Dict[str, dict]:
    """``{span: {device_s, idle_s, syncs, launches, host_s}}`` of
    Chrome-trace ``events``; an empty dict when the trace has neither a
    ``train_step.*`` span nor a device event."""
    tr = _Trace(events)
    if not tr.pieces and not tr.device:
        return {}
    out: Dict[str, dict] = {}
    for a, b, name in tr.pieces:
        _row(out, name)["host_s"] += (b - a) * 1e-6
    for span, _, s, t in tr.device:
        row = _row(out, span)
        row["device_s"] += (t - s) * 1e-6
        row["launches"] += 1
    for span, us in tr.idle().items():
        _row(out, span)["idle_s"] += us * 1e-6
    for e in tr.calls:
        ts = float(e["ts"])
        if e.get("name") in SYNC_CALLS and tr.w0 <= ts <= tr.w1:
            _row(out, tr.span_at(ts))["syncs"] += 1
    return out


def kernels_by_span(events: List[dict]) -> Dict[str, Dict[str, float]]:
    """``{span: {device op name: seconds}}``: where ``reduce`` puts each
    kernel, copy and set."""
    out: Dict[str, Dict[str, float]] = {}
    for span, name, s, t in _Trace(events).device:
        ops = out.setdefault(span, {})
        ops[name] = ops.get(name, 0.0) + (t - s) * 1e-6
    return out


def syncs_by_op(events: List[dict]) -> Dict[str, Dict[str, int]]:
    """``{span: {host op: syncs}}``: each blocking call that ``reduce``
    counts, under the innermost host op (``cpu_op``) of its thread that
    holds it, or ``(no host op)``."""
    tr = _Trace(events)
    ops: Dict[tuple, List[Piece]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op" and "dur" in e:
            ops.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 str(e["name"])[:NAME_CHARS]))
    longest = {}
    for thread, held in ops.items():
        held.sort()
        longest[thread] = max(t - s for s, t, _ in held)
    out: Dict[str, Dict[str, int]] = {}
    for e in tr.calls:
        ts = float(e["ts"])
        if e.get("name") not in SYNC_CALLS or not tr.w0 <= ts <= tr.w1:
            continue
        thread = (e.get("pid"), e.get("tid"))
        held = ops.get(thread, [])
        name = "(no host op)"
        # the latest-starting op that holds ts is the innermost; none that
        # starts before ts - longest can hold it
        i = bisect_right(held, (ts, float("inf"), "")) - 1
        while i >= 0 and held[i][0] >= ts - longest[thread]:
            if held[i][1] >= ts:
                name = held[i][2]
                break
            i -= 1
        row = out.setdefault(tr.span_at(ts), {})
        row[name] = row.get(name, 0) + 1
    return out


def of(readings: dict) -> Optional[Dict[str, dict]]:
    """The ``spans`` of a run's reduced trace, or None."""
    return (readings.get("trace") or {}).get("spans") or None


def per_step(readings: dict, span: str, key: str) -> Optional[float]:
    """``key`` of ``span`` per profiled step, or None when the run's trace
    has no such span."""
    table, steps = of(readings), readings.get("profiled_steps")
    if not table or not steps or span not in table:
        return None
    return table[span][key] / steps


def summed(readings: dict, key: str) -> Optional[float]:
    """``key`` summed over the ``train_step.*`` spans per profiled step,
    or None when the run's trace has none."""
    table, steps = of(readings), readings.get("profiled_steps")
    names = [s for s in (table or {}) if s.startswith(PREFIX)]
    if not names or not steps:
        return None
    return sum(table[s][key] for s in names) / steps
