"""The harness: find a cell's files by name, run its driver, assemble the
result line.

Everything a cell needs is found from ``BENCHMARK.json`` by name:

- ``portbench/configs/<config>.json`` (the file ``configs[].file`` names),
  whose ``driver`` key names ``portbench/drivers/<driver>.py``;
- ``portbench/traffic/<traffic>.json``;
- ``portbench/limits/<workload>.json``: the limits of the numbers that
  decide ``correct``, with the readings they were set from;
- ``portbench/metrics/<metric>.py`` for each per-layer metric, whose
  ``read(readings)`` returns the metric or None.

A driver's ``run(ctx)`` returns ``correct``, ``attempted``, ``failed``,
``checks``, ``end_to_end`` (every end-to-end metric it measures, by name),
``readings`` (what the per-layer readers read), ``breakdown`` and
``memory_peak_bytes``.
"""
from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
# top-level module names that must not be loaded where the result is
# printed: JAX, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec() -> dict:
    return _load(ROOT / "BENCHMARK.json")


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def resolve(spec: dict, workload: str) -> SimpleNamespace:
    """The cell's entry, config, traffic and limits, read from their files."""
    w = cell(spec, workload)
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = _load(ROOT / entry["file"])
    traffic = _load(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = _load(BENCH / "limits" / f"{workload}.json")
    return SimpleNamespace(cell=w, config=config, traffic=traffic,
                           limits=limits)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def peaks_for(device_name: str) -> Optional[dict]:
    """The peaks of ``yardstick/peaks.json`` whose key the card's name
    holds, or None."""
    table = _load(BENCH / "yardstick" / "peaks.json")
    for key, peaks in table.items():
        if not key.startswith("_") and key in device_name:
            return peaks
    return None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_workload(spec: dict, workload: str, *, seed: int, seconds: float,
                 trace: bool, device: str, t_start: float,
                 found: Optional[SimpleNamespace] = None) -> dict:
    """Run one cell on ``device``; the result line as a dict. ``found``
    replaces the cell's files (``resolve``'s form)."""
    import torch

    found = found or resolve(spec, workload)
    driver = importlib.import_module(
        f"portbench.drivers.{found.config['driver']}")
    cuda = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    ctx = SimpleNamespace(config=found.config, traffic=found.traffic,
                          limits=found.limits, seed=int(seed),
                          seconds=float(seconds), trace=bool(trace),
                          device=device, t_start=t_start,
                          peaks=peaks_for(kind) if cuda else None)
    out = driver.run(ctx)

    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            if not applies(m, workload):
                continue
            reader = importlib.import_module(f"portbench.metrics.{m['name']}")
            value = reader.read(out["readings"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": int(found.cell["chips"]),
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    reduced = out["readings"].get("trace") or {}
    if trace and reduced:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    return line


def check_lines(checks: dict) -> List[str]:
    """The numbers compared, one line each, beside their limits."""
    return [f"check {name}: {c['value']!r} limit {c['limit']!r}"
            for name, c in checks.items()]
