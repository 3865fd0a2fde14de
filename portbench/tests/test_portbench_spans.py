"""The reduction of a trace to the program's spans, its readers, and a
traced run of each cell on the card with the spans among the readings."""
import importlib
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from conftest import CELLS, ROOT
from portbench.yardstick import spans, trace
from test_portbench_trace import EVENTS

MAIN, AUTOGRAD = 1, 2      # the host threads


def _x(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=MAIN, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, ts, 1.0, tid, corr)


# One step in a 200 us window: the four spans of the fused sparse step on
# the main thread, the dense backward launched from autograd's thread, an
# unlinked kernel, a kernel launched after the spans and three syncs.
STEP = [
    _x("user_annotation", trace.WINDOW, 0.0, 200.0),
    _x("user_annotation", trace.STEP, 0.0, 190.0),
    _x("user_annotation", "train_step.embeddings", 0.0, 40.0),
    _x("user_annotation", "train_step.forward_backward", 40.0, 60.0),
    _x("user_annotation", "train_step.sparse_grads", 100.0, 50.0),
    _x("user_annotation", "train_step.optimizer", 150.0, 30.0),
    _x("cpu_op", "aten::copy_", 19.0, 5.0),
    _launch(5.0, 1),
    _x("kernel", "bag_vec16_kernel(...)", 10.0, 10.0, 7, 1),
    _launch(20.0, 2, name="cudaMemcpyAsync"),
    _launch(22.0, 3, name="cudaStreamSynchronize"),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 25.0, 5.0, 7, 2),
    _launch(60.0, 4, tid=AUTOGRAD),
    _x("kernel", "sm90_xmma_gemm_f32f32", 62.0, 30.0, 7, 4),
    _launch(105.0, 5),
    _x("kernel", "DeviceRadixSortOnesweepKernel", 106.0, 4.0, 7, 5),
    _launch(111.0, 6, name="cudaStreamSynchronize"),
    _launch(115.0, 7),
    _x("kernel", "segment_reduce_forward_kernel", 116.0, 24.0, 7, 7),
    _launch(155.0, 8),
    _x("kernel", "void rows_vec16_kernel<AdagradOp>(...)", 156.0, 4.0, 7, 8),
    _x("kernel", "unlinked", 185.0, 5.0, 7, 99),
    _launch(182.0, 9),
    _x("kernel", "after the spans", 190.0, 5.0, 7, 9),
    _launch(195.0, 10, name="cudaDeviceSynchronize"),
]


def test_each_device_event_goes_to_the_span_of_its_launch():
    ops = spans.kernels_by_span(STEP)
    assert set(ops["train_step.embeddings"]) == {
        "bag_vec16_kernel(...)", "Memcpy HtoD (Pageable -> Device)"}
    # launched by autograd's thread inside the main thread's span
    assert set(ops["train_step.forward_backward"]) == {"sm90_xmma_gemm_f32f32"}
    assert set(ops["train_step.sparse_grads"]) == {
        "DeviceRadixSortOnesweepKernel", "segment_reduce_forward_kernel"}
    assert set(ops["train_step.optimizer"]) == {
        "void rows_vec16_kernel<AdagradOp>(...)"}
    assert set(ops[spans.UNATTRIBUTED]) == {"unlinked"}
    assert set(ops[spans.OUTSIDE]) == {"after the spans"}


def test_each_sync_goes_to_its_span_and_host_op():
    assert spans.syncs_by_op(STEP) == {
        "train_step.embeddings": {"aten::copy_": 1},
        "train_step.sparse_grads": {"(no host op)": 1},
        spans.OUTSIDE: {"(no host op)": 1}}


def test_device_idle_syncs_launches_and_host_per_span():
    r = spans.reduce(STEP)
    want = {   # device us, idle us, syncs, launches, host us
        "train_step.embeddings": (15, 25, 1, 2, 40),
        "train_step.forward_backward": (30, 30, 0, 1, 60),
        "train_step.sparse_grads": (28, 22, 1, 2, 50),
        "train_step.optimizer": (4, 26, 0, 1, 30),
        spans.UNATTRIBUTED: (5, 0, 0, 1, 0),
        spans.OUTSIDE: (5, 10, 1, 1, 0),
    }
    assert set(r) == set(want)
    for span, (dev, idle, syncs, launches, host) in want.items():
        row = r[span]
        assert row["device_s"] == pytest.approx(dev * 1e-6), span
        assert row["idle_s"] == pytest.approx(idle * 1e-6), span
        assert (row["syncs"], row["launches"]) == (syncs, launches), span
        assert row["host_s"] == pytest.approx(host * 1e-6), span
    # the window is cut into busy and idle time, with nothing counted twice
    whole = sum(row["device_s"] + row["idle_s"] for row in r.values())
    assert whole == pytest.approx(200e-6)


def test_a_launch_counts_under_the_innermost_span():
    events = [
        _x("user_annotation", "train_step.optimizer", 0.0, 100.0),
        _x("user_annotation", "train_step.inner", 20.0, 30.0),
        _launch(10.0, 1), _x("kernel", "outer", 12.0, 4.0, 7, 1),
        _launch(30.0, 2), _x("kernel", "inner", 31.0, 4.0, 7, 2),
    ]
    ops = spans.kernels_by_span(events)
    assert set(ops["train_step.optimizer"]) == {"outer"}
    assert set(ops["train_step.inner"]) == {"inner"}
    r = spans.reduce(events)
    assert r["train_step.optimizer"]["host_s"] == pytest.approx(70e-6)
    assert r["train_step.inner"]["host_s"] == pytest.approx(30e-6)


def test_a_trace_without_spans_or_device_events_reads_nothing():
    assert spans.reduce([_x("cpu_op", "aten::mm", 0.0, 5.0)]) == {}


def test_the_trace_reduction_is_unchanged():
    assert trace.reduce(EVENTS) == {
        "window_s": 9.999999999999999e-05, "busy_s": 4.9999999999999996e-05,
        "kernels": {"bag_vec16_kernel(...)": 9.999999999999999e-06,
                    "void rows_vec16_kernel<AdagradOp>(...)":
                        9.999999999999999e-06,
                    "sm90_xmma_gemm_f32f32": 1.9999999999999998e-05,
                    "Memcpy DtoH": 9.999999999999999e-06},
        "gaps": {trace.STEP: 9.999999999999999e-06,
                 "aten::unique_consecutive": 1.9999999999999998e-05,
                 "(no host op)": 1.9999999999999998e-05}}


SPAN_READS = {"embed_ms_per_step": 0.015, "dense_ms_per_step": 0.030,
              "sparse_grad_ms_per_step": 0.028,
              "optimizer_ms_per_step": 0.004, "host_syncs_per_step": 2.0}


def _read(name, r):
    return importlib.import_module(f"portbench.metrics.{name}").read(r)


def test_span_readers_per_step():
    reduced = trace.reduce(STEP)
    reduced["spans"] = spans.reduce(STEP)
    for steps in (1, 2):
        r = {"trace": reduced, "profiled_steps": steps}
        for name, value in SPAN_READS.items():
            assert _read(name, r) == pytest.approx(value / steps), name


def test_span_readers_find_nothing_without_spans():
    parent = {"trace": trace.reduce(STEP), "profiled_steps": 1}
    no_step_span = dict(parent["trace"], spans=spans.reduce(
        [e for e in STEP if not e["name"].startswith(spans.PREFIX)]))
    for r in ({}, parent, {"trace": no_step_span, "profiled_steps": 1}):
        for name in SPAN_READS:
            assert _read(name, r) is None, name


def test_k2_live_share_reads_the_program_row_counts(monkeypatch):
    from repro_torch.kernels import cuda_lib
    monkeypatch.setitem(cuda_lib.ROW_COUNTS, "rows_deduped", 603)
    monkeypatch.setitem(cuda_lib.ROW_COUNTS, "row_update_entries", 6800)
    assert _read("k2_live_share", {"profiled_steps": 30}) == \
        pytest.approx(603 / 6800 * 100)
    assert _read("k2_live_share", {"peaks": None}) is None   # untraced
    monkeypatch.setitem(cuda_lib.ROW_COUNTS, "row_update_entries", 0)
    assert _read("k2_live_share", {"profiled_steps": 30}) is None
    # a program without the counts (the parent's)
    monkeypatch.setitem(sys.modules, "repro_torch.kernels.cuda_lib",
                        types.ModuleType("repro_torch.kernels.cuda_lib"))
    assert _read("k2_live_share", {"profiled_steps": 30}) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_spans_of_a_short_window_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs on the card")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "spans_run.py"),
         "--workload", workload, "--seed", str(2 ** 31 + 977),
         "--seconds", "2"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"]
    for name in (*SPAN_READS, "k2_live_share"):
        assert out["metrics"][name] is not None, name
    ops = {s: [name for name, _ in top]
           for s, top in out["ops_by_span"].items()}

    def holds(span, *parts):
        return any(all(p in name for p in parts) for name in ops.get(span, []))

    assert holds("train_step.embeddings", "bag_")
    assert holds("train_step.optimizer", "rows_", "AdagradOp")
    assert holds("train_step.sparse_grads", "DeviceRadixSort")
    assert holds("train_step.sparse_grads", "segment_reduce")
    per_step = out["spans_per_step"]
    device = sum(row["device_s"] for row in per_step.values())
    lost = per_step.get(spans.UNATTRIBUTED, {}).get("device_s", 0.0)
    assert lost < 0.02 * device
    in_spans = sum(row["device_s"] for s, row in per_step.items()
                   if s.startswith(spans.PREFIX))
    assert in_spans == pytest.approx(out["busy_ms_per_step"] * 1e-3,
                                     rel=0.02)
