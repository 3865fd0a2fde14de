"""Reduction of a profiler trace and the per-layer readers."""
import importlib

import pytest

from portbench import harness
from portbench.yardstick import trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _x("user_annotation", trace.WINDOW, 0.0, 100.0),
    _x("user_annotation", trace.STEP, 0.0, 85.0),
    _x("cpu_op", "aten::unique_consecutive", 25.0, 20.0),
    _x("cpu_op", "aten::_local_scalar_dense", 30.0, 5.0),
    _x("kernel", "bag_vec16_kernel(...)", 10.0, 10.0),
    _x("kernel", "void rows_vec16_kernel<AdagradOp>(...)", 20.0, 10.0),
    _x("kernel", "sm90_xmma_gemm_f32f32", 50.0, 20.0),
    _x("gpu_memcpy", "Memcpy DtoH", 70.0, 10.0),
    _x("kernel", "outside the window", 150.0, 10.0),
    _x("gpu_user_annotation", trace.STEP, 0.0, 90.0),
]


def test_reduce_busy_window_kernels_and_gaps():
    r = trace.reduce(EVENTS)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(50e-6)     # 10-30 and 50-80
    assert r["kernels"]["sm90_xmma_gemm_f32f32"] == pytest.approx(20e-6)
    assert "outside the window" not in r["kernels"]
    # gaps: 0-10 inside the step span, 30-50 with the host in the sync of
    # aten::unique_consecutive, 80-100 after the step span
    assert r["gaps"][trace.STEP] == pytest.approx(10e-6)
    assert r["gaps"]["aten::unique_consecutive"] == pytest.approx(20e-6)
    assert r["gaps"]["(no host op)"] == pytest.approx(20e-6)


def test_no_device_event_reads_nothing():
    assert trace.reduce([_x("cpu_op", "aten::mm", 0.0, 5.0)]) == {}


def _readings():
    return {"trace": trace.reduce(EVENTS), "profiled_steps": 1,
            "peaks": {"hbm_bytes_per_s": 1e12}, "k1_bytes": 5e6,
            "k2_bytes": 4e6, "untraced_steps": 10, "untraced_wall_s": 2.0,
            "host_step_s": 0.5, "train_flops": 6.7e12,
            "peak_flop_per_s": 67e12}


def test_readers_on_a_trace():
    r = _readings()
    read = {m["name"]: importlib.import_module(
        f"portbench.metrics.{m['name']}").read(r)
        for m in harness.load_spec()["per_layer"]}
    assert read["k1_roofline"] == pytest.approx(50.0)        # 5 us / 10 us
    assert read["k2_roofline"] == pytest.approx(40.0)
    assert read["gemm_ms_per_step"] == pytest.approx(0.02)
    assert read["device_idle_share"] == pytest.approx(50.0)
    assert read["host_ms_per_step"] == pytest.approx(50.0)
    assert read["step_mfu"] == pytest.approx(5.0)
    assert read["sort_ms_per_step"] is None       # no sort kernel: nothing


def test_readers_find_nothing_in_an_untraced_run():
    for m in harness.load_spec()["per_layer"]:
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        assert reader.read({"peaks": None, "batch": 8}) is None
