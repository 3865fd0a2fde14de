"""``segment_sum_ms_per_step`` on made-up reduced traces: the program's
segment-sum kernels, or ``torch.segment_reduce``'s in a program without
them, per profiled step; nothing where the trace holds neither."""
import importlib

import pytest

from portbench.yardstick import trace

read = importlib.import_module(
    "portbench.metrics.segment_sum_ms_per_step").read


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _readings(kernels, steps=2):
    events = [_x("user_annotation", trace.WINDOW, 0.0, 1000.0)]
    events += [_x("kernel", name, 10.0 + 100.0 * i, dur)
               for i, (name, dur) in enumerate(kernels)]
    return {"trace": trace.reduce(events), "profiled_steps": steps}


CHANGE = [("void (anonymous namespace)::segment_sum_short_kernel<16, true>"
           "(long long const*, ...)", 30.0),
          ("void (anonymous namespace)::segment_sum_long_kernel<16, true>"
           "(long long const*, ...)", 50.0),
          ("void (anonymous namespace)::segment_sum_short_kernel<1, false>"
           "(long long const*, ...)", 10.0),
          ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>",
           40.0),
          ("void at::native::vectorized_gather_kernel<16, long>(...)", 20.0)]
PARENT = [("void at::native::(anonymous namespace)::"
           "segment_reduce_forward_kernel<float, long>(...)", 70.0),
          ("void at::native::vectorized_gather_kernel<16, long>(...)", 20.0),
          ("bag_vec16_kernel(...)", 5.0)]


@pytest.mark.parametrize("kernels,want_us", [(CHANGE, 90.0),
                                             (PARENT, 70.0)])
def test_reads_the_segment_sum_kernels_per_step(kernels, want_us):
    for steps in (1, 2):
        assert read(_readings(kernels, steps)) == \
            pytest.approx(want_us / steps * 1e-3)


def test_reads_nothing_without_them():
    other = [k for k in CHANGE + PARENT
             if "segment_" not in k[0]]
    assert read(_readings(other)) is None
    assert read({"trace": {}, "profiled_steps": 2}) is None
    assert read({"trace": _readings(CHANGE)["trace"]}) is None   # untraced
