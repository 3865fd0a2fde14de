"""The DLRM train steps' spans and the sparse layer's row counts.

The fused sparse step of a small Wide&Deep and a small xDeepFM (padded
layout, hot-row cache) runs under ``torch.profiler`` (CPU activity): it
records ``train_step.embeddings``, ``.forward_backward``, ``.sparse_grads``
and ``.optimizer`` once a step, in that order and without overlap, and the
dense step the LM step's two spans; xDeepFM's CIN records
``train_step.cin`` twice a step (its forward and its backward) inside
``.forward_backward``; the benchmark's span reduction finds them. ``cuda_lib.ROW_COUNTS`` counts the distinct rows of each store and
the entries the row updates walk; ``reset_launches()`` zeroes them.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one CPU thread)
from portbench.yardstick import spans
from portbench.yardstick import traffic as gen
from repro_torch.configs import dlrm_models as tcfg
from repro_torch.configs.registry import get_dlrm
from repro_torch.data.synthetic import criteo_batch
from repro_torch.kernels import cuda_lib
from repro_torch.launch.train import to_device
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.sharding import policy as tpol
from repro_torch.train import optim as toptim
from repro_torch.train import trainer as ttrainer

KINDS = ["wide_deep", "xdeepfm"]
SPARSE_SPANS = ["train_step.embeddings", "train_step.forward_backward",
                "train_step.sparse_grads", "train_step.optimizer"]
DENSE_SPANS = ["train_step.forward_backward", "train_step.optimizer"]
# spans nested in train_step.forward_backward: xDeepFM's CIN, its forward
# and its backward
NESTED = {"wide_deep": [], "xdeepfm": ["train_step.cin"] * 2}
STEPS = 2


def _setup(kind, sparse=True, opt_name="adagrad"):
    cfg = dataclasses.replace(tcfg.reduced_dlrm(get_dlrm(kind)),
                              zipf_alpha=1.05, hot_rows_k=8)
    layout = tpol.padded_layout_for_ranges(
        tpol.uniform_vocab_ranges(cfg.total_embedding_rows, 4))
    opt = toptim.make(opt_name, 3e-3)
    state = ttrainer.make_dlrm_train_state(
        cfg, opt, torch.Generator().manual_seed(0), layout=layout)
    step = ttrainer.make_dlrm_train_step(
        cfg, opt, plan=cfg.embedding_plan(layout=layout,
                                          sparse_update=sparse))
    B = cfg.batch_size
    batches = [to_device(criteo_batch(cfg, 7, np.arange(i * B, (i + 1) * B)),
                         "cpu") for i in range(STEPS)]
    return cfg, state, step, batches


def _train(step, state, batches):
    for b in batches:
        state, _ = step(state, b)
    return state


def _profiled(step, state, batches, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        state = _train(step, state, batches)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return state, json.load(f)["traceEvents"]


def _step_spans(events):
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith(spans.PREFIX))


def _assert_same_state(a, b):
    for part in ("params", "opt"):
        la = list(toptim.tree_leaves(a[part]))
        lb = list(toptim.tree_leaves(b[part]))
        assert len(la) == len(lb) > 0
        assert all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_each_step_records_its_spans_in_order(kind, sparse, tmp_path):
    _, state, step, batches = _setup(kind, sparse)
    # the same steps from the same state with the profiler off: the spans
    # change no bit
    plain = _train(step, _setup(kind, sparse)[1], batches)
    state, events = _profiled(step, state, batches, tmp_path)
    _assert_same_state(state, plain)

    want = SPARSE_SPANS if sparse else DENSE_SPANS
    every = _step_spans(events)
    nested = [sp for sp in every if sp[2] in NESTED[kind]]
    found = [sp for sp in every if sp not in nested]
    assert [name for _, _, name in found] == want * STEPS
    for (_, end, _), (start, _, _) in zip(found, found[1:]):
        assert end <= start
    assert [name for _, _, name in nested] == NESTED[kind] * STEPS
    fwd_bwd = [sp for sp in found if sp[2] == "train_step.forward_backward"]
    for s, t, _ in nested:
        assert any(a <= s and t <= b for a, b, _ in fwd_bwd)
    table = spans.reduce(events)
    # no device here: the host's time between the spans is "outside"
    assert set(table) - {spans.OUTSIDE} == set(want) | set(NESTED[kind])
    assert all(table[s]["host_s"] > 0 and table[s]["syncs"] == 0
               for s in set(want) | set(NESTED[kind]))


@pytest.mark.parametrize("opt_name", ["adagrad", "adam"])
@pytest.mark.parametrize("kind", KINDS)
def test_row_counts_follow_the_batches(kind, opt_name):
    cfg, state, step, batches = _setup(kind, opt_name=opt_name)
    cuda_lib.reset_launches()
    _train(step, state, batches)
    stores = len(dlrm_mod.sparse_param_keys(cfg))
    B, T, H = batches[0]["sparse"].shape
    distinct = sum(gen.distinct_rows(b, cfg.table_rows) for b in batches)
    assert cuda_lib.ROW_COUNTS == {
        "rows_deduped": stores * distinct,
        "row_update_entries": stores * STEPS * B * T * H}


def test_reset_launches_zeroes_the_row_counts():
    for counts in (cuda_lib.LAUNCHES, cuda_lib.ROW_COUNTS):
        for name in counts:
            counts[name] = 3
    cuda_lib.reset_launches()
    assert set(cuda_lib.ROW_COUNTS.values()) == {0}
    assert set(cuda_lib.LAUNCHES.values()) == {0}
