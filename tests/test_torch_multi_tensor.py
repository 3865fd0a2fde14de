"""The optimizer layer's multi-tensor functions on the CPU: their plain
versions, the counts, and the dedupe's form that the norm's kernel reads.

``kernels/multi_tensor.py`` holds the global norm and the dense adagrad
update; CPU leaves take their plain versions, which must give the bits of
the expressions the port had before: the Python sum of per-leaf sums of
squares and its sqrt, ``clip_by_global_norm``'s multiply, adagrad's
update and ``apply_updates``, op by op. CPU trees launch nothing;
``cuda_lib.LEAF_COUNTS`` counts the dense leaves every adagrad update
takes (none of them fused here). The norm's kernel reads a
``SparseRowGrad`` up to the first entry of its last row id, which is
exact for the dedupe's rows: ascending, distinct, then the sentinel tail
with zero values. The benchmark's ``dense_fused_share`` reads the leaf
counts.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one CPU thread)
from repro_torch.configs import dlrm_models as tcfg
from repro_torch.configs.registry import get_dlrm
from repro_torch.data.synthetic import criteo_batch
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import fused_embedding as fe
from repro_torch.kernels import multi_tensor as mt
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.train import to_device
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.sharding import policy as tpol
from repro_torch.train import optim
from repro_torch.train import trainer

LR, EPS = 3e-3, 1e-10


# --- the expressions the port had before, as they were ----------------------
def _old_global_norm(tree):
    leaves = [l for l in optim.tree_leaves(tree)
              if torch.is_tensor(l) and l.is_floating_point()]
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves))


def _old_clip(grads, max_norm):
    norm = _old_global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return optim.tree_map(
        lambda g: g * scale.to(g.dtype) if g.is_floating_point() else g,
        grads)


def _old_adagrad_update(grads, state, params, lr, eps, clip_norm):
    if clip_norm is not None:
        grads = _old_clip(grads, clip_norm)
    acc = optim.tree_map(lambda a, g: a + torch.square(g.float()),
                         state["acc"], grads)
    updates = optim.tree_map(
        lambda g, a, p: (-lr * g.float() / (torch.sqrt(a) + eps)
                         ).to(p.dtype), grads, acc, params)
    return updates, {"acc": acc}


def _tree(rng, dtype=torch.float32):
    """A nested tree of odd-sized leaves: a 1-element leaf, sizes no
    multiple of 4, a list."""
    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)
    return {"w0": t(13, 7), "b0": t(1), "blocks": [
        {"k": t(5, 3, scale=1e-3), "v": t(4097)}, {"k": t(8), "v": t(2, 2)}],
        "z": t(3)}


def _state(rng, params, carried):
    acc = optim.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
    if carried:
        acc = optim.tree_map(lambda a: torch.from_numpy(rng.uniform(
            0, 2, a.shape).astype(np.float32)), acc)
    return {"acc": acc}


def _same(a, b):
    la, lb = list(optim.tree_leaves(a)), list(optim.tree_leaves(b))
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _sparse_leaf(rng, n_live, n_pad, D, R=1000):
    rows = np.sort(rng.choice(R, n_live, replace=False)).astype(np.int32)
    rows = np.concatenate([rows, np.full(n_pad, R, np.int32)])
    vals = rng.standard_normal((n_live + n_pad, D)).astype(np.float32)
    vals[n_live:] = 0
    return optim.SparseRowGrad(torch.from_numpy(rows),
                               torch.from_numpy(vals))


# --- the plain versions give the old bits ------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_norm_is_the_old_expression(dtype):
    rng = np.random.default_rng(1)
    tree = _tree(rng, dtype)
    tree["tables"] = _sparse_leaf(rng, 37, 91, 16)
    tree["wide"] = _sparse_leaf(rng, 0, 12, 1)       # all padding
    tree["ids"] = torch.arange(5)                    # an integer leaf
    cuda_lib.reset_launches()
    got = optim.global_norm(tree)
    want = _old_global_norm(tree)
    assert got.dtype == want.dtype == torch.float32 and got.dim() == 0
    assert torch.equal(got, want)
    leaves = list(optim._norm_leaves(tree))
    assert torch.equal(torch.sqrt(mt.grad_sq_norm(leaves)), want)
    assert torch.equal(mt.grad_sq_norm(leaves),
                       mt.grad_sq_norm_plain(leaves))
    assert set(cuda_lib.LAUNCHES.values()) == {0}


def test_norm_leaves_keep_the_tree_order_with_sparse_leaves_whole():
    rng = np.random.default_rng(2)
    sp = _sparse_leaf(rng, 3, 2, 4)
    tree = {"b": torch.ones(2), "a": [torch.ones(1), sp],
            "c": torch.arange(3), "d": {"x": torch.zeros(4)}}
    leaves = list(optim._norm_leaves(tree))
    assert len(leaves) == 4 and leaves[1] is sp
    flat = [l for l in optim.tree_leaves(tree) if l.is_floating_point()]
    assert len(flat) == len(leaves)
    assert all(mt._vals(x) is y for x, y in zip(leaves, flat))


@pytest.mark.parametrize("clip_norm", [None, 0.05, 1e6])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adagrad_update_and_apply_are_the_old_expressions(dtype, carried,
                                                          clip_norm):
    rng = np.random.default_rng(3)
    params, grads = _tree(rng, dtype), _tree(rng, dtype)
    state = _state(rng, params, carried)
    opt = optim.adagrad(LR, eps=EPS, clip_norm=clip_norm)
    want_u, want_s = _old_adagrad_update(grads, state, params, LR, EPS,
                                         clip_norm)
    before = [x.clone() for x in optim.tree_leaves((params, grads, state))]
    cuda_lib.reset_launches()
    got_u, got_s = opt.update(grads, state, params)
    _same(got_u, want_u)
    _same(got_s, want_s)
    new_p, new_s = optim.update_and_apply(opt, grads, state, params)
    _same(new_p, optim.apply_updates(params, want_u))
    _same(new_s, want_s)
    # the state passed in is not written
    for x, y in zip(before, optim.tree_leaves((params, grads, state))):
        assert torch.equal(x, y)
    assert set(cuda_lib.LAUNCHES.values()) == {0}
    n = len(list(optim.tree_leaves(params)))
    assert cuda_lib.LEAF_COUNTS == {"dense_leaves": 2 * n,
                                    "dense_leaves_fused": 0}


@pytest.mark.parametrize("apply", [True, False])
@pytest.mark.parametrize("scaled", [False, True])
def test_dense_adagrad_plain_matches_leaf_by_leaf(apply, scaled):
    rng = np.random.default_rng(4)
    ps = list(optim.tree_leaves(_tree(rng)))
    gs = list(optim.tree_leaves(_tree(rng)))
    accs = [torch.from_numpy(rng.uniform(0, 1, p.shape).astype(np.float32))
            for p in ps]
    scale = torch.tensor(0.37) if scaled else None
    outs, new_accs = mt.dense_adagrad(gs, accs, ps, lr=LR, eps=EPS,
                                      scale=scale, apply=apply)
    for g, a, p, o, na in zip(gs, accs, ps, outs, new_accs):
        g2 = g * scale if scaled else g
        want_a = a + torch.square(g2)
        u = -LR * g2 / (torch.sqrt(want_a) + EPS)
        assert torch.equal(na, want_a)
        assert torch.equal(o, p + u if apply else u)


def test_dense_adagrad_refuses_what_it_cannot_pair():
    p = [torch.zeros(3), torch.zeros(2)]
    with pytest.raises(ValueError, match="2 gradients, 1 accumulators"):
        mt.dense_adagrad(p, p[:1], p, lr=LR, eps=EPS)
    with pytest.raises(ValueError, match="more than one device"):
        mt.dense_adagrad([p[0], torch.zeros(2, device="meta")], p, p,
                         lr=LR, eps=EPS)
    assert mt.dense_adagrad([], [], [], lr=LR, eps=EPS) == ([], [])


def test_meta_leaves_take_the_plain_versions():
    leaves = [torch.zeros(4, 3, device="meta"),
              (torch.zeros(5, dtype=torch.int32, device="meta"),
               torch.zeros(5, 2, device="meta"))]
    assert mt.global_norm(leaves).device.type == "meta"
    out, acc = mt.dense_adagrad([leaves[0]], [leaves[0]], [leaves[0]],
                                lr=LR, eps=EPS)
    assert out[0].shape == (4, 3) and acc[0].device.type == "meta"


# --- the dedupe's form: the live extent the norm's kernel reads --------------
def _first_of_last(rows: torch.Tensor) -> int:
    """The kernel's extent rule, in Python: the first entry of the last row
    id (a lower bound on ascending rows)."""
    return int(torch.searchsorted(rows, rows[-1:]).item())


@pytest.mark.parametrize("route", ["bags", "rows", "ragged"])
def test_dedupe_rows_end_in_the_tail_the_norm_skips(route):
    rng = np.random.default_rng(5)
    R, D, B = 60, 4, 32
    if route == "ragged":
        sizes = (3, 1, 5)
        idx = torch.from_numpy(rng.integers(0, R, B * sum(sizes)).astype(
            np.int32))
        g = torch.from_numpy(rng.standard_normal(
            (B * len(sizes), D)).astype(np.float32))
        rows, vals = fe.dedupe_bags(idx, g, 0, R, sizes)
    elif route == "bags":
        H = 4
        idx = torch.from_numpy(rng.integers(0, R, B * H).astype(np.int32))
        g = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
        rows, vals = fe.dedupe_bags(idx, g, H, R)
    else:
        idx = torch.from_numpy(rng.integers(0, R, B).astype(np.int32))
        g = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
        rows, vals = fe.dedupe_rows(idx, g, R)
    n_live = int((rows < R).sum())
    assert torch.equal(rows[:n_live], torch.unique(idx))
    assert bool((rows[n_live:] == R).all())
    assert not vals[n_live:].any()
    n_read = _first_of_last(rows) + 1
    assert n_read == min(n_live + 1, rows.shape[0])
    assert torch.equal(torch.sum(torch.square(vals[:n_read])),
                       torch.sum(torch.square(vals[:n_live])))


# --- the train steps on the CPU ----------------------------------------------
def _dlrm(kind, sparse, opt_name="adagrad", **opt_kw):
    cfg = dataclasses.replace(tcfg.reduced_dlrm(
        tcfg.DLRM_DCNV2 if kind == "dlrm_dcnv2" else get_dlrm(kind)),
        zipf_alpha=1.05, hot_rows_k=8)
    layout = tpol.padded_layout_for_ranges(
        tpol.uniform_vocab_ranges(cfg.total_embedding_rows, 4))
    opt = optim.make(opt_name, LR, **opt_kw)
    state = trainer.make_dlrm_train_state(
        cfg, opt, torch.Generator().manual_seed(0), layout=layout)
    step = trainer.make_dlrm_train_step(
        cfg, opt, plan=cfg.embedding_plan(layout=layout,
                                          sparse_update=sparse))
    B = cfg.batch_size
    batches = [to_device(criteo_batch(cfg, 7, np.arange(i * B, (i + 1) * B)),
                         "cpu") for i in range(2)]
    return cfg, state, step, batches


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("kind", ["wide_deep", "xdeepfm", "dlrm_dcnv2"])
def test_cpu_steps_count_dense_leaves_and_launch_nothing(kind, sparse):
    cfg, state, step, batches = _dlrm(kind, sparse)
    stores = dlrm_mod.sparse_param_keys(cfg)
    n_dense = len([k for k in state["params"] if not sparse or
                   k not in stores])
    old = {k: v.clone() for k, v in state["params"].items()
           if k not in stores}
    cuda_lib.reset_launches()
    s = state
    for b in batches:
        s, m = step(s, b)
        assert torch.isfinite(m["grad_norm"])
    assert set(cuda_lib.LAUNCHES.values()) == {0}
    assert cuda_lib.LEAF_COUNTS == {"dense_leaves": n_dense * len(batches),
                                    "dense_leaves_fused": 0}
    # the dense params passed in are not written (fresh tensors come back)
    for k, v in old.items():
        assert torch.equal(state["params"][k], v)
    cuda_lib.reset_launches()
    assert set(cuda_lib.LEAF_COUNTS.values()) == {0}


def test_adam_steps_take_no_adagrad_leaves():
    _, state, step, batches = _dlrm("wide_deep", True, "adam")
    cuda_lib.reset_launches()
    step(state, batches[0])
    assert set(cuda_lib.LEAF_COUNTS.values()) == {0}


def _dense_part(opt_state, stores):
    """The optimizer state of the dense leaves: every mirror of the params
    without the stores; shared scalars (adam's ``count``) as they are."""
    return {name: {k: v for k, v in sub.items() if k not in stores}
            if isinstance(sub, dict) else sub
            for name, sub in opt_state.items()}


@pytest.mark.parametrize("opt_name", ["adagrad", "adam"])
def test_sparse_step_update_is_the_old_update_then_apply(opt_name):
    """The dense half of ``apply`` on the sparse step's joint tree gives
    the bits of ``optimizer.update`` + ``apply_updates`` on the dense
    subtree (adam's default clip included: it reads the dense leaves)."""
    cfg, state, step, batches = _dlrm("wide_deep", True, opt_name)
    opt = optim.make(opt_name, LR)
    stores = dlrm_mod.sparse_param_keys(cfg)
    rng = np.random.default_rng(6)
    params = state["params"]
    dense = {k: v for k, v in params.items() if k not in stores}
    grads = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32)) for k, v in dense.items()}
    dstate = _dense_part(state["opt"], stores)
    upd, s1 = opt.update(grads, dstate, dense)
    joint = dict(grads)
    for k in stores:
        R = dlrm_mod.pool_rows(params[k]).shape[0]
        joint[k] = _sparse_leaf(rng, 5, 3, params[k].shape[-1], R)
    p2, s2 = opt.apply(joint, state["opt"], params)
    _same({k: p2[k] for k in dense}, optim.apply_updates(dense, upd))
    _same(_dense_part(s2, stores), s1)


def _row_case(opt_name):
    """A padded (n_ps, max_range, D) store and a dense leaf, carried
    optimizer state, and the joint gradient tree."""
    rng = np.random.default_rng(7)
    n_ps, max_range, D = 3, 8, 4
    params = {"tables": torch.from_numpy(rng.standard_normal(
        (n_ps, max_range, D)).astype(np.float32)),
        "w": torch.from_numpy(rng.standard_normal((5, 3)).astype(
            np.float32))}
    opt = optim.make(opt_name, LR, **({"weight_decay": 0.01}
                                      if opt_name == "adam" else {}))

    def carried(x):         # moments in (0.1, 2); adam's count at 4
        if x.dim():
            return torch.from_numpy(rng.uniform(0.1, 2, tuple(x.shape))
                                    .astype(np.float32))
        return torch.tensor(4, dtype=torch.int32)

    state = optim.tree_map(carried, opt.init(params))
    grads = {"tables": _sparse_leaf(rng, 7, 5, D, n_ps * max_range),
             "w": torch.from_numpy(rng.standard_normal((5, 3)).astype(
                 np.float32))}
    return opt, params, state, grads


@pytest.mark.parametrize("opt_name", ["adagrad", "adam"])
def test_apply_updates_a_row_leaf_in_place_as_the_row_kernel(opt_name):
    """A ``SparseRowGrad`` leaf through ``apply``: the bits of
    ``ops.fused_row_update`` on the flattened pools (unclipped: adam's clip
    reads the dense leaves only), and the store and its moment pools come
    back as the same tensors."""
    opt, params, state, grads = _row_case(opt_name)
    moments = ("acc",) if opt_name == "adagrad" else ("m", "v")
    want = [params["tables"].clone()] + [state[k]["tables"].clone()
                                         for k in moments]
    hyper = {"lr": LR, "eps": EPS} if opt_name == "adagrad" else {
        "lr": LR, "b1": 0.9, "b2": 0.999, "eps": 1e-8, "weight_decay": 0.01,
        "count": (state["count"] + 1).float()}
    store, *pools = (w.reshape(-1, w.shape[-1]) for w in want)
    kernel_ops.fused_row_update(store, grads["tables"].rows,
                                grads["tables"].vals, *pools, kind=opt_name,
                                **hyper)
    new_p, new_s = opt.apply(grads, state, params)
    assert new_p["tables"] is params["tables"]
    assert torch.equal(new_p["tables"], want[0])
    for k, w in zip(moments, want[1:]):
        assert new_s[k]["tables"] is state[k]["tables"]
        assert torch.equal(new_s[k]["tables"], w)
    assert not torch.equal(want[0], _row_case(opt_name)[1]["tables"])
    if opt_name == "adam":
        assert int(new_s["count"]) == int(state["count"]) + 1


@pytest.mark.parametrize("how", ["adagrad.update", "adam.update",
                                 "adam_master.apply"])
def test_only_apply_takes_a_row_leaf(how):
    name, call = how.split(".")
    opt_name = name.split("_")[0]
    opt, params, state, grads = _row_case(opt_name)
    if name == "adam_master":
        opt = optim.adam(LR, master_weights=True)
        state = opt.init(params)
    before = params["tables"].clone()
    with pytest.raises(ValueError, match="SparseRowGrad"):
        getattr(opt, call)(grads, state, params)
    assert torch.equal(params["tables"], before)


@pytest.mark.parametrize("opt_name", ["adagrad", "adam"])
def test_sparse_step_with_a_clip_takes_the_global_norm_once(monkeypatch,
                                                           opt_name):
    """The joint norm is taken once and also scales the joint clip; the
    optimizer's own clip then reads the dense leaves alone."""
    _, state, step, batches = _dlrm("wide_deep", True, opt_name,
                                    clip_norm=0.5)
    norm, calls = mt.global_norm, []

    def counted(leaves):
        calls.append(sum(isinstance(l, optim.SparseRowGrad)
                         for l in leaves))
        return norm(leaves)

    monkeypatch.setattr(mt, "global_norm", counted)
    _, m = step(state, batches[0])
    assert calls == [2, 0]      # the joint tree (both stores), the dense part
    assert torch.isfinite(m["grad_norm"])


# --- the benchmark's reader ---------------------------------------------------
def _reader():
    return importlib.import_module("portbench.metrics.dense_fused_share")


@pytest.mark.parametrize("counts,profiled,want", [
    ({"dense_leaves": 52, "dense_leaves_fused": 52}, 30, 100.0),
    ({"dense_leaves": 40, "dense_leaves_fused": 10}, 30, 25.0),
    ({"dense_leaves": 0, "dense_leaves_fused": 0}, 30, None),
    ({"dense_leaves": 52, "dense_leaves_fused": 52}, 0, None),
])
def test_dense_fused_share_reads_the_leaf_counts(monkeypatch, counts,
                                                 profiled, want):
    for k, v in counts.items():
        monkeypatch.setitem(cuda_lib.LEAF_COUNTS, k, v)
    assert _reader().read({"profiled_steps": profiled}) == want


def test_dense_fused_share_is_silent_without_leaf_counts(monkeypatch):
    """A program without the counts (the parent's) reads nothing."""
    monkeypatch.delattr(cuda_lib, "LEAF_COUNTS")
    assert _reader().read({"profiled_steps": 30}) is None
