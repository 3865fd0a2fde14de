"""DLRM-DCNv2 on the port, on the CPU at a small size.

The small configuration (``reduced_dlrm(DLRM_DCNV2)``): 4 tables of ragged
bags (3, 1, 12 and 2 lookups), D=8, a bottom MLP 16-8, 2 cross layers of
rank 4, an over MLP 16-8-1, B=32. The program's forward, loss and every
leaf's gradient, and three fused sparse adagrad steps (padded layout,
hot-row cache), agree with the plain reference ``_dcnv2_reference.py``.
K1's plain version and the dedupe on ragged bags agree with index
arithmetic; ragged bags whose sizes are all 4 give the ``(B, T, H)``
path's bits; ``max`` and weighted ragged bags differentiate as plain
autograd does. The cross network's forward and backward run under the
span ``train_step.cross``, and the launcher trains ``--arch dlrm_dcnv2``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import _dcnv2_reference as ref
import _torch_parity  # noqa: F401  (one CPU thread)
from repro_torch.configs import dlrm_models as tcfg
from repro_torch.configs.registry import get_dlrm
from repro_torch.data.synthetic import criteo_batch
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import fused_embedding as fe
from repro_torch.launch import train as launch
from repro_torch.launch.train import to_device
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.sharding import policy as tpol
from repro_torch.train import optim as toptim
from repro_torch.train import trainer as ttrainer

SMALL = tcfg.reduced_dlrm(tcfg.DLRM_DCNV2)
LR, EPS = 3e-3, 1e-10


def _cfg(**kw):
    return dataclasses.replace(SMALL, zipf_alpha=1.05, **kw)


def _model(cfg):
    return dict(table_rows=cfg.table_rows, sizes=cfg.bag_sizes,
                n_bottom=len(cfg.bottom_mlp_dims), n_cross=cfg.cross_layers,
                n_over=len(cfg.mlp_dims))


def _batches(cfg, n, seed=7):
    B = cfg.batch_size
    return [to_device(criteo_batch(cfg, seed, np.arange(i * B, (i + 1) * B)),
                      "cpu") for i in range(n)]


def _layout(cfg):
    return tpol.padded_layout_for_ranges(
        tpol.uniform_vocab_ranges(cfg.total_embedding_rows, 4))


def test_the_small_and_full_configs():
    full = get_dlrm("dlrm_dcnv2")
    assert full is tcfg.DLRM_DCNV2
    assert (full.embed_dim, full.bottom_mlp_dims, full.mlp_dims,
            full.cross_layers, full.cross_low_rank, full.batch_size) == \
        (128, (512, 256, 128), (1024, 1024, 512, 256), 3, 512, 8192)
    assert full.total_embedding_rows == 204_184_588
    assert full.lookups_per_sample == 214 and full.interaction_dim == 3456
    dense = full.param_count() - full.total_embedding_rows * 128
    # bottom 13-512-256-128, 3 cross layers of 2 x 3456 x 512 + 3456,
    # over 3456-1024-1024-512-256-1
    assert dense == (13 * 512 + 512 + 512 * 256 + 256 + 256 * 128 + 128
                     + 3 * (2 * 3456 * 512 + 3456)
                     + 3456 * 1024 + 1024 + 1024 * 1024 + 1024
                     + 1024 * 512 + 512 + 512 * 256 + 256 + 256 + 1)
    assert (SMALL.n_tables, SMALL.bag_sizes, SMALL.embed_dim,
            SMALL.bottom_mlp_dims, SMALL.cross_layers, SMALL.cross_low_rank,
            SMALL.mlp_dims, SMALL.batch_size) == \
        (4, (3, 1, 12, 2), 8, (16, 8), 2, 4, (16, 8), 32)
    names = set(dlrm_mod.init_dlrm(SMALL, torch.Generator().manual_seed(0)))
    assert sum(v.numel() for v in dlrm_mod.init_dlrm(
        SMALL, torch.Generator().manual_seed(0)).values()) == \
        SMALL.param_count()
    assert {"cross.v1", "cross.w1", "cross_b.b1", "bot.w1"} <= names
    with pytest.raises(ValueError):
        dataclasses.replace(SMALL, multi_hot=(3, 1, 12))


def test_ragged_batches_and_the_uniform_stream_keep_their_bytes():
    b = criteo_batch(_cfg(), 3, np.arange(5))
    assert b["sparse"].shape == (5, 18)
    starts = fe.bag_starts(SMALL.bag_sizes)
    for t, rows in enumerate(SMALL.table_rows):
        cols = b["sparse"][:, starts[t]:starts[t + 1]]
        assert cols.min() >= 0 and cols.max() < rows
    wd = dataclasses.replace(tcfg.reduced_dlrm(get_dlrm("wide_deep")),
                             multi_hot=4, zipf_alpha=1.05)
    ragged = dataclasses.replace(wd, multi_hot=(4,) * wd.n_tables)
    u, r = criteo_batch(wd, 3, np.arange(9)), criteo_batch(ragged, 3,
                                                           np.arange(9))
    assert u["sparse"].shape == (9, wd.n_tables, 4)
    assert r["sparse"].tobytes() == u["sparse"].tobytes()
    assert r["label"].tobytes() == u["label"].tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_loss_and_every_gradient_match_the_reference(seed):
    cfg = _cfg()
    params = dlrm_mod.init_dlrm(cfg, torch.Generator().manual_seed(seed))
    (batch,) = _batches(cfg, 1, seed=seed + 11)
    plan = cfg.embedding_plan()
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    logit = dlrm_mod.dlrm_forward(leaves, batch, cfg, plan)
    loss = dlrm_mod.dlrm_loss(leaves, batch, cfg, plan)
    grads = torch.autograd.grad(loss, list(leaves.values()))

    rleaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    rlogit = ref.logits(rleaves, batch, **_model(cfg))
    rloss = ref.loss(rleaves, batch, **_model(cfg))
    rgrads = torch.autograd.grad(rloss, list(rleaves.values()))
    torch.testing.assert_close(logit, rlogit, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(loss, rloss, rtol=1e-6, atol=1e-7)
    for name, g, rg in zip(leaves, grads, rgrads):
        assert float(rg.abs().max()) > 0, name
        torch.testing.assert_close(g, rg, rtol=1e-4, atol=1e-7), name


@pytest.mark.parametrize("hot", [0, 8])
def test_three_sparse_adagrad_steps_match_the_reference(hot):
    cfg = _cfg(hot_rows_k=hot)
    layout = _layout(cfg)
    opt = toptim.make("adagrad", LR, eps=EPS)
    params = dlrm_mod.init_dlrm(cfg, torch.Generator().manual_seed(5))
    state = {"params": {k: layout.pad_rows(v) if k == "tables" else v.clone()
                        for k, v in params.items()}, "step": 0}
    state["opt"] = opt.init(state["params"])
    step = ttrainer.make_dlrm_train_step(
        cfg, opt, plan=cfg.embedding_plan(layout=layout, sparse_update=True))
    batches = _batches(cfg, 3)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    want, want_losses = ref.adagrad_steps(params, batches, lr=LR, eps=EPS,
                                          **_model(cfg))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    got = dict(state["params"])
    got["tables"] = layout.unpad_rows(got["tables"])
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)
        moved = (want[k] != params[k]).any()
        assert bool(moved) or k.startswith("cross_b"), k


def _ragged_lookups(seed, B, sizes, R, K=0):
    g = torch.Generator().manual_seed(seed)
    enc = torch.randint(0, R, (B, sum(sizes)), generator=g, dtype=torch.int32)
    if K:
        hot = torch.rand(enc.shape, generator=g) < 0.3
        enc[hot] = -torch.randint(1, K + 1, (int(hot.sum()),), generator=g,
                                  dtype=torch.int32)
    return enc


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_ragged_k1_plain_version_is_index_arithmetic(combiner, weighted):
    sizes, B, R, K, D = (3, 1, 12, 2, 100), 6, 40, 5, 8
    g = torch.Generator().manual_seed(3)
    pool, cache = torch.randn(R, D, generator=g), torch.randn(K, D, generator=g)
    enc = _ragged_lookups(4, B, sizes, R, K)
    w = torch.rand(enc.shape, generator=g) if weighted else None
    got = fe.embedding_bag_plain(pool, enc, w, cache, combiner, sizes)
    starts = fe.bag_starts(sizes)
    assert got.shape == (B, len(sizes), D)
    for b in range(B):
        for t in range(len(sizes)):
            acc = None
            for j in range(starts[t], starts[t + 1]):
                v = int(enc[b, j])
                x = cache[-v - 1] if v < 0 else pool[v]
                if weighted:
                    x = x * w[b, j]
                acc = x if acc is None else (
                    torch.maximum(acc, x) if combiner == "max" else acc + x)
            if combiner == "mean":
                acc = acc / torch.tensor(float(sizes[t]))
            assert torch.equal(got[b, t], acc), (b, t)


def test_ragged_dedupe_is_index_arithmetic():
    sizes, B, R, D = (3, 1, 12, 2, 100), 5, 30, 4
    L, T = sum(sizes), len(sizes)
    rows = _ragged_lookups(6, B, sizes, R).reshape(-1)
    g_bags = torch.randn(B * T, D, generator=torch.Generator().manual_seed(1))
    bag = [b * T + t for b in range(B) for t in range(T)
           for _ in range(sizes[t])]
    assert fe.lookup_bags(torch.arange(B * L), 0, sizes).tolist() == bag
    assert fe.lookup_tables(sizes) == tuple(
        t for t in range(T) for _ in range(sizes[t]))
    cuda_lib.reset_launches()
    got_rows, got_vals = fe.dedupe_bags(rows, g_bags, 0, R, sizes)
    want_rows, want_vals = fe.dedupe_rows(rows, g_bags[torch.tensor(bag)], R)
    assert torch.equal(got_rows, want_rows)
    assert torch.equal(got_vals, want_vals)
    n_uniq = int((got_rows < R).sum())
    assert n_uniq == len(set(rows.tolist()))
    for j in range(n_uniq):
        at = [i for i in range(B * L) if int(rows[i]) == int(got_rows[j])]
        want = torch.zeros(D)
        for i in at:
            want = want + g_bags[bag[i]]
        assert torch.equal(got_vals[j], want)
    assert cuda_lib.LAUNCHES["segment_sum_ragged"] == 0      # no card here


@pytest.mark.parametrize("hot", [0, 8])
@pytest.mark.parametrize("kind", ["wide_deep", "xdeepfm"])
def test_ragged_bags_of_equal_size_are_the_uniform_path_bit_for_bit(kind,
                                                                      hot):
    uni = dataclasses.replace(tcfg.reduced_dlrm(get_dlrm(kind)), multi_hot=4,
                              zipf_alpha=1.05, hot_rows_k=hot)
    rag = dataclasses.replace(uni, multi_hot=(4,) * uni.n_tables)
    layout = _layout(uni)
    out = []
    for cfg in (uni, rag):
        opt = toptim.make("adagrad", LR)
        state = ttrainer.make_dlrm_train_state(
            cfg, opt, torch.Generator().manual_seed(0), layout=layout)
        step = ttrainer.make_dlrm_train_step(
            cfg, opt, plan=cfg.embedding_plan(layout=layout,
                                              sparse_update=True))
        losses = []
        for b in _batches(cfg, 3):
            state, m = step(state, b)
            losses.append(m["loss"])
        out.append((state, torch.stack(losses)))
    (su, lu), (sr, lr) = out
    assert _batches(rag, 1)[0]["sparse"].dim() == 2
    assert torch.equal(lu, lr)
    for part in ("params", "opt"):
        a, b = (list(toptim.tree_leaves(s[part])) for s in (su, sr))
        assert len(a) == len(b) > 0
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _ragged_bag_ref(pool, enc, w, sizes, combiner):
    starts = fe.bag_starts(sizes)
    x = pool[enc.long()]
    if w is not None:
        x = x * w[..., None]
    out = []
    for a, b in zip(starts, starts[1:]):
        part = x[:, a:b]
        out.append({"sum": part.sum(1), "mean": part.mean(1),
                    "max": part.amax(1)}[combiner])
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_ragged_bags_differentiate_as_plain_autograd(combiner, weighted):
    sizes, B, D = (3, 1, 12, 2), 6, 8
    table_rows = (20, 3, 50, 9)
    plan = tpol.EmbeddingPlan(offsets=fe.table_offsets(table_rows),
                              combiner=combiner, bag_sizes=sizes)
    g = torch.Generator().manual_seed(8)
    pool = torch.randn(sum(table_rows), D, generator=g)
    local = torch.cat([torch.randint(0, r, (B, h), generator=g)
                       for r, h in zip(table_rows, sizes)], dim=1)
    w = torch.rand(local.shape, generator=g) if weighted else None
    cot = torch.randn(B, len(sizes), D, generator=g)
    flat = local + torch.tensor(fe.per_column(plan.offsets, sizes))[None, :]
    leaves = [pool.clone().requires_grad_()] + (
        [w.clone().requires_grad_()] if weighted else [])
    got = fe.fused_embedding_bag(leaves[0], local.to(torch.int32),
                                 leaves[1] if weighted else None, plan=plan)
    want_leaves = [x.clone().requires_grad_() for x in leaves]
    want = _ragged_bag_ref(want_leaves[0], flat,
                           want_leaves[1] if weighted else None, sizes,
                           combiner)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    gg = torch.autograd.grad(got, leaves, cot)
    wg = torch.autograd.grad(want, want_leaves, cot)
    for a, b in zip(gg, wg):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # the fused sparse backward: the dense gradient's rows, bit for bit
    rows, vals, dw = fe.sparse_row_grads(pool, local, cot, w, plan=plan)
    assert torch.equal(fe.scatter_rows(rows, vals, pool.shape[0]), gg[0])
    if weighted:
        assert torch.equal(dw, gg[1])


def _profiled(step, state, batches, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for b in batches:
            state, _ = step(state, b)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_the_cross_network_records_its_span_forward_and_backward(tmp_path):
    cfg = _cfg(hot_rows_k=8)
    layout = _layout(cfg)
    opt = toptim.make("adagrad", LR)
    state = ttrainer.make_dlrm_train_state(
        cfg, opt, torch.Generator().manual_seed(0), layout=layout)
    step = ttrainer.make_dlrm_train_step(
        cfg, opt, plan=cfg.embedding_plan(layout=layout, sparse_update=True))
    batches = _batches(cfg, 2)
    cuda_lib.reset_launches()
    events = _profiled(step, state, batches, tmp_path)
    done = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in done
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("train_step."))
    cross = [s for s in spans if s[2] == "train_step.cross"]
    fwd_bwd = [s for s in spans if s[2] == "train_step.forward_backward"]
    assert len(cross) == 2 * len(batches) and len(fwd_bwd) == len(batches)
    for s, t, _ in cross:                     # inside the dense network's
        assert any(a <= s and t <= b for a, b, _ in fwd_bwd)

    def ops_in(s, t, name):
        return sum(1 for e in done if e.get("cat") == "cpu_op"
                   and e["name"] == name
                   and s <= float(e["ts"]) <= t)
    n = cfg.cross_layers
    for i, (s, t, _) in enumerate(cross):
        if i % 2 == 0:                        # the forward
            assert ops_in(s, t, "aten::addcmul") == n
            assert ops_in(s, t, "aten::addmm") == n
        else:                                 # the backward
            assert ops_in(s, t, "aten::addcmul_") == n
            assert ops_in(s, t, "aten::mm") >= 3 * n
    # nothing launches on the CPU: the new routes' counts stay at zero
    for key in ("embedding_bag_d128", "embedding_bag_ragged",
                "segment_sum_ragged"):
        assert cuda_lib.LAUNCHES[key] == 0


def test_the_launcher_trains_dlrm_dcnv2(capsys):
    run = launch.train_dlrm(launch.build_parser().parse_args(
        ["--arch", "dlrm_dcnv2", "--steps", "12", "--fused-update",
         "--padded-shards", "--hot-rows", "8", "--zipf-alpha", "1.05",
         "--replan-every", "4", "--device", "cpu"]))
    out = capsys.readouterr().out
    assert "arch=dlrm_dcnv2 kind=dcnv2" in out and "fused sparse update" in out
    assert len(run.losses) == 12 and all(np.isfinite(run.losses))
    assert run.exactly_once
    assert run.cfg.bag_sizes == (3, 1, 12, 2)
