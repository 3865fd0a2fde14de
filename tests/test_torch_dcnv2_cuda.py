"""DLRM-DCNv2's kernels on the card: K1's D=128 route and its ragged bags,
the segment sum of ragged bags, K2 at D=128, and a small DCNv2 step.

Marked ``cuda``: without a CUDA device every test here skips (the kernels
have no CPU mode). On a machine with one, run
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_dcnv2_cuda.py``.

K1 on the D=128 route (a warp per bag) equals its plain version bit for
bit, on ragged bags with a 100-lookup table and tables of 1 to 27, and
on ``(B, T, H)`` bags, for every combiner, weighted or not, with a cache
and with indices past the pool; ragged bags at another width take the
generic route, bit for bit too. The dedupe's segment sum on ragged bags
reads each lookup's bag through the plan's column-to-table map and gives
``torch.segment_reduce``'s bits, with a 3-row table of 100 lookups whose
segments take the long pass. K2 and K3 at D=128 (a warp per row) equal
their plain versions on the card bit for bit. A small DCNv2
step on the card matches the CPU's and launches each new route once a
step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_ulp_close  # noqa: E402  (sets torch threads)
from repro_torch.configs import dlrm_models as tcfg  # noqa: E402
from repro_torch.data.synthetic import criteo_batch  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import fused_embedding as fe  # noqa: E402
from repro_torch.kernels import fused_update as fu  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402
from repro_torch.train import optim, trainer  # noqa: E402

pytestmark = pytest.mark.cuda

# DLRM-DCNv2's per-feature lookups: one table of 100, the rest 1 to 27
SIZES = tcfg.CRITEO_1TB_MULTI_HOT


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cuda_lib.load()
    return launch.resolve_device("cuda")


def _enc(rng, shape, R, K):
    """Pool rows, ~5 % of them >= R; with a cache ~30 % hot slots, else
    ~5 % negative ids (read as pool row 0)."""
    enc = rng.integers(0, R, shape).astype(np.int32)
    enc[rng.random(shape) < 0.05] = R + 3
    neg = rng.random(shape) < (0.3 if K else 0.05)
    enc[neg] = -(rng.integers(0, max(K, 20), int(neg.sum())) + 1)
    return torch.from_numpy(enc)


def _k1(dev, pool, enc, w, cache, combiner, sizes, route, key):
    want = fe.embedding_bag_plain(pool, enc, w, cache, combiner, sizes)
    args = [None if x is None else x.to(dev) for x in (pool, enc, w, cache)]
    T = len(sizes) if sizes is not None else enc.shape[1]
    out = torch.empty((enc.shape[0], T, pool.shape[1]), device=dev)
    H = 0 if sizes is not None else enc.shape[2]
    assert fe.bag_route(pool.shape[1], H, *(x for x in (*args, out)
                                            if x is not None)) == route
    cuda_lib.reset_launches()
    got = fe.embedding_bag_forward(*args, combiner, sizes)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["fused_embedding_bag"] == 1
    if key is not None:
        assert cuda_lib.LAUNCHES[key] == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("K", [0, 40])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_k1_d128_on_ragged_bags_matches_plain(dev, combiner, weighted, K):
    rng = np.random.default_rng(5)
    B, R, D = 300, 7000, 128
    pool = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32))
    cache = torch.from_numpy(rng.standard_normal((K, D)).astype(np.float32)) \
        if K else None
    enc = _enc(rng, (B, sum(SIZES)), R, K)
    w = torch.from_numpy(rng.uniform(0.5, 2, enc.shape).astype(np.float32)) \
        if weighted else None
    _k1(dev, pool, enc, w, cache, combiner, SIZES, "d128",
        "embedding_bag_d128")


@pytest.mark.parametrize("H", [1, 4, 33, 100])
def test_k1_d128_on_uniform_bags_matches_plain(dev, H):
    rng = np.random.default_rng(H)
    pool = torch.from_numpy(rng.standard_normal((900, 128)).astype(
        np.float32))
    _k1(dev, pool, _enc(rng, (70, 3, H), 900, 0), None, None, "sum", None,
        "d128", "embedding_bag_d128")


@pytest.mark.parametrize("D", [8, 16, 3])
def test_k1_ragged_bags_at_other_widths_take_the_generic_route(dev, D):
    rng = np.random.default_rng(D)
    sizes = (3, 1, 12, 2, 100)
    pool = torch.from_numpy(rng.standard_normal((500, D)).astype(np.float32))
    _k1(dev, pool, _enc(rng, (40, sum(sizes)), 500, 0), None, None, "mean",
        sizes, "generic", "embedding_bag_ragged")


def _ragged_rows(rng, B, sizes, table_rows):
    starts = fe.table_offsets(table_rows)
    cols = [rng.integers(0, r, (B, h)) + o
            for r, h, o in zip(table_rows, sizes, starts)]
    return torch.from_numpy(np.concatenate(cols, axis=1).reshape(-1))


@pytest.mark.parametrize("D", [128, 16, 5])
def test_segment_sum_of_ragged_bags_matches_segment_reduce(dev, D):
    """A 3-row table of 100 lookups: ~17 k lookups a row at B=512, listed
    at the front of the long pass; a 100 k-row table of 27: short ones."""
    rng = np.random.default_rng(9)
    sizes, table_rows, B = (100, 1, 27, 3), (3, 40, 100000, 7), 512
    R = sum(table_rows)
    rows = _ragged_rows(rng, B, sizes, table_rows)
    g_bags = torch.from_numpy(
        rng.standard_normal((B * len(sizes), D)).astype(np.float32))
    want_rows, want_vals = fe.dedupe_bags(rows, g_bags, 0, R, sizes)
    cuda_lib.reset_launches()
    got_rows, got_vals = fe.dedupe_bags(rows.to(dev), g_bags.to(dev), 0, R,
                                        sizes)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["segment_sum_ragged"] == 1
    assert sum(cuda_lib.LAUNCHES.values()) == 1
    assert torch.equal(got_rows.cpu(), want_rows)
    assert torch.equal(got_vals.cpu(), want_vals)
    # the longest segment is past the long pass's first-list threshold
    _, counts = torch.unique(rows, return_counts=True)
    assert int(counts.max()) > 16384


@pytest.mark.parametrize("case", ["tail", "scattered", "one", "odd"])
def test_k2_k3_at_d128_match_plain(dev, case):
    """K2 and K3 on the D=128 route (a warp per row, two rows at a time):
    unsorted live rows, padding (R and negative) as a tail or scattered,
    one live row, an odd count of live rows in a warp's 32."""
    rng = np.random.default_rng(4)
    R, D = 20000, 128
    n, live = {"tail": (3000, 2800), "scattered": (3000, 2000),
               "one": (40, 1), "odd": (67, 33)}[case]
    rows = np.full(n, R, np.int32)
    at = np.arange(n) if case != "scattered" else rng.permutation(n)
    rows[at[:live]] = rng.permutation(R)[:live]
    if case == "scattered":
        rows[at[live:live + 300]] = -5
    rows = torch.from_numpy(rows)
    vals = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    p0 = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(0, 1, (R, D)).astype(np.float32))
    for kind in ("adagrad", "adam"):
        pools = (p0, u) if kind == "adagrad" else (p0, u - 0.5, u)
        got = [x.to(dev) for x in pools]
        want = [x.clone() for x in got]
        r, v = rows.to(dev), vals.to(dev)
        assert fu.update_route(D, *got, v) == "vector"
        cuda_lib.reset_launches()
        if kind == "adagrad":
            fu.adagrad_row_update(*got, r, v, lr=0.05)
            fu.adagrad_rows_plain(*want, r, v, lr=0.05, eps=1e-10)
        else:
            hyper = dict(lr=0.05, b1=0.9, b2=0.999, eps=1e-8)
            fu.adam_row_update(*got, r, v, count=3, weight_decay=0.01,
                               **hyper)
            fu.adam_rows_plain(*want, r, v, fu.adam_bias(3, 0.9, 0.999, dev),
                               wd=0.01, **hyper)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES[f"{kind}_row_update"] == 1
        assert cuda_lib.LAUNCHES["row_update_d128"] == 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), kind
    # against the plain version on the CPU, whose vectorised sqrt may sit
    # an ulp away: near cancellations in p + upd that is many ulps of p
    pc, ac = p0.clone(), u.clone()
    fu.adagrad_row_update(pc, ac, rows, vals, lr=0.05)
    got = [x.to(dev) for x in (p0, u)]
    fu.adagrad_row_update(*got, rows.to(dev), vals.to(dev), lr=0.05)
    torch.testing.assert_close(got[0].cpu(), pc, rtol=1e-6, atol=1e-7)
    assert_ulp_close(got[1].cpu().numpy(), ac.numpy(), 4, "acc")


@pytest.mark.parametrize("D", [8, 128])
def test_small_dcnv2_step_on_card_matches_cpu(dev, D):
    cfg = tcfg.reduced_dlrm(tcfg.DLRM_DCNV2)
    cfg = dataclasses.replace(cfg, embed_dim=D, bottom_mlp_dims=(16, D),
                              zipf_alpha=1.05, hot_rows_k=8)
    layout = tpol.padded_layout_for_ranges(
        tpol.uniform_vocab_ranges(cfg.total_embedding_rows, 4))
    plan = cfg.embedding_plan(layout=layout, sparse_update=True)
    B = cfg.batch_size
    batches = [criteo_batch(cfg, 7, np.arange(i * B, (i + 1) * B))
               for i in range(3)]
    states = []
    for d in ("cpu", dev):
        opt = optim.make("adagrad", 3e-3)
        state = trainer.make_dlrm_train_state(
            cfg, opt, torch.Generator().manual_seed(0), layout=layout)
        state = {"params": {k: v.to(d) for k, v in state["params"].items()},
                 "opt": {"acc": {k: v.to(d) for k, v in
                                 state["opt"]["acc"].items()}}, "step": 0}
        step = trainer.make_dlrm_train_step(cfg, opt, plan=plan)
        cuda_lib.reset_launches()
        for b in batches:
            state, _ = step(state, launch.to_device(b, d))
        states.append(state)
    route = "embedding_bag_d128" if D == 128 else "embedding_bag_ragged"
    assert cuda_lib.LAUNCHES[route] == len(batches)
    assert cuda_lib.LAUNCHES["segment_sum_ragged"] == len(batches)
    assert cuda_lib.LAUNCHES["adagrad_row_update"] == len(batches)
    assert cuda_lib.LAUNCHES["row_update_d128"] == (
        len(batches) if D == 128 else 0)
    for k, v in states[0]["params"].items():
        torch.testing.assert_close(states[1]["params"][k].cpu(), v,
                                   rtol=2e-5, atol=2e-5)


def test_the_cross_span_holds_device_work_forward_and_backward(dev,
                                                               tmp_path):
    """Under the profiler, on the card: the cross network's kernels (its
    GEMMs and ``addcmul``s, forward and backward) count under
    ``train_step.cross``; the step launches K1's D=128 route, the ragged
    segment sum and K2's D=128 route once each."""
    import json

    from portbench.yardstick import spans

    cfg = dataclasses.replace(
        tcfg.reduced_dlrm(tcfg.DLRM_DCNV2), embed_dim=128,
        bottom_mlp_dims=(16, 128), zipf_alpha=1.05, hot_rows_k=8)
    layout = tpol.padded_layout_for_ranges(
        tpol.uniform_vocab_ranges(cfg.total_embedding_rows, 4))
    opt = optim.make("adagrad", 3e-3)
    state = trainer.make_dlrm_train_state(
        cfg, opt, torch.Generator(device=dev).manual_seed(0), layout=layout)
    step = trainer.make_dlrm_train_step(
        cfg, opt, plan=cfg.embedding_plan(layout=layout, sparse_update=True))
    batch = launch.to_device(criteo_batch(cfg, 7, np.arange(32)), dev)
    state, _ = step(state, batch)                        # warm
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_span = spans.kernels_by_span(events)
    cross = by_span.get("train_step.cross", {})
    assert any("gemm" in k.lower() for k in cross), sorted(cross)
    assert any("addcmul" in k for k in cross), sorted(cross)
    assert spans.reduce(events)["train_step.cross"]["launches"] >= \
        6 * cfg.cross_layers
    for key in ("embedding_bag_d128", "segment_sum_ragged",
                "row_update_d128"):
        assert cuda_lib.LAUNCHES[key] == 1, key
