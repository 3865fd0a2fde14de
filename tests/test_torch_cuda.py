"""The CUDA kernels K1–K5 against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with one, run ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

K1 equals its plain version bit for bit, on the card and on the CPU, on
each of its routes (vector at D=16, wide at D=1, generic for any other
shape or alignment), with indices past the pool and, with no cache,
negative ones. K2 and K3 equal their plain versions on the card bit for bit (the kernels
spell their arithmetic with the uncontracted ``_rn`` intrinsics in the
plain versions' order), on both routes, with padding entries anywhere and
at edge shapes; against the plain versions on the CPU they are held to
the ULP bounds of the reference's fused-update tests (params 64, moments
4): PyTorch's CPU ``sqrt`` (vectorised) is not always correctly rounded,
so the CPU result may sit an ULP away. Rows the update does not touch stay
bit-identical. A reduced
train step on the card matches the CPU within 2e-5 and is deterministic.
After a live re-plan onto unequal padded ranges with a measured cache
plan, K1 still equals its plain version, and the forward loss, one fused
step and a restore onto the new plan are bit-exact on the card.

K4 and K5 agree with their plain versions within 2e-5 in f32 and, in
bf16, within 1e-3 plus 8e-3 of the output (one bf16 step): both compute in
f32, in other summation orders, and round once at the end (K4's
tensor-core route carries p as a bf16 hi + lo pair, about 2^-17). K4 cases
in bf16 with head dim 64, 128 or 256 take the tensor-core route, the rest
the SIMT route; where that route's grid is under one wave (few queries
against many keys at B=1, Whisper's cross-attention) it is split over the
keys, with dead ranges, rows with no valid key (exactly 0) and the same
bits on every launch; K5 cases of 600 or more slots are split across the cache.
Head dim 256 with 10 q-heads per kv-head (recurrentgemma's local layers)
takes K4's tensor-core route in bf16 (its 64-key instance, at the tile's
edges: ragged, windowed, softcapped, offset, one query, rows with no valid
key) and its SIMT route in f32, and K5's wide instance; Whisper's
non-causal encoder and cross-attention shapes (``Sq = 1`` against a key
count that is no multiple of the tile) run on both K4 routes.
The reduced LM's logits on the card match the CPU's within 1e-4, and the
serving engine gives the CPU's greedy tokens; so do the reduced MoE, SSM,
hybrid and enc-dec models, forward and decode, with K4 and K5 launched
once per attention layer and call.

K4 and K5 refuse inputs that require grad under grad mode. A reduced LM
train step (llama, whisper; f32, remat, adamw) on the card matches the
CPU's for three steps and launches no kernel (attention trains on the
chunked route); its eval step launches K4 once per attention call.

The dedupe's segment sum (``csrc/segment_sum.cu``) gives the rows and
values of the sorted gather and ``torch.segment_reduce`` bit for bit, on
both routes (bag cotangents read through ``order // H``, per-lookup ones
through ``order``): at full-width Wide&Deep's shapes (D=16 and D=1, a
~146 k-entry segment), at segment lengths around each of its thresholds,
at odd and wide widths and off 16 bytes. The sparse backward on the card
takes the bags route for unweighted sum and mean and keeps the dense
gradient's bits; the fused step launches it once per store.

The lifecycle example (``examples/elastic_dlrm_train_torch.py``) at a small
config runs 151 steps on the card: K1 launches twice per executed step
plus twice for the eval, and the exactly-once coverage, the step count and
every brain decision equal the CPU run's (which
``tests/test_torch_brain.py`` holds to the reference).
"""
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_ulp_close  # noqa: E402  (sets torch threads)
from portbench.yardstick import traffic  # noqa: E402
from repro_torch.configs import dlrm_models as tcfg  # noqa: E402
from repro_torch.configs.registry import get_dlrm  # noqa: E402
from repro_torch.data.synthetic import criteo_batch  # noqa: E402
from repro_torch.configs.base import reduce_config  # noqa: E402
from repro_torch.core.flash_checkpoint import FlashCheckpoint  # noqa: E402
from repro_torch.core.sharding_service import HotTableTracker  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_embedding as fe  # noqa: E402
from repro_torch.kernels import fused_update as fu  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.dlrm import dlrm_loss  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve import engine as serve_engine  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402
from repro_torch.train import optim, replan, trainer  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cuda_lib.load()
    return launch.resolve_device("cuda")


def _encoded(rng, B, T, H, R, K):
    """Encoded lookups: pool rows, about 5% of them ``>= R`` (read as row
    R-1); with a cache about 40% hot slots, without one about 10% negative
    ids (read as pool row 0)."""
    enc = rng.integers(0, R, (B, T, H)).astype(np.int32)
    enc[rng.random((B, T, H)) < 0.05] = R + 7
    neg = rng.random((B, T, H)) < (0.4 if K else 0.1)
    enc[neg] = -(rng.integers(0, max(K, 50), neg.sum()) + 1)
    return enc


def _k1_on_card(dev, pool, enc, w, cache, combiner, route):
    """K1 through its entry point on the card: one launch on ``route``,
    bit for bit with the plain version on the CPU and on the card."""
    want = fe.embedding_bag_plain(pool.cpu(), enc.cpu(),
                                  None if w is None else w.cpu(),
                                  None if cache is None else cache.cpu(),
                                  combiner)
    args = [None if x is None else x.to(dev) for x in (pool, enc, w, cache)]
    B, T, H = enc.shape
    out = torch.empty((B, T, pool.shape[1]), device=dev)
    assert fe.bag_route(pool.shape[1], H, *(x for x in (*args, out)
                                            if x is not None)) == route
    cuda_lib.reset_launches()
    got = fe.embedding_bag_forward(*args, combiner)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["fused_embedding_bag"] == int(got.numel() > 0)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, fe.embedding_bag_plain(*args, combiner))


@pytest.mark.parametrize("H", [4, 2, 5])
@pytest.mark.parametrize("D", [16, 1, 4, 6])
@pytest.mark.parametrize("K", [0, 37])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_k1_matches_plain(dev, combiner, weighted, K, D, H):
    """D=16 and D=1 with H=4 take the vector and wide routes, every other
    (D, H) the generic one. With K=0, negative ids read pool row 0."""
    rng = np.random.default_rng(0)
    B, T, R = 33, 5, 1000
    pool = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32))
    cache = pool[:K].clone() if K else None
    enc = torch.from_numpy(_encoded(rng, B, T, H, R, K))
    assert (enc < 0).any() and (enc >= R).any()
    w = torch.from_numpy(rng.uniform(0.1, 2, (B, T, H)).astype(np.float32)) \
        if weighted else None
    route = ("vector" if D == 16 else "wide" if D == 1 else "generic") \
        if H == 4 else "generic"
    _k1_on_card(dev, pool, enc, w, cache, combiner, route)


def _unaligned(x):
    """A contiguous copy of ``x`` whose data pointer is 4 bytes past 16."""
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    return view


@pytest.mark.parametrize("case", ["empty", "ragged", "unaligned-pool",
                                  "unaligned-enc", "beyond-R"])
@pytest.mark.parametrize("D", [16, 1])
def test_k1_edge_cases(dev, D, case):
    """B*T = 0 (no launch); a bag count that is no multiple of a block's
    bags; a pool or index view off 16 bytes (the generic route); every
    index ``>= R`` or negative with no cache (rows R-1 and 0). Weighted
    and with a cache unless the case says otherwise; bit for bit."""
    rng = np.random.default_rng(4)
    R, K, H = 3000, 19, 4
    B, T = {"empty": (0, 26), "ragged": (37, 3)}.get(case, (16, 26))
    pool = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32))
    cache = pool[:K].clone()
    enc = torch.from_numpy(_encoded(rng, B, T, H, R, K))
    w = torch.from_numpy(rng.uniform(0.1, 2, (B, T, H)).astype(np.float32))
    route = "vector" if D == 16 else "wide"
    if case == "beyond-R":
        enc = torch.where(enc >= 0, R + enc, enc)
        cache = None
    elif case.startswith("unaligned"):
        route = "generic"
        if case == "unaligned-pool":
            pool = _unaligned(pool.to(dev))
        else:
            enc = _unaligned(enc.to(dev))
    _k1_on_card(dev, pool, enc, w, cache, "sum", route)


def _rows(rng, R, n, live, tail):
    """``n`` entries: ``live`` unique rows in random order, the rest padding
    (values >= R or negative, about half each) interleaved among them, and
    a padding tail of ``tail``."""
    pad = rng.integers(0, 1000, n)
    rows = np.where(pad % 2 == 1, -1 - pad, R + pad).astype(np.int32)
    rows[rng.choice(n - tail, live, replace=False)] = \
        rng.choice(R, live, replace=False)
    return rows


PARAM_ULP, MOMENT_ULP = 64, 4
K2_K3_HYPER = dict(lr=0.01, b1=0.9, b2=0.999, eps=1e-8)


def _k2_k3_on_card(dev, p0, a0, m0, rows, vals, wd):
    """K2 and K3 through their entry points on the card, each held bit for
    bit to its plain version on the card, one launch per call with work,
    rows not named left bit-identical. Returns the two kernels' outputs."""
    R = p0.shape[0]
    untouched = torch.ones(R, dtype=torch.bool, device=dev)
    untouched[rows[(rows >= 0) & (rows < R)].long()] = False
    want_launches = 1 if rows.shape[0] else 0
    outs = []
    for kind, start in (("adagrad", (p0, a0)), ("adam", (p0, m0, a0))):
        key = f"{kind}_row_update"
        got = [x.clone() for x in start]
        want = [x.clone() for x in start]
        cuda_lib.reset_launches()
        if kind == "adagrad":
            fu.adagrad_row_update(*got, rows, vals, lr=0.05)
            fu.adagrad_rows_plain(*want, rows, vals, lr=0.05, eps=1e-10)
        else:
            fu.adam_row_update(*got, rows, vals, count=3, weight_decay=wd,
                               **K2_K3_HYPER)
            fu.adam_rows_plain(*want, rows, vals,
                               fu.adam_bias(3, 0.9, 0.999, dev), wd=wd,
                               **K2_K3_HYPER)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES[key] == want_launches, key
        for i, (g, w, s0) in enumerate(zip(got, want, start)):
            assert torch.equal(g, w), (key, i)
            assert torch.equal(g[untouched], s0[untouched]), (key, i)
        outs.append(got)
    return outs


def _pools(rng, R, D, state):
    p0 = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(0, 1, (R, D)).astype(np.float32))
    a0 = u if state == "carried" else torch.zeros_like(u)
    m0 = u - 0.5 if state == "carried" else torch.zeros_like(u)
    return p0, a0, m0


@pytest.mark.parametrize("state", ["fresh", "carried"])
@pytest.mark.parametrize("D", [16, 1, 4, 6])
def test_k2_k3_match_plain(dev, D, state):
    """Unsorted live rows with padding (negative and >= R) interleaved and
    as a tail: bit for bit against the plain version on the card, within the ULP bounds of
    the plain version on the CPU. D=16 and D=4 take the vector route, D=1
    and D=6 (the generic width) the scalar route."""
    rng = np.random.default_rng(1)
    R, n = 5000, 900
    rows = torch.from_numpy(_rows(rng, R, n, 500, 200))
    assert (rows < 0).any() and (rows >= R).any()
    vals = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    p0, a0, m0 = _pools(rng, R, D, state)
    wd = 0.01 if state == "carried" else 0.0
    cpu = [p0, a0, m0]
    assert fu.update_route(D, *(x.to(dev) for x in (*cpu, vals))) == (
        "vector" if D % 4 == 0 else "scalar")
    k2, k3 = _k2_k3_on_card(dev, *(x.to(dev) for x in (*cpu, rows, vals)),
                            wd)
    pc, ac = p0.clone(), a0.clone()
    fu.adagrad_row_update(pc, ac, rows, vals, lr=0.05)
    pa, ma, va = p0.clone(), m0.clone(), a0.clone()
    fu.adam_row_update(pa, ma, va, rows, vals, count=3, weight_decay=wd,
                       **K2_K3_HYPER)
    bounds = (PARAM_ULP, MOMENT_ULP, MOMENT_ULP)
    for tag, got, want in (("K2", k2, (pc, ac)), ("K3", k3, (pa, ma, va))):
        for i, (g, w, bound) in enumerate(zip(got, want, bounds)):
            assert_ulp_close(g.cpu().numpy(), w.numpy(), bound,
                             f"{tag} output {i} vs plain on the cpu")


@pytest.mark.parametrize("case", ["empty", "few", "ragged", "all-padding"])
@pytest.mark.parametrize("D", [16, 1])
def test_k2_k3_edge_shapes(dev, D, case):
    """N = 0 (no launch), N < 32, N no multiple of a block's tile, and
    every entry padding (one launch that changes nothing)."""
    rng = np.random.default_rng(2)
    R = 3000
    n, live = {"empty": (0, 0), "few": (5, 3), "ragged": (2 * 1024 + 37, 900),
               "all-padding": (700, 0)}[case]
    rows = torch.from_numpy(_rows(rng, R, n, live, 0 if n < 8 else 8))
    vals = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    args = [x.to(dev) for x in (*_pools(rng, R, D, "carried"), rows, vals)]
    k2, k3 = _k2_k3_on_card(dev, *args, wd=0.01)
    if live == 0:
        assert torch.equal(k2[0], args[0]) and torch.equal(k3[0], args[0])


def test_k2_k3_unaligned_pool_takes_scalar_route(dev):
    """A D=16 pool whose data pointer is not 16-byte aligned (a view one
    element into a flat buffer) takes the scalar route, bit for bit."""
    rng = np.random.default_rng(3)
    R, D, n = 4000, 16, 600
    p0, a0, m0 = _pools(rng, R, D, "carried")
    flat = torch.zeros(R * D + 1, device=dev)
    params = flat[1:].view(R, D)
    params.copy_(p0)
    assert params.data_ptr() % 16 == 4 and params.is_contiguous()
    rows = torch.from_numpy(_rows(rng, R, n, 400, 100)).to(dev)
    vals = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32)
                            ).to(dev)
    a0, m0 = a0.to(dev), m0.to(dev)
    assert fu.update_route(D, params, a0, m0, vals) == "scalar"
    assert fu.update_route(D, p0.to(dev), a0, m0, vals) == "vector"
    _k2_k3_on_card(dev, params, a0, m0, rows, vals, wd=0.01)


@pytest.mark.parametrize("opt_name", ["adagrad", "adam"])
def test_reduced_step_on_card_matches_cpu_and_is_deterministic(dev, opt_name):
    cfg = dataclasses.replace(tcfg.reduced_dlrm(get_dlrm("wide_deep")),
                              zipf_alpha=1.05, hot_rows_k=64)
    layout = tpol.padded_layout_for_ranges(
        tpol.uniform_vocab_ranges(cfg.total_embedding_rows, 4))
    opt = optim.make(opt_name, 3e-3)
    plan = cfg.embedding_plan(layout=layout, sparse_update=True)
    step = trainer.make_dlrm_train_step(cfg, opt, plan=plan)
    batches = [criteo_batch(cfg, 11, ids)
               for ids in launch.sample_order(5, cfg.batch_size)]

    def run(device):
        state = trainer.make_dlrm_train_state(
            cfg, opt, torch.Generator().manual_seed(0), layout=layout)
        state["params"] = {k: v.to(device) for k, v in state["params"].items()}
        state["opt"] = opt.init(state["params"])
        losses = []
        for b in batches:
            state, m = step(state, launch.to_device(b, device))
            losses.append(float(m["loss"]))
        return losses, state

    cuda_lib.reset_launches()
    gpu, s1 = run(dev)
    assert cuda_lib.LAUNCHES["fused_embedding_bag"] == 2 * len(batches)
    kernel = "adagrad_row_update" if opt_name == "adagrad" else \
        "adam_row_update"
    assert cuda_lib.LAUNCHES[kernel] == 2 * len(batches)
    # unweighted bags: each store's dedupe sums the bag cotangents
    assert cuda_lib.LAUNCHES["segment_sum_bags"] == 2 * len(batches)
    assert cuda_lib.LAUNCHES["segment_sum_rows"] == 0
    cpu, _ = run("cpu")
    np.testing.assert_allclose(gpu, cpu, rtol=0, atol=2e-5)
    gpu2, s2 = run(dev)
    assert gpu2 == gpu
    for k in ("tables", "wide"):
        assert torch.equal(s1["params"][k], s2["params"][k])


def test_fused_step_syncs_only_in_the_dedupe(dev):
    """The fused sparse step blocks the host once per store, at the
    dedupe's ``unique_consecutive``: its offsets, shard starts and hot-row
    maps are made on the card once per plan, not copied from host lists in
    every step (each such copy drains the stream)."""
    cfg = dataclasses.replace(tcfg.reduced_dlrm(get_dlrm("wide_deep")),
                              zipf_alpha=1.05, hot_rows_k=64)
    layout = tpol.padded_layout_for_ranges(
        tpol.uniform_vocab_ranges(cfg.total_embedding_rows, 4))
    opt = optim.make("adagrad", 3e-3)
    plan = cfg.embedding_plan(layout=layout, sparse_update=True)
    step = trainer.make_dlrm_train_step(cfg, opt, plan=plan)
    state = trainer.make_dlrm_train_state(
        cfg, opt, torch.Generator().manual_seed(0), layout=layout)
    state["params"] = {k: v.to(dev) for k, v in state["params"].items()}
    state["opt"] = opt.init(state["params"])
    batches = [launch.to_device(criteo_batch(cfg, 11, ids), dev)
               for ids in launch.sample_order(3, cfg.batch_size)]
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for b in batches[1:]:
                state, _ = step(state, b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 2 * len(batches[1:]), [str(w.message)
                                                for w in syncs]


def _replanned(dev, opt_name="adagrad"):
    """A padded reduced Wide&Deep state on the card, 3 fused steps in, and
    the decision a drifted tracker takes on it (unequal balanced ranges,
    a measured cache plan)."""
    cfg = dataclasses.replace(tcfg.reduced_dlrm(get_dlrm("wide_deep")),
                              table_rows=(512,) * 6, zipf_alpha=1.05,
                              hot_rows_k=48)
    R = cfg.total_embedding_rows
    old = tpol.padded_layout_for_ranges(tpol.uniform_vocab_ranges(R, 4))
    opt = optim.make(opt_name, 0.05)
    plan = cfg.embedding_plan(layout=old, sparse_update=True)
    step = trainer.make_dlrm_train_step(cfg, opt, plan=plan)
    state = trainer.make_dlrm_train_state(
        cfg, opt, torch.Generator(device=dev).manual_seed(0), layout=old)
    tracker = HotTableTracker(cfg.table_rows, n_ps=4, hot_budget=48,
                              decay=0.8, trigger=1.2, cooldown=0,
                              min_lookups=512)
    for i in range(3):
        b = criteo_batch(cfg, 7, np.arange(256 * i, 256 * i + 256))
        tracker.observe(b["sparse"])
        state, _ = step(state, launch.to_device(b, dev))
    for i in range(6):
        b = criteo_batch(cfg, 7, np.arange(2048 + 256 * i, 2304 + 256 * i))
        tracker.observe((b["sparse"] + 157) % 512)
    decision = tracker.maybe_replan()
    assert decision is not None
    return cfg, opt, plan, step, state, decision


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_k1_under_a_replanned_plan_matches_plain(dev, combiner):
    """K1 on a pool padded on unequal balanced ranges, under a measured
    ``table_hot``: bit for bit with its plain version and with the flat,
    cache-off output."""
    cfg, _, _, _, state, decision = _replanned(dev)
    new = tpol.padded_layout_for_ranges(decision.vocab_ranges)
    assert new.max_range > cfg.total_embedding_rows // 4
    flat = torch.randn((cfg.total_embedding_rows, cfg.embed_dim),
                       generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)
    pool = new.pad_rows(flat).reshape(new.padded_rows, cfg.embed_dim)
    rm = replan.EmbeddingRemapper(cfg.table_rows)
    rm.compose(decision.permutation)
    raw = criteo_batch(cfg, 13, np.arange(256))
    idx = launch.to_device(rm.remap_batch(raw), dev)["sparse"]
    plan = tpol.EmbeddingPlan(offsets=cfg.table_offsets, combiner=combiner,
                              table_hot=decision.table_hot, layout=new)
    enc, cache = fe.kernel_inputs(pool, idx, plan)
    assert cache is not None and int((enc < 0).sum()) > 0
    got = fe.embedding_bag_cuda(pool, enc, None, cache, combiner)
    want = fe.embedding_bag_plain(pool, enc, None, cache, combiner)
    assert torch.equal(got, want)
    base = fe.fused_embedding_bag(
        flat, idx, plan=dataclasses.replace(plan, table_hot=None,
                                            layout=None))
    assert torch.equal(got, base)


def test_replan_on_card_is_bit_exact(dev):
    """On the card: the forward loss across a padded re-plan, one fused
    adagrad step under each plan (K1 and K2 launched under the new one),
    and a stamped old-plan snapshot restored onto the new plan."""
    cfg, opt, plan, step, state, decision = _replanned(dev)
    probe_raw = criteo_batch(cfg, 13, np.arange(10_000, 10_256))
    probe_raw["sparse"] = (probe_raw["sparse"] + 157) % 512
    probe = launch.to_device(probe_raw, dev)
    loss_old = float(dlrm_loss(state["params"], probe, cfg, plan))
    ckpt = FlashCheckpoint()
    remapper = replan.EmbeddingRemapper(cfg.table_rows)
    replan.save_with_layout(ckpt, state, state["step"], remapper,
                            layout=plan.layout)
    res = replan.apply_replan(state, cfg, opt, decision, remapper=remapper,
                              layout=plan.layout, plan=plan)
    probe_new = launch.to_device(remapper.remap_batch(probe_raw), dev)
    assert float(dlrm_loss(res.state["params"], probe_new, cfg,
                           res.plan)) == loss_old
    cuda_lib.reset_launches()
    s_new, m_new = res.step_fn(res.state, probe_new)
    assert cuda_lib.LAUNCHES["fused_embedding_bag"] == 2
    assert cuda_lib.LAUNCHES["adagrad_row_update"] == 2
    s_old, m_old = step(state, probe)
    assert float(m_new["loss"]) == float(m_old["loss"])
    assert torch.equal(s_new["params"]["mlp.w0"], s_old["params"]["mlp.w0"])
    inv = torch.as_tensor(np.argsort(decision.permutation), device=dev)
    for k in ("tables", "wide"):
        assert torch.equal(res.layout.unpad_rows(s_new["params"][k]),
                           plan.layout.unpad_rows(s_old["params"][k])[inv])
    state2, _, _, _, _ = replan.restore_on_plan(
        cfg, opt, "adagrad", ckpt, decision, device=dev, plan=plan)
    assert state2["params"]["tables"].device.type == "cuda"
    assert float(dlrm_loss(state2["params"], probe_new, cfg,
                           res.plan)) == loss_old


ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-3, 8e-3)}


def _attn_close(got, want, dtype, msg=""):
    atol, rtol = ATTN_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=atol, rtol=rtol, err_msg=msg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,G,D,causal,window,softcap,q_offset", [
    (128, 128, 3, 128, True, None, 0.0, 0),
    (100, 100, 2, 64, True, 32, 0.0, 0),       # ragged blocks + window
    (77, 77, 1, 16, False, None, 20.0, 0),     # non-causal, softcap
    (40, 104, 4, 32, True, 24, 0.0, 64),       # q_offset after a prefix
    (64, 8, 2, 16, True, 4, 0.0, 0),           # rows with no valid key
    (300, 300, 3, 128, True, None, 30.0, 0),   # ragged 128-row tiles, softcap
    (200, 330, 4, 64, True, 100, 0.0, 130),    # D=64, window, q_offset
])
def test_k4_matches_plain(dev, Sq, Skv, G, D, causal, window, softcap,
                          q_offset, dtype):
    rng = np.random.default_rng(Sq + Skv)
    B, Hkv = 2, 2
    q = torch.from_numpy(rng.standard_normal((B, Sq, Hkv * G, D))
                         .astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, Skv, Hkv, D))
                             .astype(np.float32)).to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    assert fa.tc_route(q, k) == (dtype == torch.bfloat16 and D in (64, 128))
    cuda_lib.reset_launches()
    got = fa.flash_attention(q.to(dev), k.to(dev), v.to(dev), **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    _attn_close(got, fa.flash_attention_plain(q, k, v, **kw), dtype, "cpu")
    _attn_close(got, fa.flash_attention_plain(q.to(dev), k.to(dev),
                                              v.to(dev), **kw), dtype, "card")


def _refuses_unaligned(dev, D):
    shape = (1, 64, 2, D)
    n = 64 * 2 * D
    buf = torch.zeros(n + 1, dtype=torch.bfloat16, device=dev)
    q = buf[1:].view(shape)
    k = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    assert fa.tc_route(q, k)
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_cuda(q, k, k, causal=True)
    assert cuda_lib.LAUNCHES["flash_attention"] == 0


def test_k4_tensor_core_route_refuses_unaligned_inputs(dev):
    """TMA needs 16-byte aligned q, k, v: a view 2 bytes off raises."""
    _refuses_unaligned(dev, 64)


def test_k4_tensor_core_route_refuses_unaligned_inputs_at_head_dim_256(dev):
    _refuses_unaligned(dev, 256)


@pytest.mark.parametrize("q_dtype,c_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("L,G,D,window,softcap,layout", [
    (128, 3, 128, None, 0.0, "full"),
    (300, 4, 64, None, 0.0, "padded"),          # -1 slots past the prompt
    (48, 2, 32, 16, 5.0, "ring"),               # wrapped ring + window
    (16, 8, 16, None, 0.0, "empty-row"),        # a row with no valid slot
    (1000, 4, 128, None, 0.0, "padded"),        # 8 splits, the last 5 empty
    (1000, 3, 128, None, 0.0, "empty-row"),     # 8 splits, one row empty
    (600, 2, 64, 300, 3.0, "ring"),             # 5 splits, wrapped + window
])
def test_k5_matches_plain(dev, L, G, D, window, softcap, layout, q_dtype,
                          c_dtype):
    rng = np.random.default_rng(L + G)
    B, Hkv = 3, 2
    q = torch.from_numpy(rng.standard_normal((B, 1, Hkv * G, D))
                         .astype(np.float32)).to(q_dtype)
    kc, vc = (torch.from_numpy(rng.standard_normal((B, L, Hkv, D))
                               .astype(np.float32)).to(c_dtype)
              for _ in range(2))
    slots = np.arange(L)
    if layout == "ring":
        cache_pos = np.where(slots < 10, slots + L, slots)
        pos = np.full((B,), L + 9)
    else:
        n_valid = L if layout == "full" else L // 3
        cache_pos = np.where(slots < n_valid, slots, -1)
        pos = np.full((B,), n_valid - 1)
    cache_pos = np.broadcast_to(cache_pos, (B, L)).astype(np.int32).copy()
    if layout == "empty-row":
        cache_pos[1] = -1
    cp = torch.from_numpy(cache_pos)
    pos = torch.from_numpy(pos.astype(np.int32))
    kw = dict(window=window, softcap=softcap)
    cuda_lib.reset_launches()
    got = da.decode_attention(q.to(dev), kc.to(dev), vc.to(dev), cp.to(dev),
                              pos.to(dev), **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["decode_attention"] == 1
    assert got.dtype == q_dtype and torch.isfinite(got).all()
    want = da.decode_attention_plain(q, kc, vc, cp, pos, **kw)
    _attn_close(got, want, q_dtype, "cpu")
    if layout == "empty-row":
        assert torch.equal(got[1].cpu(), torch.zeros_like(want[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,Hkv,G,D,causal,window", [
    (130, 130, 1, 10, 256, True, 64),      # recurrentgemma local, D=256
    (200, 200, 1, 10, 256, False, None),
    (300, 300, 2, 1, 64, False, None),     # whisper encoder: ragged tiles
    (1, 300, 2, 1, 64, False, None),       # cross-attention of a decode step
    (40, 300, 2, 1, 64, False, None),      # teacher-forced cross-attention
])
def test_k4_wide_heads_and_encdec_shapes(dev, Sq, Skv, Hkv, G, D, causal,
                                         window, dtype):
    rng = np.random.default_rng(Sq + Skv + D)
    B = 2
    q = torch.from_numpy(rng.standard_normal((B, Sq, Hkv * G, D))
                         .astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, Skv, Hkv, D))
                             .astype(np.float32)).to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window)
    assert fa.tc_route(q, k) == (dtype == torch.bfloat16 and D in (64, 256))
    cuda_lib.reset_launches()
    got = fa.flash_attention(q.to(dev), k.to(dev), v.to(dev), **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    _attn_close(got, fa.flash_attention_plain(q, k, v, **kw), dtype, "cpu")


@pytest.mark.parametrize("Hkv,G", [(1, 10), (2, 2)])
@pytest.mark.parametrize("Sq,Skv,causal,window,softcap,q_offset", [
    (130, 130, True, None, 0.0, 0),        # ragged against 128 and 64
    (300, 300, False, None, 0.0, 0),
    (300, 300, True, 64, 0.0, 0),          # a window of one key tile
    (130, 300, False, None, 30.0, 0),      # softcap, Sq != Skv
    (300, 300, True, None, 30.0, 0),
    (40, 104, True, 24, 0.0, 64),          # q_offset after a prefix
    (200, 330, True, 100, 0.0, 130),
    (1, 300, False, None, 0.0, 0),         # one query against the cache
    (1, 300, True, None, 0.0, 299),
    (64, 8, True, 4, 0.0, 0),              # rows with no valid key
])
def test_k4_tensor_core_route_at_head_dim_256(dev, Sq, Skv, Hkv, G, causal,
                                              window, softcap, q_offset):
    """bf16 at head dim 256 (recurrentgemma's local layers) takes the
    tensor-core kernel's 128-query x 64-key instance: one launch, within
    one bf16 step of the plain version."""
    rng = np.random.default_rng(Sq + Skv + G)
    B, D, dtype = 2, 256, torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((B, Sq, Hkv * G, D))
                         .astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, Skv, Hkv, D))
                             .astype(np.float32)).to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    assert fa.tc_route(q, k)
    cuda_lib.reset_launches()
    got = fa.flash_attention(q.to(dev), k.to(dev), v.to(dev), **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    want = fa.flash_attention_plain(q, k, v, **kw)
    _attn_close(got, want, dtype, "cpu")
    if Skv == 8:                           # queries 11.. see no key: 0
        assert torch.equal(got[:, 11:].cpu(), torch.zeros_like(want[:, 11:]))


def _k4_split_inputs(seed, Sq, Skv, Hkv, G, D):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((1, Sq, Hkv * G, D))
                         .astype(np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((1, Skv, Hkv, D))
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("G", [1, 10])
@pytest.mark.parametrize("Skv", [300, 1500])
@pytest.mark.parametrize("Sq", [1, 16, 40])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_k4_split_over_keys_matches_plain(dev, D, Sq, Skv, G):
    """Few queries against many keys (Whisper's cross-attention at B=1)
    take the tensor-core route split over the keys: one launch counted,
    within ATTN_TOL of the plain version, which runs the same split."""
    Hkv = 2 if G == 1 else 1
    q, k, v = _k4_split_inputs(D + Sq + Skv + G, Sq, Skv, Hkv, G, D)
    assert fa.tc_route(q, k)
    assert fa.split_plan(q.dtype, 1, Sq, Hkv * G, Skv, D) > 1
    cuda_lib.reset_launches()
    got = fa.flash_attention(q.to(dev), k.to(dev), v.to(dev), causal=False)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["flash_attention"] == 1
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    want = fa.flash_attention_plain(q.to(dev), k.to(dev), v.to(dev),
                                    causal=False)
    _attn_close(got, want, torch.bfloat16, "card")


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("Sq,Skv,Hkv,G,causal,window,softcap,q_offset", [
    (16, 1500, 1, 10, True, None, 0.0, 200),    # ranges past 215 dead
    (40, 1500, 2, 1, True, 100, 0.0, 1460),     # only the last range live
    (16, 1500, 2, 1, False, None, 30.0, 0),     # softcap
    (40, 300, 1, 10, True, 8, 0.0, 280),        # rows 27.. see no key
    (1, 300, 2, 1, True, 8, 0.0, 400),          # the one row sees none
    (1, 1500, 1, 10, True, None, 0.0, 1499),    # a decode step's query
])
def test_k4_split_masks_dead_ranges_and_empty_rows(
        dev, D, Sq, Skv, Hkv, G, causal, window, softcap, q_offset):
    """Under the split: causal with ``q_offset`` (dead trailing ranges), a
    window (one live range), the softcap, and rows with no valid key in
    any range, which are exactly 0."""
    q, k, v = _k4_split_inputs(D + Sq + Skv + q_offset, Sq, Skv, Hkv, G, D)
    assert fa.split_plan(q.dtype, 1, Sq, Hkv * G, Skv, D) > 1
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    cuda_lib.reset_launches()
    got = fa.flash_attention(q.to(dev), k.to(dev), v.to(dev), **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["flash_attention"] == 1
    assert torch.isfinite(got).all()
    want = fa.flash_attention_plain(q.to(dev), k.to(dev), v.to(dev), **kw)
    _attn_close(got, want, torch.bfloat16, "card")
    qpos = q_offset + np.arange(Sq)
    lo = qpos - window if window is not None else np.full(Sq, -1)
    empty = torch.from_numpy(~(np.minimum(qpos, Skv - 1) > lo))
    assert torch.equal(got[:, empty].cpu(),
                       torch.zeros_like(got[:, empty].cpu()))


@pytest.mark.parametrize("Sq,D", [(1, 64), (16, 64), (1, 256)])
def test_k4_split_is_deterministic(dev, Sq, D):
    """The combine merges the ranges in split order: two launches at a split
    shape give the same bits."""
    G = 10 if D == 256 else 1
    Hkv = 1 if D == 256 else 16
    q, k, v = (x.to(dev) for x in _k4_split_inputs(Sq, Sq, 1500, Hkv, G, D))
    assert fa.split_plan(q.dtype, 1, Sq, Hkv * G, 1500, D) > 1
    cuda_lib.reset_launches()
    first = fa.flash_attention(q, k, v, causal=False)
    second = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["flash_attention"] == 2
    assert torch.equal(first, second)


@pytest.mark.parametrize("q_dtype,c_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("L,Hkv,G,D,window,layout", [
    (128, 1, 10, 256, None, "full"),       # recurrentgemma, engine's cache
    (700, 1, 10, 256, 300, "ring"),        # split, wrapped ring + window
    (1000, 1, 10, 256, None, "padded"),    # split, empty splits
    (64, 2, 10, 128, None, "full"),        # G past 8 at D <= 128
    (48, 1, 3, 200, 16, "ring"),           # D=200, no power of two
])
def test_k5_wide_heads_match_plain(dev, L, Hkv, G, D, window, layout,
                                   q_dtype, c_dtype):
    rng = np.random.default_rng(L + G + D)
    B = 3
    q = torch.from_numpy(rng.standard_normal((B, 1, Hkv * G, D))
                         .astype(np.float32)).to(q_dtype)
    kc, vc = (torch.from_numpy(rng.standard_normal((B, L, Hkv, D))
                               .astype(np.float32)).to(c_dtype)
              for _ in range(2))
    slots = np.arange(L)
    if layout == "ring":
        cache_pos, pos = np.where(slots < 10, slots + L, slots), L + 9
    else:
        n_valid = L if layout == "full" else L // 3
        cache_pos, pos = np.where(slots < n_valid, slots, -1), n_valid - 1
    cp = torch.from_numpy(np.broadcast_to(cache_pos, (B, L))
                          .astype(np.int32).copy())
    pos = torch.full((B,), pos, dtype=torch.int32)
    kw = dict(window=window)
    cuda_lib.reset_launches()
    got = da.decode_attention(q.to(dev), kc.to(dev), vc.to(dev), cp.to(dev),
                              pos.to(dev), **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["decode_attention"] == 1
    assert got.dtype == q_dtype and torch.isfinite(got).all()
    _attn_close(got, da.decode_attention_plain(q, kc, vc, cp, pos, **kw),
                q_dtype, "cpu")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-2.7b",
                                  "recurrentgemma-2b", "whisper-medium"])
def test_reduced_zoo_on_card_matches_cpu(dev, arch):
    """One MoE, SSM, hybrid and enc-dec model, reduced (f32): the card's
    forward and sequential decode against the CPU's within 1e-4, with K4
    and K5 launched once per attention layer and call."""
    cfg = reduce_config(get_arch(arch))
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    gparams = tf.params_to(params, dev)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12))
                            .astype(np.int32))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_frames, cfg.d_model)).astype(np.float32))
    n_attn = sum(k in ("global", "local") for k in cfg.layer_kinds)
    cuda_lib.reset_launches()
    got = api.prefill(gparams, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    want = api.prefill(params, batch)
    k4_forward = (cfg.encoder_layers + 2 * cfg.num_layers
                  if cfg.family == "encdec" else n_attn)
    assert cuda_lib.LAUNCHES["flash_attention"] == k4_forward
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
    cuda_lib.reset_launches()
    seqs = []
    for p, device in ((gparams, dev), (params, "cpu")):
        cache = api.init_cache(2, 12, torch.float32, device)
        if cfg.family == "encdec":
            encdec.fill_cross_cache(p, cache, batch["frames"].to(device),
                                    cfg)
        out = []
        for t in range(12):
            logits, cache = api.decode_step(p, cache,
                                            toks[:, t:t + 1].to(device))
            out.append(logits[:, 0].cpu())
        seqs.append(torch.stack(out, 1))
        if device == dev:
            counts = dict(cuda_lib.LAUNCHES)
    layers = cfg.num_layers if cfg.family == "encdec" else n_attn
    assert counts["decode_attention"] == 12 * layers
    assert counts["flash_attention"] == (
        cfg.encoder_layers + 12 * cfg.num_layers
        if cfg.family == "encdec" else 0)
    rel = float((seqs[0] - seqs[1]).abs().max() / seqs[1].abs().max())
    assert rel < 1e-4, rel


def _lm_cfg():
    return reduce_config(get_arch("llama3.2-3b"))


def test_reduced_lm_on_card_matches_cpu(dev):
    cfg = _lm_cfg()
    params = tf.init_lm(cfg, torch.Generator().manual_seed(0))
    gparams = tf.params_to(params, dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    cuda_lib.reset_launches()
    got, _ = tf.forward_lm(gparams, toks.to(dev), cfg)
    assert cuda_lib.LAUNCHES["flash_attention"] == cfg.num_layers
    want, _ = tf.forward_lm(params, toks, cfg)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
    cache = tf.init_cache_lm(cfg, 2, 24, torch.float32, dev)
    _, seq = tf.prefill_into_cache(gparams, cache, toks.to(dev), cfg)
    assert cuda_lib.LAUNCHES["decode_attention"] == 24 * cfg.num_layers
    rel = float((seq.cpu() - want).abs().max() / want.abs().max())
    assert rel < 2e-4, rel

    def serve(p):
        eng = serve_engine.ServeEngine(build_model(cfg), p, slots=2,
                                       max_len=16)
        for r in range(3):
            eng.submit(serve_engine.Request(r, np.arange(5) + r, 6))
        return {r: c.tokens for r, c in eng.run().items()}

    assert serve(gparams) == serve(params)


def test_k4_k5_refuse_inputs_that_require_grad(dev):
    q = torch.randn((1, 64, 4, 64), device=dev, requires_grad=True)
    k = torch.randn((1, 64, 2, 64), device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention_cuda(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, k, k)
    cache_pos = torch.arange(64, dtype=torch.int32, device=dev)[None]
    pos = torch.full((1,), 63, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        da.decode_attention_cuda(q[:, :1], k, k, cache_pos, pos)
    cuda_lib.reset_launches()
    with torch.no_grad():                 # the same inputs without grad run
        fa.flash_attention_cuda(q, k, k)
        da.decode_attention_cuda(q[:, :1], k, k, cache_pos, pos)
    assert cuda_lib.LAUNCHES["flash_attention"] == 1
    assert cuda_lib.LAUNCHES["decode_attention"] == 1


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-medium"])
def test_reduced_lm_train_step_on_card_matches_cpu(dev, arch):
    """Three adamw steps of the reduced model (f32, remat) on the card and
    on the CPU from the same params and batches: losses and grad norms
    within 1e-5, no kernel launched; the eval step launches K4 once per
    attention call."""
    from repro_torch.data.synthetic import lm_batch
    cfg = reduce_config(get_arch(arch))
    api = build_model(cfg)
    opt = optim.adamw(3e-3)
    params = api.init(torch.Generator().manual_seed(0))
    states = {d: {"params": tf.params_to(params, d),
                  "opt": opt.init(tf.params_to(params, d)), "step": 0}
              for d in ("cpu", dev)}
    step = trainer.make_train_step(api, opt, remat=True)
    cuda_lib.reset_launches()
    for i in range(3):
        b = lm_batch(0, np.arange(2 * i, 2 * i + 2), 16, cfg.vocab_size)
        if cfg.family == "encdec":
            b["frames"] = np.random.default_rng(i).standard_normal(
                (2, cfg.n_frames, cfg.d_model)).astype(np.float32)
        metrics = {}
        for d in ("cpu", dev):
            states[d], metrics[d] = step(states[d], launch.to_device(b, d))
        for key in ("loss", "grad_norm"):
            got, want = float(metrics[dev][key]), float(metrics["cpu"][key])
            assert abs(got - want) <= 1e-5 * abs(want), (i, key, got, want)
    assert sum(cuda_lib.LAUNCHES.values()) == 0
    ev = trainer.make_eval_step(api)(states[dev], launch.to_device(b, dev))
    n_k4 = (cfg.encoder_layers + 2 * cfg.num_layers
            if cfg.family == "encdec" else cfg.num_layers)
    assert cuda_lib.LAUNCHES["flash_attention"] == n_k4
    want = trainer.make_eval_step(api)(states["cpu"], launch.to_device(b,
                                                                       "cpu"))
    assert abs(float(ev) - float(want)) <= 1e-5 * abs(float(want))


def _lifecycle_example():
    path = (Path(__file__).resolve().parent.parent / "examples"
            / "elastic_dlrm_train_torch.py")
    spec = importlib.util.spec_from_file_location("elastic_dlrm_train_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_lifecycle_on_card_launches_k1_and_decides_as_on_cpu(dev, tmp_path):
    ex = _lifecycle_example()
    cfg = tcfg.DLRMConfig(
        name="wide_deep_small", kind="wide_deep",
        table_rows=tuple(200 * (1 + i % 5) for i in range(26)),
        embed_dim=16, mlp_dims=(32, 16), batch_size=32)
    cuda_lib.reset_launches()
    card = ex.run_lifecycle(cfg, steps=151, device="cuda",
                            ckpt_dir=str(tmp_path / "card"), log=lambda s: None)
    launches = dict(cuda_lib.LAUNCHES)
    cpu = ex.run_lifecycle(cfg, steps=151, device="cpu",
                           ckpt_dir=str(tmp_path / "cpu"), log=lambda s: None)
    assert launches["fused_embedding_bag"] == 2 * len(card.losses) + 2
    assert card.coverage == cpu.coverage and card.coverage[0] is True
    assert card.coverage[2] == 0
    assert len(card.losses) == len(cpu.losses) >= 151
    for got, want in ((card.stage1_plan, cpu.stage1_plan),
                      (card.master.resources, cpu.master.resources)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert {k: dataclasses.asdict(v) for k, v in card.stage2_plans.items()} \
        == {k: dataclasses.asdict(v) for k, v in cpu.stage2_plans.items()}
    assert card.stage3_scaled == cpu.stage3_scaled
    assert len(card.brain.config_db) == 1
    assert np.all(np.isfinite(card.losses)) and 0.5 < card.auc <= 1.0
    assert card.peak_mem_bytes > 0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("D,n,route", [(16, 4, "vector"), (1, 4, "wide"),
                                       (16, 3, "generic"), (8, 4, "generic")])
def test_single_table_bag_launches_k1(dev, D, n, route, combiner, weighted):
    """``ops.embedding_bag`` on the card: one K1 launch on ``route``, bit
    for bit with K1's plain version on the CPU; a strided view of the ids
    takes the same route through the wrapper's int32 copy."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(D * 10 + n)
    R, B = 1000, 37
    table = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, R, (B, n + 1)))[:, :n]   # int64
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (B, n)).astype(np.float32)) \
        if weighted else None
    plan = tpol.EmbeddingPlan(combiner=combiner)
    want = fe.embedding_bag_plain(table, idx[:, None, :].to(torch.int32),
                                  None if w is None else w[:, None, :],
                                  None, combiner)[:, 0]
    td, id_, wd = table.to(dev), idx.to(dev), None if w is None else w.to(dev)
    cuda_lib.reset_launches()
    got = ops.embedding_bag(td, id_, wd, plan=plan)
    torch.cuda.synchronize()
    assert dict(cuda_lib.LAUNCHES) == {**{k: 0 for k in cuda_lib.LAUNCHES},
                                       "fused_embedding_bag": 1}
    assert torch.equal(got.cpu(), want)
    enc, _ = fe.kernel_inputs(td, id_[:, None, :], plan)
    assert fe.bag_route(D, n, td, enc, got,
                        *([] if wd is None else [wd])) == route


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-2.7b"])
def test_serve_batched_example_on_card_matches_cpu(dev, arch):
    """``examples/serve_batched_torch.py``'s ``serve`` on the card gives the
    CPU's tokens on the same weights; llama launches K5 and nothing else,
    mamba2 nothing."""
    path = (Path(__file__).resolve().parent.parent / "examples"
            / "serve_batched_torch.py")
    spec = importlib.util.spec_from_file_location("serve_batched_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    cfg = reduce_config(get_arch(arch))
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    reqs = ex.make_requests(cfg, 6)
    cpu, _ = ex.serve(cfg, params, reqs, 3, "cpu")
    cuda_lib.reset_launches()
    card, _ = ex.serve(cfg, tf.params_to(params, dev), reqs, 3, dev)
    counts = dict(cuda_lib.LAUNCHES)
    assert {r: c.tokens for r, c in card.items()} == \
        {r: c.tokens for r, c in cpu.items()}
    if arch == "llama3.2-3b":
        assert counts["decode_attention"] > 0
        assert sum(counts.values()) == counts["decode_attention"]
    else:
        assert sum(counts.values()) == 0


# ---------------------------------------------------------------------------
# the dedupe's segment sum
# ---------------------------------------------------------------------------
# Criteo Kaggle's 26 vocabularies: the Wide&Deep benchmark cell's tables
KAGGLE_ROWS = tuple(json.loads(
    (Path(__file__).resolve().parent.parent / "portbench" / "configs"
     / "wide_deep.json").read_text())["table_rows"])


def _zipf_lookups(dev, B, rows, H, alpha=1.05, seed=0):
    """(B, T, H) int32 flat ids of bounded-zipf lookups, made on the card
    by the benchmark's traffic generator (``zipf_indices``' formula)."""
    u = torch.rand((B, len(rows), H), dtype=torch.float64, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(seed))
    local = traffic.zipf_from_uniform(
        u, torch.tensor(rows, device=dev)[None, :, None], alpha)
    offs = torch.tensor(fe.table_offsets(rows), device=dev)[None, :, None]
    return (local + offs).to(torch.int32)


def _parent_dedupe(store_idx, g_rows, num_rows):
    """The dedupe before the segment sum: the sorted gather, then
    ``torch.segment_reduce``."""
    n = store_idx.shape[0]
    sorted_rows, order = torch.sort(store_idx, stable=True)
    uniq, counts = torch.unique_consecutive(sorted_rows, return_counts=True)
    summed = torch.segment_reduce(g_rows[order], "sum", lengths=counts,
                                  axis=0)
    rows = store_idx.new_full((n,), num_rows)
    rows[:uniq.shape[0]] = uniq
    vals = g_rows.new_zeros((n, g_rows.shape[1]))
    vals[:uniq.shape[0]] = summed
    return rows, vals, counts


def _segment_sum_on_card(store_idx, src, H, num_rows, route):
    """One dedupe through the segment sum, held bit for bit to the parent's
    on the same card; the counts of the segments, for the caller."""
    per_lookup = src if H == 1 else src.repeat_interleave(H, 0)
    want_rows, want_vals, counts = _parent_dedupe(store_idx, per_lookup,
                                                  num_rows)
    cuda_lib.reset_launches()
    if route == "bags":
        rows, vals = fe.dedupe_bags(store_idx, src, H, num_rows)
    else:
        rows, vals = fe.dedupe_rows(store_idx, src, num_rows)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[f"segment_sum_{route}"] == 1
    assert sum(cuda_lib.LAUNCHES.values()) == 1
    assert torch.equal(rows, want_rows)
    assert torch.equal(vals, want_vals)
    n_uniq = counts.shape[0]
    assert (rows[n_uniq:] == num_rows).all() and not vals[n_uniq:].any()
    return counts


@pytest.mark.parametrize("route", ["bags", "rows"])
@pytest.mark.parametrize("D", [16, 1])
def test_segment_sum_at_wide_deep_shapes_matches_segment_reduce(dev, D,
                                                                 route):
    """Full-width Wide&Deep: B=65,536, Criteo Kaggle's tables, 4 zipf-1.05
    lookups each (6.8 M lookups, a ~146 k-entry segment on the 3-row
    table, single-lookup rows), the store's last row looked up last."""
    B, H = 65536, 4
    R = sum(KAGGLE_ROWS)
    store_idx = _zipf_lookups(dev, B, KAGGLE_ROWS, H).reshape(-1)
    store_idx[-1] = R - 1                              # the boundary row
    gen = torch.Generator(device=dev).manual_seed(1)
    n_src = store_idx.shape[0] // (H if route == "bags" else 1)
    src = torch.randn((n_src, D), generator=gen, device=dev)
    counts = _segment_sum_on_card(store_idx, src, H if route == "bags"
                                  else 1, R, route)
    assert int(counts.max()) > 140000 and int(counts.min()) == 1


@pytest.mark.parametrize("route", ["bags", "rows"])
@pytest.mark.parametrize("D,aligned", [(16, True), (16, False), (1, True),
                                       (3, True), (4, True), (40, True),
                                       (33, True)])
def test_segment_sum_at_every_width_and_segment_length(dev, D, aligned,
                                                        route):
    """Segments of 1 entry, around the first pass's limit (64), the ring's
    tiles (1,024 at D=16, 2,048 entries at most) and the long list's front
    (16,384), in shuffled order; widths on the float4 pieces (D % 4 == 0,
    aligned) and on scalar ones (odd widths, a src one float off 16 bytes),
    with a register sum (D <= 32) and a sum through ``vals`` (D > 32)."""
    H = 4 if route == "bags" else 1
    lengths = [1] * 500 + [2, 7, 63, 64, 65, 256, 1023, 1024, 1025, 2047,
                           2048, 2049, 5000, 16383, 16384, 40000]
    n = sum(lengths)
    n += (-n) % 4                                      # whole bags
    lengths[0] += n - sum(lengths)
    R = len(lengths) + 3                               # rows never looked up
    gen = torch.Generator(device=dev).manual_seed(D)
    ids = torch.repeat_interleave(
        torch.randperm(R, generator=gen, device=dev)[:len(lengths)],
        torch.tensor(lengths, device=dev))
    store_idx = ids[torch.randperm(n, generator=gen, device=dev)].to(
        torch.int32)
    n_src = n // H
    buf = torch.randn((n_src * D + 1,), generator=gen, device=dev)
    buf[:D] = -0.0                                     # signed zeros
    src = (buf[:-1] if aligned else buf[1:]).view(n_src, D)
    assert (src.data_ptr() % 16 == 0) == aligned
    counts = _segment_sum_on_card(store_idx, src, H, R, route)
    assert sorted(counts.tolist()) == sorted(lengths)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_sparse_backward_on_card_routes_and_keeps_the_bits(dev, combiner,
                                                           weighted, padded):
    """``sparse_row_grads`` and the autograd backward on the card: the bags
    route for unweighted sum and mean, the rows route otherwise, with the
    parent's rows, values and dense gradient bit for bit."""
    rows_t = (3, 40, 96, 24)
    offsets = fe.table_offsets(rows_t)
    R0 = sum(rows_t)
    layout = tpol.padded_layout_for_ranges(
        [(0, 50), (50, 120), (120, 120), (120, R0)]) if padded else None
    plan = tpol.EmbeddingPlan(offsets=offsets, combiner=combiner,
                              layout=layout)
    R = layout.padded_rows if padded else R0
    B, T, H, D = 513, len(rows_t), 4, 16
    gen = torch.Generator(device=dev).manual_seed(5)
    pool = torch.randn((R, D), generator=gen, device=dev)
    idx = _zipf_lookups(dev, B, rows_t, H, seed=6) - torch.tensor(
        offsets, device=dev, dtype=torch.int32)[None, :, None]
    idx[:, :, -1] = idx[:, :, 0]
    g = torch.randn((B, T, D), generator=gen, device=dev)
    w = torch.rand((B, T, H), generator=gen, device=dev) + 0.1 \
        if weighted else None
    cuda_lib.reset_launches()
    rows, vals, dw = fe.sparse_row_grads(pool, idx, g, w, plan=plan)
    route = "rows" if weighted or combiner == "max" else "bags"
    assert cuda_lib.LAUNCHES[f"segment_sum_{route}"] == 1
    assert sum(cuda_lib.LAUNCHES.values()) == 1
    flat = fe._flat_lookups(idx, plan.offsets)
    store_idx = flat if layout is None else fe.translate_rows(flat, layout)
    if route == "rows":
        g_rows, p_dw = fe._row_cotangents(pool, store_idx, w, g,
                                          combiner=combiner, B=B, T=T, H=H)
        assert (dw is None) == (p_dw is None)
        if weighted:
            assert torch.equal(dw, p_dw.reshape(dw.shape))
    else:
        g_rows = g[:, :, None, :].expand(B, T, H, D)
        g_rows = g_rows / H if combiner == "mean" else g_rows
        assert dw is None
    p_rows, p_vals, _ = _parent_dedupe(store_idx,
                                       g_rows.reshape(B * T * H, D), R)
    assert torch.equal(rows, p_rows) and torch.equal(vals, p_vals)
    tp = pool.clone().requires_grad_()
    out = fe.fused_embedding_bag(tp, idx, w, plan=plan)
    (out * g).sum().backward()
    assert torch.equal(fe.scatter_rows(rows, vals, R), tp.grad)
