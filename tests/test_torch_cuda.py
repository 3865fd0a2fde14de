"""The CUDA kernels K1–K3 against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with one, run ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

K1 equals its plain version bit for bit, on the card and on the CPU. K2
and K3 are held to their plain versions within the ULP bounds of the
reference's fused-update tests (params 64, moments 4), on the card and on
the CPU: the kernels spell their arithmetic with the uncontracted ``_rn``
intrinsics in the plain versions' order, but PyTorch's CPU ``sqrt``
(vectorised) is not always correctly rounded, so the CPU result may sit an
ULP away. Rows the update does not touch stay bit-identical. A reduced
train step on the card matches the CPU within 2e-5 and is deterministic.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_ulp_close  # noqa: E402  (sets torch threads)
from repro_torch.configs import dlrm_models as tcfg  # noqa: E402
from repro_torch.configs.registry import get_dlrm  # noqa: E402
from repro_torch.data.synthetic import criteo_batch  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import fused_embedding as fe  # noqa: E402
from repro_torch.kernels import fused_update as fu  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402
from repro_torch.train import optim, trainer  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cuda_lib.load()
    return launch.resolve_device("cuda")


def _encoded(rng, B, T, H, R, K):
    enc = rng.integers(0, R, (B, T, H)).astype(np.int32)
    if K:
        hot = rng.random((B, T, H)) < 0.4
        enc[hot] = -(rng.integers(0, K, hot.sum()) + 1)
    return enc


@pytest.mark.parametrize("D", [16, 1])
@pytest.mark.parametrize("K", [0, 37])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_k1_matches_plain(dev, combiner, weighted, K, D):
    rng = np.random.default_rng(0)
    B, T, H, R = 33, 5, 4, 1000
    pool = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32))
    cache = pool[:K].clone() if K else None
    enc = torch.from_numpy(_encoded(rng, B, T, H, R, K))
    w = torch.from_numpy(rng.uniform(0.1, 2, (B, T, H)).astype(np.float32)) \
        if weighted else None
    want = fe.embedding_bag_plain(pool, enc, w, cache, combiner)
    cuda_lib.reset_launches()
    got = fe.embedding_bag_forward(
        pool.to(dev), enc.to(dev), None if w is None else w.to(dev),
        None if cache is None else cache.to(dev), combiner)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["fused_embedding_bag"] == 1
    assert torch.equal(got.cpu(), want)
    plain_dev = fe.embedding_bag_plain(
        pool.to(dev), enc.to(dev), None if w is None else w.to(dev),
        None if cache is None else cache.to(dev), combiner)
    assert torch.equal(got, plain_dev)


def _rows(rng, R, n, live):
    rows = np.full((n,), R, np.int32)
    rows[:live] = rng.choice(R, live, replace=False)
    return rows


PARAM_ULP, MOMENT_ULP = 64, 4


@pytest.mark.parametrize("state", ["fresh", "carried"])
@pytest.mark.parametrize("D", [16, 1])
def test_k2_k3_match_plain(dev, D, state):
    rng = np.random.default_rng(1)
    R, n = 5000, 900
    rows = torch.from_numpy(_rows(rng, R, n, 700))
    vals = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    p0 = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(0, 1, (R, D)).astype(np.float32))
    a0 = u if state == "carried" else torch.zeros_like(u)
    m0 = u - 0.5 if state == "carried" else torch.zeros_like(u)
    wd = 0.01 if state == "carried" else 0.0
    untouched = torch.ones(R, dtype=torch.bool)
    untouched[rows[rows < R].long()] = False
    bounds = (PARAM_ULP, MOMENT_ULP, MOMENT_ULP)

    def compare(kernel_out, plain_outs, start, tag):
        for i, (got, bound, s0) in enumerate(zip(kernel_out, bounds, start)):
            got = got.cpu()
            for where, outs in plain_outs:
                assert_ulp_close(got.numpy(), outs[i].cpu().numpy(), bound,
                                 f"{tag} output {i} vs plain on {where}")
            assert torch.equal(got[untouched], s0[untouched]), (tag, i)

    # K2 (adagrad)
    cuda_lib.reset_launches()
    kd = (p0.to(dev, copy=True), a0.to(dev, copy=True))
    fu.adagrad_row_update(*kd, rows.to(dev), vals.to(dev), lr=0.05)
    assert cuda_lib.LAUNCHES["adagrad_row_update"] == 1
    pd, ad = p0.to(dev, copy=True), a0.to(dev, copy=True)
    fu.adagrad_rows_plain(pd, ad, rows.to(dev), vals.to(dev), lr=0.05,
                          eps=1e-10)
    pc, ac = p0.clone(), a0.clone()
    fu.adagrad_row_update(pc, ac, rows, vals, lr=0.05)
    torch.cuda.synchronize()
    compare(kd, [("card", (pd, ad)), ("cpu", (pc, ac))], (p0, a0), "K2")

    # K3 (lazy adam)
    kw = dict(lr=0.01, b1=0.9, b2=0.999, eps=1e-8, wd=wd)
    kd = (p0.to(dev, copy=True), m0.to(dev, copy=True), a0.to(dev, copy=True))
    fu.adam_row_update(*kd, rows.to(dev), vals.to(dev), lr=0.01, count=3,
                       weight_decay=wd)
    assert cuda_lib.LAUNCHES["adam_row_update"] == 1
    pd = (p0.to(dev, copy=True), m0.to(dev, copy=True), a0.to(dev, copy=True))
    fu.adam_rows_plain(*pd, rows.to(dev), vals.to(dev),
                       fu.adam_bias(3, 0.9, 0.999, dev), **kw)
    pc = (p0.clone(), m0.clone(), a0.clone())
    fu.adam_row_update(*pc, rows, vals, lr=0.01, count=3, weight_decay=wd)
    torch.cuda.synchronize()
    compare(kd, [("card", pd), ("cpu", pc)], (p0, m0, a0), "K3")


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
    cpu, _ = run("cpu")
    np.testing.assert_allclose(gpu, cpu, rtol=0, atol=2e-5)
    gpu2, s2 = run(dev)
    assert gpu2 == gpu
    for k in ("tables", "wide"):
        assert torch.equal(s1["params"][k], s2["params"][k])
