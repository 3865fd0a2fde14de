"""The optimizer layer's multi-tensor kernels on the card: the dense
adagrad update and the squared global norm (``csrc/multi_tensor.cu``).

Marked ``cuda``: without a CUDA device every test here skips (the kernels
have no CPU mode). On a machine with one, run
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_multi_tensor_cuda.py``.

The update equals the op-by-op path on the card (``adagrad_leaf_plain``,
the expressions the port ran before) bit for bit, in params and
accumulator, clip off and on: on DLRM-DCNv2's and Wide&Deep's full-width
dense trees with gradients of a small batch, and on odd trees (a
1-element leaf, sizes no multiple of 4, a leaf of many work items, more
leaves than one launch takes, a misaligned view, bf16 leaves). The norm is
within 1e-6 of a float64 sum over dense leaves and the dedupe's padded
sparse leaves (an all-padding one, bf16 leaves), never reads the padding
past its first entry, and two calls give the same bits. The state passed
in is not written, and each counter counts one call a step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401  (one CPU thread)
from repro_torch.configs import dlrm_models as tcfg  # noqa: E402
from repro_torch.configs.registry import get_dlrm  # noqa: E402
from repro_torch.data.synthetic import criteo_batch  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import fused_embedding as fe  # noqa: E402
from repro_torch.kernels import multi_tensor as mt  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import dlrm as dlrm_mod  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402
from repro_torch.train import optim, trainer  # noqa: E402

pytestmark = pytest.mark.cuda

LR, EPS = 3e-3, 1e-10


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cuda_lib.load()
    return launch.resolve_device("cuda")


def _full(kind):
    return tcfg.DLRM_DCNV2 if kind == "dlrm_dcnv2" else get_dlrm(kind)


def _dense_tree(kind, dev, B=256):
    """(grads, params) of the config's full-width dense tree, the
    gradients of one batch of B (tables cut to 97 rows: the dense widths
    do not depend on them)."""
    cfg = dataclasses.replace(_full(kind), table_rows=(97,) * 26,
                              batch_size=B)
    params = dlrm_mod.init_dlrm(cfg, torch.Generator(device=dev)
                                .manual_seed(0))
    plan = cfg.embedding_plan()
    batch = launch.to_device(criteo_batch(cfg, 7, np.arange(B)), dev)
    stores = dlrm_mod.sparse_param_keys(cfg)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()
              if k not in stores}
    with torch.no_grad():
        embs = dlrm_mod.dlrm_embeddings(params, batch, cfg, plan)
    loss = dlrm_mod.dlrm_loss_from_embeddings(leaves, batch, embs, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return list(grads), [v.detach() for v in leaves.values()]


def _accs(params, carried, seed=1):
    if not carried:
        return [torch.zeros_like(p, dtype=torch.float32) for p in params]
    gen = torch.Generator(device=params[0].device).manual_seed(seed)
    return [torch.rand(p.shape, generator=gen, device=p.device)
            for p in params]


def _scale(grads, clip):
    return optim._clip_scale(optim.global_norm(grads), 1e-3) if clip else None


def _check_bits(grads, accs, params, scale, apply=True):
    """The kernel against the op-by-op path on the card, bit for bit; the
    inputs unwritten; one launch."""
    before = [x.clone() for x in (*grads, *accs, *params)]
    cuda_lib.reset_launches()
    outs, new_accs = mt.dense_adagrad(grads, accs, params, lr=LR, eps=EPS,
                                      scale=scale, apply=apply)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["dense_adagrad"] == 1
    assert cuda_lib.LEAF_COUNTS == {"dense_leaves": len(params),
                                    "dense_leaves_fused": len(params)}
    for g, a, p, o, na in zip(grads, accs, params, outs, new_accs):
        want_o, want_a = mt.adagrad_leaf_plain(g, a, p, lr=LR, eps=EPS,
                                               scale=scale, apply=apply)
        assert o.dtype == want_o.dtype and o.shape == want_o.shape
        assert torch.equal(o, want_o)
        assert torch.equal(na, want_a)
    for x, y in zip(before, (*grads, *accs, *params)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("kind", ["dlrm_dcnv2", "wide_deep"])
def test_dense_adagrad_bit_for_bit_on_the_dense_trees(dev, kind, carried,
                                                      clip):
    grads, params = _dense_tree(kind, dev)
    _check_bits(grads, _accs(params, carried), params, _scale(grads, clip))


def _odd_tree(dev, dtype=torch.float32, n_leaves=None):
    """Sizes 1, 3, 13, 4097 (no multiple of 4), 2048 x 5 + 7 (several
    work items) and a view that starts one element in (misaligned)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    sizes = [1, 3, 13, 4097, 2048 * 5 + 7, 64]
    if n_leaves is not None:
        sizes = [(i * 37) % 301 + 1 for i in range(n_leaves)]

    def draw():
        out = [torch.randn(n, generator=gen, device=dev).to(dtype)
               for n in sizes]
        base = torch.randn(1001, generator=gen, device=dev).to(dtype)
        return out + [base[1:]]

    return draw(), draw()


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("case", ["odd", "many", "bf16", "bf16_grads",
                                  "update"])
def test_dense_adagrad_bit_for_bit_on_odd_trees(dev, case, clip):
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    grads, params = _odd_tree(dev, dtype, 150 if case == "many" else None)
    if case == "bf16_grads":
        grads = [g.to(torch.bfloat16) for g in grads]
    accs = _accs(params, True)
    assert params[-1].data_ptr() % 16 != 0          # the misaligned view
    _check_bits(grads, accs, params, _scale(grads, clip),
                apply=case != "update")


def test_dense_adagrad_refuses_other_types(dev):
    p = [torch.zeros(5, device=dev, dtype=torch.float16)]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mt.dense_adagrad(p, [torch.zeros(5, device=dev)], p, lr=LR, eps=EPS)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mt.grad_sq_norm([torch.zeros(5, device=dev, dtype=torch.float64)])


def _sparse(dev, R=5000, D=128, B=512, sizes=(100, 1, 27, 3)):
    """The dedupe's rows and values of a ragged batch at D, with its
    padding tail."""
    rng = np.random.default_rng(11)
    idx = torch.from_numpy(rng.integers(0, R, B * sum(sizes)).astype(
        np.int32)).to(dev)
    g = torch.randn((B * len(sizes), D), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    rows, vals = fe.dedupe_bags(idx, g, 0, R, sizes)
    return optim.SparseRowGrad(rows, vals)


def _f64(leaves):
    return sum(float(torch.sum(mt._vals(l).double() ** 2)) for l in leaves)


def test_grad_sq_norm_against_float64(dev):
    grads, _ = _dense_tree("dlrm_dcnv2", dev)
    sp = _sparse(dev)
    n_live = int((sp.rows < 5000).sum())
    assert n_live < sp.rows.shape[0] // 2               # mostly padding
    all_pad = optim.SparseRowGrad(
        torch.full((40,), 7, dtype=torch.int32, device=dev),
        torch.zeros((40, 16), device=dev))
    no_pad = optim.SparseRowGrad(
        torch.arange(33, dtype=torch.int32, device=dev),
        torch.randn((33, 1), device=dev))
    odd, _ = _odd_tree(dev)
    bf16, _ = _odd_tree(dev, torch.bfloat16)
    for leaves in (grads, [sp], [all_pad], [no_pad], odd, bf16,
                   [*grads, sp, all_pad, no_pad, *odd, *bf16]):
        cuda_lib.reset_launches()
        sq = mt.grad_sq_norm(leaves)
        norm = mt.global_norm(leaves)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES["grad_sq_norm"] == 2
        want = _f64(leaves)
        assert sq.dtype == torch.float32 and sq.dim() == 0
        assert abs(float(sq) - want) <= 1e-6 * want + 1e-30
        assert float(norm) == float(torch.sqrt(sq))
        # two calls, the same bits
        assert torch.equal(mt.grad_sq_norm(leaves), sq)
    # many leaves: more than one launch of partial sums
    many, _ = _odd_tree(dev, n_leaves=150)
    assert abs(float(mt.grad_sq_norm(many)) - _f64(many)) <= 1e-6 * _f64(many)


def test_grad_sq_norm_never_reads_the_padding(dev):
    """Padding past the first sentinel entry, set to NaN, is never read:
    the norm reads up to the first entry of the last row id."""
    sp = _sparse(dev)
    n_live = int((sp.rows < 5000).sum())
    vals = sp.vals.clone()
    vals[n_live + 1:] = float("nan")
    got = mt.grad_sq_norm([optim.SparseRowGrad(sp.rows, vals)])
    want = mt.grad_sq_norm([sp])
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["dlrm_dcnv2", "wide_deep"])
def test_train_steps_count_one_launch_each_and_leave_the_state(dev, kind):
    cfg = dataclasses.replace(tcfg.reduced_dlrm(_full(kind)),
                              zipf_alpha=1.05, hot_rows_k=8)
    if kind == "dlrm_dcnv2":
        cfg = dataclasses.replace(cfg, embed_dim=128,
                                  bottom_mlp_dims=(16, 128))
    layout = tpol.padded_layout_for_ranges(
        tpol.uniform_vocab_ranges(cfg.total_embedding_rows, 4))
    opt = optim.make("adagrad", LR)
    state = trainer.make_dlrm_train_state(
        cfg, opt, torch.Generator(device=dev).manual_seed(0), layout=layout)
    step = trainer.make_dlrm_train_step(
        cfg, opt, plan=cfg.embedding_plan(layout=layout, sparse_update=True))
    B = cfg.batch_size
    batches = [launch.to_device(criteo_batch(
        cfg, 7, np.arange(i * B, (i + 1) * B)), dev) for i in range(3)]
    stores = dlrm_mod.sparse_param_keys(cfg)
    n_dense = len(state["params"]) - len(stores)
    old = {k: v.clone() for k, v in state["params"].items()
           if k not in stores}
    old_acc = {k: v.clone() for k, v in state["opt"]["acc"].items()
               if k not in stores}
    first = state
    cuda_lib.reset_launches()
    for b in batches:
        state, m = step(state, b)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["grad_sq_norm"] == len(batches)
    assert cuda_lib.LAUNCHES["dense_adagrad"] == len(batches)
    assert cuda_lib.LEAF_COUNTS == {
        "dense_leaves": n_dense * len(batches),
        "dense_leaves_fused": n_dense * len(batches)}
    for k, v in old.items():
        assert torch.equal(first["params"][k], v)
        assert torch.equal(first["opt"]["acc"][k], old_acc[k])
    assert any(not torch.equal(state["params"][k], v) for k, v in old.items())
