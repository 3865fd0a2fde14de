"""xDeepFM's CIN as one autograd Function around ``torch.mm``.

``models.dlrm._CIN`` forms each layer's outer products as the (B*D, H*m)
operand of one ``torch.mm`` (``ops.cin_product``) and contracts the
operand's cotangent back onto both factors (``ops.cin_contract``).

On the CPU (always run): the Function's plain path gives the values and
gradients of the einsum expressions the port ran before, at small odd
shapes; ``gradcheck`` in float64; the plain product is the broadcast
product laid out (B*D, H*m) bit for bit, through strided views too; the
plain contraction is within a rounding of a float64 one; unpaired shapes
and mixed devices raise; meta tensors run; a train step records the span
``train_step.cin`` with the Function's ops in it.

Marked ``cuda`` (each skips without a card, deciding inside its fixture):
the product kernel bit for bit with the broadcast product at the
xDeepFM cell's shapes (B 8,192, m 26, D 16, 26 and 128 maps, the latter
read through the permuted view of a ``torch.mm`` output), at an odd shape
and on the scalar route; the contraction bit for bit with the eager
products and sums it replaced, within a stated bound of a float64
contraction, and deterministic; the whole CIN on the card bit for bit
with plain autograd over the same layout on the card, and against its
plain path on the CPU; a train step's launch counts; refusals. On a
machine with a card: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cin.py``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one CPU thread)
from repro_torch.configs import dlrm_models as tcfg
from repro_torch.configs.registry import get_dlrm
from repro_torch.data.synthetic import criteo_batch
from repro_torch.kernels import cin as cin_k
from repro_torch.kernels import cuda_lib, ops
from repro_torch.launch.train import to_device
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.sharding import policy as tpol
from repro_torch.train import optim as toptim
from repro_torch.train import trainer as ttrainer

F32_EPS = 2.0 ** -24          # a float32 rounding, relative
# (B, m, D, maps): an odd shape, one of the reduced config's, a
# one-coordinate one-layer one
SHAPES = [(3, 5, 4, (6, 7)), (4, 6, 8, (8, 8)), (5, 3, 1, (2,))]
CUDA = pytest.mark.cuda


def _inputs(B, m, D, maps, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    x0 = torch.randn((B, m, D), generator=g, dtype=torch.float64)
    ws, H = [], m
    for n in maps:
        ws.append(torch.randn((H, m, n), generator=g, dtype=torch.float64)
                  / (H * m) ** 0.5)
        H = n
    return [t.to(dtype=dtype, device=device) for t in [x0, *ws]]


def _einsums(x0, ws):
    """The CIN as the port wrote it before the Function: two einsums a
    layer, then each layer's maps summed over D."""
    xk, feats = x0, []
    for w in ws:
        inter = torch.einsum("bhd,bmd->bhmd", xk, x0)
        xk = torch.einsum("bhmd,hmn->bnd", inter, w)
        feats.append(xk.sum(dim=-1))
    return torch.cat(feats, dim=-1)


def _value_and_grads(fn, leaves, g_out):
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    out = fn(leaves[0], leaves[1:])
    return out.detach(), torch.autograd.grad(out, leaves, g_out)


def _cin(x0, ws):
    return dlrm_mod._CIN.apply(x0, *ws)


def _close(got, want, rel):
    """``got`` within ``rel`` of ``want``'s largest magnitude."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * max(scale, 1e-30), (err, scale)


def _broadcast_product(xk, x0):
    B, H, D = xk.shape
    m = x0.shape[1]
    return (xk[:, :, None] * x0[:, None]).permute(0, 3, 1, 2).reshape(
        B * D, H * m)


def _maps_of_a_product(B, D, H, device, seed):
    """(B, H, D) input maps as a later layer sees them: the permuted view
    of a (B*D, H) ``torch.mm`` output."""
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randn((B * D, H), generator=g, device=device)
    return y.view(B, D, H).permute(0, 2, 1)


# ---------------------------------------------------------------------------
# the CPU: the plain path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cin_function_matches_the_einsums(shape):
    """Values and every gradient of the Function's plain path against the
    einsum expressions, in float32: the products are the same, the sums
    over H*m, D and the batch run in other orders (at most a few hundred
    terms here), so each result is within 1e-5 of its largest value."""
    B, m, D, maps = shape
    leaves = _inputs(B, m, D, maps)
    g_out = torch.randn((B, sum(maps)),
                        generator=torch.Generator().manual_seed(1))
    got, g_got = _value_and_grads(_cin, leaves, g_out)
    want, g_want = _value_and_grads(_einsums, leaves, g_out)
    _close(got, want, 1e-5)
    assert len(g_got) == len(g_want) == 1 + len(maps)
    for a, b in zip(g_got, g_want):
        assert a.shape == b.shape
        _close(a, b, 1e-5)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
def test_cin_gradcheck_float64(shape):
    B, m, D, maps = shape
    leaves = [t.requires_grad_() for t in _inputs(B, m, D, maps,
                                                  dtype=torch.float64)]
    assert torch.autograd.gradcheck(lambda *t: _cin(t[0], t[1:]), leaves)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("shape", [(3, 5, 4, 6), (2, 26, 16, 128)], ids=str)
def test_plain_product_is_the_broadcast_product(shape, strided):
    B, m, D, H = shape
    x0 = torch.randn((B, m, D), generator=torch.Generator().manual_seed(2))
    xk = _maps_of_a_product(B, D, H, "cpu", 3) if strided else \
        torch.randn((B, H, D), generator=torch.Generator().manual_seed(3))
    z = ops.cin_product(xk, x0)
    assert z.shape == (B * D, H * m)
    assert torch.equal(z, _broadcast_product(xk, x0))


def _contract_f64(gz, xk, x0):
    """float64 ``(gxk, gx0)`` and the same sums of the terms' magnitudes."""
    B, H, D = xk.shape
    m = x0.shape[1]
    g = gz.double().reshape(B, D, H, m)
    a, b = xk.double(), x0.double()
    return (torch.einsum("bdhj,bjd->bhd", g, b),
            torch.einsum("bdhj,bhd->bjd", g, a),
            torch.einsum("bdhj,bjd->bhd", g.abs(), b.abs()),
            torch.einsum("bdhj,bhd->bjd", g.abs(), a.abs()))


def _assert_contract(gxk, gx0, gz, xk, x0):
    """Each output within 2 n 2^-24 of the float64 sum of its terms'
    magnitudes, n its term count (m for gxk, H for gx0): a float32 sum of
    n products in any order is within gamma_n = n u / (1 - n u) of that
    magnitude (u = 2^-24, the unit roundoff), and 2 n u holds gamma_n for
    every n here with room for the float64 sum's own rounding."""
    H, m = xk.shape[1], x0.shape[1]
    want_k, want_0, mag_k, mag_0 = _contract_f64(gz, xk, x0)
    assert gxk.shape == xk.shape and gx0.shape == x0.shape
    for got, want, mag, n in ((gxk, want_k, mag_k, m),
                              (gx0, want_0, mag_0, H)):
        assert bool(((got.double() - want).abs()
                     <= 2 * n * F32_EPS * mag).all()), n


@pytest.mark.parametrize("shape", [(3, 5, 4, 6), (2, 26, 16, 128)], ids=str)
def test_plain_contract_is_a_rounding_of_float64(shape):
    B, m, D, H = shape
    gen = torch.Generator().manual_seed(4)
    x0 = torch.randn((B, m, D), generator=gen)
    xk = _maps_of_a_product(B, D, H, "cpu", 5)
    gz = torch.randn((B * D, H * m), generator=gen)
    gxk, gx0 = ops.cin_contract(gz, xk, x0)
    _assert_contract(gxk, gx0, gz, xk, x0)


@pytest.mark.parametrize("fn", ["cin_product", "cin_contract"])
def test_unpaired_shapes_and_mixed_devices_raise(fn):
    x0 = torch.zeros((2, 3, 4))
    call = {"cin_product": lambda xk, x: ops.cin_product(xk, x),
            "cin_contract": lambda xk, x: ops.cin_contract(
                torch.zeros((8, 3 * xk.shape[1])), xk, x)}[fn]
    for xk in (torch.zeros((3, 3, 4)), torch.zeros((2, 3, 5)),
               torch.zeros((2, 3))):
        with pytest.raises(ValueError, match="share B and D"):
            call(xk, x0)
    with pytest.raises(ValueError, match="more than one device"):
        call(torch.zeros((2, 3, 4), device="meta"), x0)


def test_cin_runs_on_meta_tensors():
    x0, *ws = _inputs(3, 5, 4, (6, 7), device="meta")
    assert _cin(x0, ws).shape == (3, 13)
    assert ops.cin_product(x0, x0).shape == (12, 25)


def _small_xdeepfm():
    cfg = dataclasses.replace(tcfg.reduced_dlrm(get_dlrm("xdeepfm")),
                              zipf_alpha=1.05, hot_rows_k=8)
    layout = tpol.padded_layout_for_ranges(
        tpol.uniform_vocab_ranges(cfg.total_embedding_rows, 4))
    return cfg, layout


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree


def _step_and_batches(cfg, layout, device, steps):
    """A fused adagrad step, a state drawn on the CPU and moved to
    ``device``, and ``steps`` batches there."""
    opt = toptim.make("adagrad", 3e-3)
    state = _on(ttrainer.make_dlrm_train_state(
        cfg, opt, torch.Generator().manual_seed(0), layout=layout), device)
    step = ttrainer.make_dlrm_train_step(
        cfg, opt, plan=cfg.embedding_plan(layout=layout, sparse_update=True))
    B = cfg.batch_size
    batches = [to_device(criteo_batch(cfg, 7, np.arange(i * B, (i + 1) * B)),
                         device) for i in range(steps)]
    return state, step, batches


def test_train_step_records_the_cin_span_with_its_ops(tmp_path):
    """Under the profiler a step records ``train_step.cin`` twice: the
    forward (one product and one ``torch.mm`` a layer), then the backward
    (a contraction, whose plain version is two einsums, a rebuilt product
    and two ``torch.mm`` a layer)."""
    cfg, layout = _small_xdeepfm()
    state, step, batches = _step_and_batches(cfg, layout, "cpu", 2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for b in batches:
            state, _ = step(state, b)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    done = [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in done
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("train_step."))
    cins = [s for s in spans if s[2] == "train_step.cin"]
    fwd_bwd = [s for s in spans if s[2] == "train_step.forward_backward"]
    assert len(cins) == 2 * len(batches) and len(fwd_bwd) == len(batches)
    for s, t, _ in cins:
        assert any(a <= s and t <= b for a, b, _ in fwd_bwd)

    def ops_in(s, t, name):
        return sum(1 for e in done if e.get("cat") == "cpu_op"
                   and e["name"] == name and s <= float(e["ts"]) <= t)
    n = len(cfg.cin_layers)
    for i, (s, t, _) in enumerate(cins):
        if i % 2 == 0:                          # the forward
            assert ops_in(s, t, "aten::einsum") == n
            assert ops_in(s, t, "aten::mm") >= n
        else:                                   # the backward
            assert ops_in(s, t, "aten::einsum") == 3 * n
            assert ops_in(s, t, "aten::mm") >= 2 * n
    assert cuda_lib.LAUNCHES["cin_product"] == 0
    assert cuda_lib.LAUNCHES["cin_contract"] == 0


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cuda_lib.load()
    return torch.device("cuda", 0)


# (B, m, D, H, strided xk): the cell's layer 0 (xk is x0) and layer 1, an
# odd shape, one whose sample is no multiple of 4 floats (scalar route),
# and one whose row of the cotangent is too long to load ahead
CARD_SHAPES = [(8192, 26, 16, 26, False), (8192, 26, 16, 128, True),
               (3, 5, 4, 6, True), (3, 5, 3, 7, False),
               (3, 26, 2, 200, True)]


def _card_maps(shape, dev):
    B, m, D, H, strided = shape
    gen = torch.Generator(device=dev).manual_seed(6)
    x0 = torch.randn((B, m, D), generator=gen, device=dev)
    if strided:
        xk = _maps_of_a_product(B, D, H, dev, 7)
    elif H == m:
        xk = x0
    else:
        xk = torch.randn((B, H, D), generator=gen, device=dev)
    return xk, x0


@CUDA
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_cin_product_kernel_is_the_broadcast_product(dev, shape):
    xk, x0 = _card_maps(shape, dev)
    cuda_lib.reset_launches()
    z = ops.cin_product(xk, x0)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["cin_product"] == 1
    assert torch.equal(z, _broadcast_product(xk, x0))


@CUDA
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_cin_contract_kernel_is_the_eager_sums(dev, shape):
    """Bit for bit the broadcast products and sums autograd ran over the
    product's cotangent (``gz`` viewed as (B, H, m, D)), hence within the
    bound of ``_assert_contract``; two calls give the same bits (fixed
    orders, no atomics); ``gxk`` is (B, D, H) in memory."""
    xk, x0 = _card_maps(shape, dev)
    B, H, D = xk.shape
    m = x0.shape[1]
    gz = torch.randn((B * D, H * m), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(8))
    cuda_lib.reset_launches()
    gxk, gx0 = ops.cin_contract(gz, xk, x0)
    again = ops.cin_contract(gz, xk, x0)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["cin_contract"] == 2
    assert torch.equal(gxk, again[0]) and torch.equal(gx0, again[1])
    assert gxk.permute(0, 2, 1).is_contiguous() and gx0.is_contiguous()
    g = gz.view(B, D, H, m).permute(0, 2, 3, 1)
    assert torch.equal(gxk, (g * x0[:, None]).sum(2))
    assert torch.equal(gx0, (g * xk[:, :, None]).sum(1))
    _assert_contract(gxk, gx0, gz, xk, x0)


def _eager_cin(x0, ws):
    """The CIN as plain autograd over the (B*D, H*m) layout: a broadcast
    product, its permuted copy and one ``torch.mm`` a layer."""
    B, m, D = x0.shape
    xk, feats = x0, []
    for w in ws:
        H, _, n = w.shape
        z = xk[:, :, None, :] * x0[:, None, :, :]
        z = z.permute(0, 3, 1, 2).reshape(B * D, H * m)
        xk = torch.mm(z, w.reshape(H * m, n)).reshape(B, D, n).permute(
            0, 2, 1)
        feats.append(xk.sum(dim=-1))
    return torch.cat(feats, dim=-1)


@CUDA
@pytest.mark.parametrize("shape", [(64, 26, 16, (128, 128)),
                                   (3, 5, 4, (6, 7)), (5, 3, 3, (2,))],
                         ids=str)
def test_cin_on_card_is_eager_autograd_bit_for_bit(dev, shape):
    """The Function's values and every gradient on the card equal plain
    autograd over the same layout on the card, bit for bit: the same
    products, the same ``torch.mm`` calls, the contraction in the eager
    sums' order and ``x0``'s cotangents added in autograd's order."""
    B, m, D, maps = shape
    leaves = [t.to(dev) for t in _inputs(B, m, D, maps)]
    g_out = torch.randn((B, sum(maps)), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(9))
    got, g_got = _value_and_grads(_cin, leaves, g_out)
    want, g_want = _value_and_grads(_eager_cin, leaves, g_out)
    assert torch.equal(got, want)
    for a, b in zip(g_got, g_want):
        assert torch.equal(a, b)


@CUDA
@pytest.mark.parametrize("shape", [(64, 26, 16, (128, 128)),
                                   (3, 5, 4, (6, 7)), (5, 3, 3, (2,))],
                         ids=str)
def test_cin_on_card_matches_its_plain_path(dev, shape):
    """The Function on the card (the kernels) against its plain path on
    the CPU from the same inputs: the products are equal, the ``torch.mm``s
    and the contraction sum in other orders, so values and gradients agree
    within 1e-5 of each one's largest magnitude."""
    B, m, D, maps = shape
    leaves = _inputs(B, m, D, maps)
    g_out = torch.randn((B, sum(maps)),
                        generator=torch.Generator().manual_seed(9))
    want, g_want = _value_and_grads(_cin, leaves, g_out)
    cuda_lib.reset_launches()
    got, g_got = _value_and_grads(_cin, [t.to(dev) for t in leaves],
                                  g_out.to(dev))
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["cin_product"] == 2 * len(maps)
    assert cuda_lib.LAUNCHES["cin_contract"] == len(maps)
    _close(got.cpu(), want, 1e-5)
    for a, b in zip(g_got, g_want):
        _close(a.cpu(), b, 1e-5)


@CUDA
def test_train_step_launches_each_cin_kernel_per_layer(dev):
    """One fused step of the small xDeepFM (two CIN layers): the product
    twice a layer (forward, and rebuilt in the backward), the contraction
    once; the loss is the CPU step's within 1e-5."""
    cfg, layout = _small_xdeepfm()
    losses = {}
    for device in ("cpu", dev):
        state, step, batches = _step_and_batches(cfg, layout, device, 1)
        cuda_lib.reset_launches()
        state, metrics = step(state, batches[0])
        losses[str(device)] = float(metrics["loss"])
        counts = dict(cuda_lib.LAUNCHES)
    n = len(cfg.cin_layers)
    assert counts["cin_product"] == 2 * n
    assert counts["cin_contract"] == n
    assert abs(losses[str(dev)] - losses["cpu"]) <= 1e-5 * losses["cpu"]


@CUDA
def test_cin_kernels_refuse_what_they_do_not_take(dev):
    x0 = torch.zeros((2, 3, 4), device=dev)
    with pytest.raises(ValueError, match="float32 alone"):
        ops.cin_product(x0.double(), x0.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.cin_contract(torch.zeros((9, 8), device=dev).t(), x0, x0)
    big = torch.zeros((1, 4096, 4), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        ops.cin_product(big, big)
    assert cin_k.smem_bytes(True, 128, 26, 16) <= cin_k.MAX_SMEM_BYTES
