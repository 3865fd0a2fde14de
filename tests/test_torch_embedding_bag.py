"""Port parity: the single-table embedding bag ``ops.embedding_bag`` (the
T=1 wrapper over K1's plain version on the CPU) and its oracle
``ref.embedding_bag_ref``.

The same numpy table / indices / weights / cotangent go through the JAX
reference (``ops.embedding_bag(..., impl="xla")`` and
``repro.kernels.ref.embedding_bag_ref``) and the port. Bounds: the ``max``
forward exact (a gather); every other array within 1e-6 relative to the
largest magnitude of the reference's array (the frameworks may add in other
orders, and a sum that cancels leaves a small element whose own relative
error is large). The table gradient is a scatter-add of the bags'
cotangents, so a sum even under ``max``; where it lands is exact: its
nonzero rows and elements are the reference's (a max routes each cotangent
to its argmax rows, split evenly among ties as ``jax.grad`` does).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import to_np  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.sharding import policy as jpol  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

R, D, B = 97, 16, 11
COMBINERS = ("sum", "mean", "max")
REL = 1e-6


def _inputs(n, seed=0):
    """Table, (B, n) zipf ids with an in-bag duplicate (a tie for max),
    weights and an output cotangent, as numpy."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((R, D)).astype(np.float32)
    idx = (np.minimum(R ** rng.random((B, n)), R) - 1).astype(np.int32)
    idx[:, -1] = idx[:, 0]
    w = rng.uniform(0.1, 2.0, (B, n)).astype(np.float32)
    g = rng.standard_normal((B, D)).astype(np.float32)
    return table, idx, w, g


def _close(got, want, combiner, what):
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if combiner == "max":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=REL, atol=REL * scale,
                                   err_msg=what)


def _port(fn, table, idx, w, g):
    """Forward and (table, weights) gradients of ``fn`` in the port."""
    t = torch.from_numpy(table).requires_grad_()
    tw = None if w is None else torch.from_numpy(w).requires_grad_()
    out = fn(t, torch.from_numpy(idx), tw)
    leaves = [t] + ([] if tw is None else [tw])
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    return out, grads[0], (None if tw is None else grads[1])


def _reference(fn, table, idx, w, g):
    """Forward and (table, weights) gradients of ``fn`` in the reference."""
    if w is None:
        out, vjp = jax.vjp(lambda t: fn(t, jnp.asarray(idx), None),
                           jnp.asarray(table))
        (dt,) = vjp(jnp.asarray(g))
        return out, dt, None
    out, vjp = jax.vjp(lambda t, ww: fn(t, jnp.asarray(idx), ww),
                       jnp.asarray(table), jnp.asarray(w))
    dt, dw = vjp(jnp.asarray(g))
    return out, dt, dw


def _check(port, ref, combiner, weighted):
    for got, want, what in zip(port, ref, ("out", "dtable", "dweights")):
        if want is None:
            assert got is None, what
            continue
        tag = f"{combiner} weighted={weighted} {what}"
        _close(got, want, combiner if what == "out" else "sum", tag)
        if what == "dtable":
            np.testing.assert_array_equal(to_np(got) != 0,
                                          np.asarray(want) != 0, tag)


@pytest.mark.parametrize("n", [4, 3])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", COMBINERS)
def test_embedding_bag_matches_reference_xla(combiner, weighted, n):
    table, idx, w, g = _inputs(n, seed=n)
    w = w if weighted else None
    tplan = tpol.EmbeddingPlan(combiner=combiner)
    jplan = jpol.EmbeddingPlan(combiner=combiner)
    cuda_lib.reset_launches()
    port = _port(lambda t, i, ww: tops.embedding_bag(t, i, ww, plan=tplan),
                 table, idx, w, g)
    assert cuda_lib.LAUNCHES == {k: 0 for k in cuda_lib.LAUNCHES}
    ref = _reference(jax.jit(lambda t, i, ww: jops.embedding_bag(
        t, i, ww, plan=jplan, impl="xla")), table, idx, w, g)
    _check(port, ref, combiner, weighted)
    # the oracle agrees with the wrapper's reference path
    oracle = _reference(jax.jit(lambda t, i, ww: jref.embedding_bag_ref(
        t, i, ww, combiner=combiner)), table, idx, w, g)
    _check(port, oracle, combiner, weighted)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", COMBINERS)
def test_embedding_bag_ref_matches_reference_oracle(combiner, weighted):
    table, idx, w, g = _inputs(4, seed=7)
    w = w if weighted else None
    port = _port(lambda t, i, ww: tref.embedding_bag_ref(
        t, i, ww, combiner=combiner), table, idx, w, g)
    ref = _reference(jax.jit(lambda t, i, ww: jref.embedding_bag_ref(
        t, i, ww, combiner=combiner)), table, idx, w, g)
    _check(port, ref, combiner, weighted)


def test_embedding_bag_default_plan_is_an_unweighted_sum():
    table, idx, _, g = _inputs(4, seed=3)
    port = _port(lambda t, i, ww: tops.embedding_bag(t, i), table, idx,
                 None, g)
    ref = _reference(jax.jit(lambda t, i, ww: jops.embedding_bag(
        t, i, impl="xla")), table, idx, None, g)
    _check(port, ref, "sum", False)
    explicit = tops.embedding_bag(torch.from_numpy(table),
                                  torch.from_numpy(idx),
                                  plan=tpol.EmbeddingPlan(combiner="sum"))
    assert torch.equal(port[0].detach(), explicit)


def test_embedding_bag_takes_int64_and_strided_indices():
    """A (B, n) view of a wider int64 array pools as its int32 copy."""
    table, idx, w, _ = _inputs(4, seed=5)
    wide = np.concatenate([idx, idx[:, :1]], axis=1).astype(np.int64)
    view = torch.from_numpy(wide)[:, :4]
    assert not view.is_contiguous()
    plan = tpol.EmbeddingPlan(combiner="mean")
    t, tw = torch.from_numpy(table), torch.from_numpy(w)
    assert torch.equal(tops.embedding_bag(t, view, tw, plan=plan),
                       tops.embedding_bag(t, torch.from_numpy(idx), tw,
                                          plan=plan))


def test_embedding_bag_ref_rejects_unknown_combiners():
    table, idx, _, _ = _inputs(4)
    with pytest.raises(ValueError):
        tref.embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(idx),
                               combiner="min")
