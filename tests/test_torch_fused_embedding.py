"""Port parity: the fused embedding bag (K1's plain version on the CPU), its
autograd backward, ``dedupe_rows`` and ``sparse_row_grads``.

The same numpy pool / indices / weights / cotangent go through the JAX
reference (``method="xla"`` and ``repro.kernels.ref``) and the port.
Tolerances:

* forward: ``max`` exact; ``sum``/``mean`` within 2 ULP (the two frameworks
  may reduce the H lookups in another order);
* within the port: padded == flat and cache-on == cache-off, bit for bit;
* dedupe: rows exact, summed values within 2 ULP;
* gradients: within 1e-6 absolute + 1e-5 relative (the weight cotangent is
  a D-long dot product whose summation order differs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_ulp_close, to_np  # noqa: E402
from repro.kernels import fused_embedding as jfe  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.sharding import policy as jpol  # noqa: E402
from repro.train.optim import SparseRowGrad as JSparseRowGrad  # noqa: E402
from repro_torch.kernels import fused_embedding as tfe  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402
from repro_torch.train.optim import SparseRowGrad  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROWS = (64, 40, 96, 24)                 # the shapes of test_hot_row_cache
OFFSETS = tfe.table_offsets(ROWS)
HOT = (16, 8, 24, 6)
TOTAL = sum(ROWS)
RANGES = [(0, 50), (50, 120), (120, 120), (120, TOTAL)]   # one empty shard
COMBINERS = ("sum", "mean", "max")
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _stream(B=13, H=4, D=16, seed=0, alpha=1.05, dup=True):
    """Pool, (B, T, H) local ids (zipf, with forced in-bag duplicates),
    weights and an output cotangent, as numpy."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((TOTAL, D)).astype(np.float32)
    u = rng.random((B, len(ROWS), H))
    idx = np.stack([np.minimum((r ** u[:, t]).astype(np.int64), r) - 1
                    if alpha else rng.integers(0, r, (B, H))
                    for t, r in enumerate(ROWS)], axis=1).astype(np.int32)
    if dup:
        idx[:, :, -1] = idx[:, :, 0]          # ties for max, dupes for dedupe
    w = rng.uniform(0.1, 2.0, idx.shape).astype(np.float32)
    g = rng.standard_normal((B, len(ROWS), D)).astype(np.float32)
    return pool, idx, w, g


def _jplan(combiner, hot=None, layout=None):
    return jpol.EmbeddingPlan(offsets=OFFSETS, combiner=combiner,
                              table_hot=hot, layout=layout)


def _tplan(combiner, hot=None, layout=None):
    return tpol.EmbeddingPlan(offsets=OFFSETS, combiner=combiner,
                              table_hot=hot, layout=layout)


def _layouts(padded):
    if not padded:
        return None, None
    return (jpol.padded_layout_for_ranges(RANGES),
            tpol.padded_layout_for_ranges(RANGES))


def _pools(pool, padded, tl):
    """Numpy flat pool → (numpy store for JAX, torch 2-D pool view)."""
    if not padded:
        return pool, torch.from_numpy(pool.copy())
    store = tl.pad_rows(torch.from_numpy(pool.copy()))
    return store.numpy().reshape(tl.padded_rows, -1), \
        store.reshape(tl.padded_rows, -1)


def _assert_fwd_close(combiner, got, want, msg):
    if combiner == "max":
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        assert_ulp_close(got, want, 2, msg)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("hot", [None, HOT])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", COMBINERS)
def test_forward_matches_reference(combiner, weighted, hot, padded):
    pool, idx, w, _ = _stream()
    jl, tl = _layouts(padded)
    jpool, tpool = _pools(pool, padded, tl)
    wj = jnp.asarray(w) if weighted else None
    wt = torch.from_numpy(w) if weighted else None
    want = jfe.fused_embedding_bag(jnp.asarray(jpool), jnp.asarray(idx), wj,
                                   method="xla", plan=_jplan(combiner, hot, jl))
    got = tops.fused_embedding_bag(tpool, torch.from_numpy(idx), wt,
                                   plan=_tplan(combiner, hot, tl))
    assert got.dtype == torch.float32 and got.shape == (13, 4, 16)
    _assert_fwd_close(combiner, to_np(got), np.asarray(want), "vs xla")
    oracle = jref.fused_embedding_bag_ref(jnp.asarray(pool), jnp.asarray(idx),
                                          wj, offsets=OFFSETS,
                                          combiner=combiner)
    _assert_fwd_close(combiner, to_np(got), np.asarray(oracle), "vs ref")
    # within the port: every plan computes the same bits as flat, no cache
    base = tops.fused_embedding_bag(torch.from_numpy(pool),
                                    torch.from_numpy(idx), wt,
                                    plan=_tplan(combiner))
    assert torch.equal(got, base)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", COMBINERS)
def test_torch_ref_matches_jax_ref(combiner, weighted):
    pool, idx, w, _ = _stream(seed=4)
    wj = jnp.asarray(w) if weighted else None
    wt = torch.from_numpy(w) if weighted else None
    want = jref.fused_embedding_bag_ref(jnp.asarray(pool), jnp.asarray(idx),
                                        wj, offsets=OFFSETS, combiner=combiner)
    got = tref.fused_embedding_bag_ref(torch.from_numpy(pool),
                                       torch.from_numpy(idx), wt,
                                       offsets=OFFSETS, combiner=combiner)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("combiner", COMBINERS)
def test_plain_version_decodes_hot_slots(combiner):
    """K1's plain version: v < 0 reads cache slot -v-1, v >= 0 the pool."""
    rng = np.random.default_rng(5)
    pool = torch.from_numpy(rng.standard_normal((30, 4)).astype(np.float32))
    cache = pool[torch.tensor([3, 7, 11])].clone()
    enc = torch.tensor([[[0, -2, 5], [-1, -3, 29]]], dtype=torch.int32)
    dec = torch.tensor([[[0, 7, 5], [3, 11, 29]]], dtype=torch.int32)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (1, 2, 3)).astype(np.float32))
    got = tfe.embedding_bag_plain(pool, enc, w, cache, combiner)
    want = tfe.embedding_bag_plain(pool, dec, w, None, combiner)
    assert torch.equal(got, want)
    oracle = tref.fused_embedding_bag_ref(pool, dec, w, combiner=combiner)
    torch.testing.assert_close(got, oracle, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("hot", [None, HOT])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", COMBINERS)
def test_dense_grads_match_reference(combiner, weighted, hot, padded):
    pool, idx, w, g = _stream(seed=1)
    jl, tl = _layouts(padded)
    jpool, tpool = _pools(pool, padded, tl)

    def jloss(p, wt):
        out = jfe.fused_embedding_bag(p, jnp.asarray(idx), wt, method="xla",
                                      plan=_jplan(combiner, hot, jl))
        return jnp.sum(out * jnp.asarray(g))

    if weighted:
        jdp, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(jpool),
                                                   jnp.asarray(w))
    else:
        jdp, jdw = jax.grad(jloss)(jnp.asarray(jpool), None), None
    tp = tpool.clone().requires_grad_()
    tw = torch.from_numpy(w).requires_grad_() if weighted else None
    out = tops.fused_embedding_bag(tp, torch.from_numpy(idx), tw,
                                   plan=_tplan(combiner, hot, tl))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(to_np(tp.grad), np.asarray(jdp), **GRAD_TOL)
    if weighted:
        np.testing.assert_allclose(to_np(tw.grad), np.asarray(jdw), **GRAD_TOL)
    if padded:   # padding rows are never addressed: exactly zero gradient
        real = torch.zeros(tl.padded_rows, dtype=torch.bool)
        real[torch.tensor(tl.row_translation())] = True
        assert not tp.grad[~real].any()


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", COMBINERS)
def test_sparse_row_grads_match_reference_and_dense(combiner, weighted, padded):
    pool, idx, w, g = _stream(seed=2)
    jl, tl = _layouts(padded)
    jpool, tpool = _pools(pool, padded, tl)
    wj = jnp.asarray(w) if weighted else None
    wt = torch.from_numpy(w) if weighted else None
    jr, jv, jdw = jfe.sparse_row_grads(jnp.asarray(jpool), jnp.asarray(idx),
                                       jnp.asarray(g), wj,
                                       plan=_jplan(combiner, None, jl))
    plan = _tplan(combiner, HOT, tl)
    tr, tv, tdw = tops.sparse_row_grads(tpool, torch.from_numpy(idx),
                                        torch.from_numpy(g), wt, plan=plan)
    assert tr.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(to_np(tr), np.asarray(jr))
    np.testing.assert_allclose(to_np(tv), np.asarray(jv), **GRAD_TOL)
    if weighted:
        np.testing.assert_allclose(to_np(tdw), np.asarray(jdw), **GRAD_TOL)
    R = tpool.shape[0]
    jdense = JSparseRowGrad(jr, jv).to_dense(R)
    np.testing.assert_allclose(to_np(SparseRowGrad(tr, tv).to_dense(R)),
                               np.asarray(jdense), **GRAD_TOL)
    # the sparse pair scattered == the autograd dense gradient, bit for bit
    tp = tpool.clone().requires_grad_()
    out = tops.fused_embedding_bag(tp, torch.from_numpy(idx), wt, plan=plan)
    (out * torch.from_numpy(g)).sum().backward()
    assert torch.equal(SparseRowGrad(tr, tv).to_dense(R), tp.grad)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedupe_rows_matches_reference(seed):
    rng = np.random.default_rng(seed)
    R = 50
    rows = rng.integers(0, R, 200).astype(np.int32)
    rows[:40] = 0                                  # one very hot row
    rows[-5:] = R - 1                              # the boundary row
    g = rng.standard_normal((200, 3)).astype(np.float32)
    jr, jv = jfe.dedupe_rows(jnp.asarray(rows), jnp.asarray(g), R)
    tr, tv = tfe.dedupe_rows(torch.from_numpy(rows), torch.from_numpy(g), R)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert_ulp_close(tv.numpy(), np.asarray(jv), 2, "dedupe vals")
    n_uniq = len(np.unique(rows))
    assert (tr.numpy()[n_uniq:] == R).all()
    assert not tv[n_uniq:].any()


def test_sentinel_rows_are_masked_in_to_dense():
    rows = torch.tensor([2, 0, 5, 5], dtype=torch.int32)   # 5 == R: sentinel
    vals = torch.ones((4, 2))
    dense = SparseRowGrad(rows, vals).to_dense(5)
    assert dense.shape == (5, 2)
    assert dense[2].tolist() == [1.0, 1.0] and dense[0].tolist() == [1.0, 1.0]
    assert dense.sum().item() == 4.0


def test_single_table_global_ids_and_errors():
    pool, _, _, _ = _stream()
    idx = torch.tensor([[[3, 3, 100]], [[0, 223, 5]]], dtype=torch.int32)
    plan = tpol.EmbeddingPlan(combiner="sum", table_hot=(8,))
    got = tops.fused_embedding_bag(torch.from_numpy(pool), idx, plan=plan)
    want = tref.fused_embedding_bag_ref(torch.from_numpy(pool), idx)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(AssertionError):
        tops.fused_embedding_bag(torch.from_numpy(pool), idx[0],
                                 plan=tpol.EmbeddingPlan())
