"""The dedupe's two entries on the CPU: ``dedupe_bags`` against
``dedupe_rows``, and the route each backward takes.

Unweighted ``sum``/``mean`` bags dedupe their (B*T, D) bag cotangents
(``dedupe_bags``, the segment sum's bags route on the card); ``max`` and
weighted bags their per-lookup row cotangents (``dedupe_rows``, its rows
route). On CPU tensors both run the plain twin, ``torch.segment_reduce``
over the sorted gather, and every result here is held bit for bit to the
arithmetic the port had before the bags route existed: the expanded
per-lookup cotangents through ``dedupe_rows``. The kernel itself is held
to the same on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401  (sets torch threads)
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import fused_embedding as fe  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402

ROWS = (3, 40, 96, 24)          # a 3-row table: long segments
OFFSETS = fe.table_offsets(ROWS)
RANGES = [(0, 50), (50, 120), (120, 120), (120, sum(ROWS))]


def _lookups(B, H, seed):
    """(B, T, H) zipf local ids with in-bag duplicates, as a tensor."""
    rng = np.random.default_rng(seed)
    u = rng.random((B, len(ROWS), H))
    idx = np.stack([np.minimum((r ** u[:, t]).astype(np.int64), r) - 1
                    for t, r in enumerate(ROWS)], axis=1)
    idx[:, :, -1] = idx[:, :, 0]
    return torch.from_numpy(idx.astype(np.int32))


def _plan(combiner, padded):
    layout = tpol.padded_layout_for_ranges(RANGES) if padded else None
    return tpol.EmbeddingPlan(offsets=OFFSETS, combiner=combiner,
                              layout=layout)


def _parent_sparse_grads(pool, store_idx, w, g, combiner, B, T, H):
    """The dedupe of the per-lookup cotangents, as the port computed them
    for every combiner before the bags route."""
    D = pool.shape[1]
    if combiner == "max":
        g_rows, dw = fe._row_cotangents(pool, store_idx, w, g,
                                        combiner=combiner, B=B, T=T, H=H)
    else:
        g_rows, dw = g[:, :, None, :].expand(B, T, H, D), None
        if combiner == "mean":
            g_rows = g_rows / H
        if w is not None:
            rows = pool.index_select(0, store_idx).reshape(B, T, H, D)
            dw = (g_rows * rows).sum(dim=-1)
            g_rows = g_rows * w[..., None]
    rows, vals = fe.dedupe_rows(store_idx, g_rows.reshape(B * T * H, D),
                                pool.shape[0])
    return rows, vals, dw


@pytest.mark.parametrize("D", [16, 1, 3])
@pytest.mark.parametrize("H", [4, 2])
def test_dedupe_bags_equals_dedupe_rows_of_the_repeated_cotangents(D, H):
    rng = np.random.default_rng(D * 10 + H)
    B, T, R = 97, 5, 60
    store_idx = torch.from_numpy(
        rng.integers(0, R, B * T * H).astype(np.int32))
    store_idx[: B * T * H // 3] = 0                  # one long segment
    store_idx[-7:] = R - 1                           # the boundary row
    g_bags = torch.from_numpy(rng.standard_normal((B * T, D))
                              .astype(np.float32))
    g_bags[5] = -0.0                                 # signed zeros
    rows, vals = fe.dedupe_bags(store_idx, g_bags, H, R)
    want_rows, want_vals = fe.dedupe_rows(
        store_idx, g_bags.repeat_interleave(H, 0), R)
    assert rows.dtype == torch.int32 and vals.shape == (B * T * H, D)
    assert torch.equal(rows, want_rows)
    assert torch.equal(vals, want_vals)
    n_uniq = len(np.unique(store_idx.numpy()))
    assert (rows[n_uniq:] == R).all() and not vals[n_uniq:].any()


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_backward_routes_match_the_parent_arithmetic(monkeypatch, combiner,
                                                     weighted, padded):
    """Both backward paths take the bags route exactly for unweighted sum
    and mean, and give the parent's rows, values and weight cotangents bit
    for bit; the sparse pair scattered equals the autograd gradient."""
    B, H, D = 29, 4, 16
    T = len(ROWS)
    plan = _plan(combiner, padded)
    rng = np.random.default_rng(3)
    R = plan.layout.padded_rows if padded else sum(ROWS)
    pool = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32))
    idx = _lookups(B, H, seed=4)
    g = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.1, 2.0, (B, T, H))
                         .astype(np.float32)) if weighted else None
    taken = []
    for name in ("dedupe_bags", "dedupe_rows"):
        real = getattr(fe, name)

        def spy(*args, _real=real, _name=name):
            taken.append(_name)
            return _real(*args)
        monkeypatch.setattr(fe, name, spy)

    rows, vals, dw = fe.sparse_row_grads(pool, idx, g, w, plan=plan)
    want = "dedupe_rows" if weighted or combiner == "max" else "dedupe_bags"
    assert taken == [want]
    flat = fe._flat_lookups(idx, plan.offsets)
    store_idx = flat if plan.layout is None else \
        fe.translate_rows(flat, plan.layout)
    monkeypatch.undo()
    p_rows, p_vals, p_dw = _parent_sparse_grads(pool, store_idx, w, g,
                                                combiner, B, T, H)
    assert torch.equal(rows, p_rows) and torch.equal(vals, p_vals)
    assert (dw is None) == (not weighted)
    if weighted:
        assert torch.equal(dw, p_dw.reshape(dw.shape))
    tp = pool.clone().requires_grad_()
    out = fe.fused_embedding_bag(tp, idx, w, plan=plan)
    (out * g).sum().backward()
    assert torch.equal(fe.scatter_rows(rows, vals, R), tp.grad)


def test_segment_sum_refuses_what_the_kernel_cannot_take():
    """The kernel's wrapper takes CUDA tensors only: a CPU tensor raises
    before anything is built or launched."""
    order = torch.arange(8)
    counts = torch.tensor([3, 5])
    src = torch.zeros((2, 4))
    vals = torch.zeros((8, 4))
    launches = dict(cuda_lib.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        fe.segment_sum_cuda(order, counts, src, 4, vals, "bags")
    assert cuda_lib.LAUNCHES == launches
