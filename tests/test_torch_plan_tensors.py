"""The embedding engine's plan tensors (``fused_embedding.static_tensor``).

The offsets, padded-shard starts and hot-row maps that the lookups need on
their device depend only on the plan. They are made there once and kept, so
that a train step copies no host list to the card (each such copy drains
the stream). The card test that counts the step's syncs is in
``tests/test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_embedding as fe  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402


def test_plan_tensors_are_made_once_per_key_dtype_and_device():
    """The offsets, shard starts and hot-row maps the engine needs on the
    lookups' device are made there once and kept: the same object on every
    call, equal to a fresh copy, and apart for another dtype."""
    vals = (0, 3, 70, 1_000_003)
    a = fe.static_ints(vals, torch.int32, "cpu")
    assert a is fe.static_ints(vals, torch.int32, torch.device("cpu"))
    assert torch.equal(a, torch.as_tensor(vals, dtype=torch.int32))
    b = fe.static_ints(vals, torch.int64, "cpu")
    assert b is not a and b.dtype == torch.int64
    with torch.inference_mode():
        c = fe.static_ints((5, 6), torch.int64, "cpu")
    assert not c.is_inference()
    # a second forward and backward under one plan makes nothing new
    rows_t, B, H, D = (40, 96, 24), 8, 4, 16
    layout = tpol.padded_layout_for_ranges(
        tpol.uniform_vocab_ranges(sum(rows_t), 2))
    plan = tpol.EmbeddingPlan(offsets=fe.table_offsets(rows_t),
                              table_hot=(4, 0, 3), layout=layout)
    gen = torch.Generator().manual_seed(3)
    pool = torch.randn((layout.padded_rows, D), generator=gen)
    idx = torch.stack([torch.randint(0, r, (B, H), generator=gen)
                       for r in rows_t], dim=1)
    grads, kept = [], []
    for _ in range(2):
        p = pool.clone().requires_grad_()
        fe.fused_embedding_bag(p, idx, plan=plan).sum().backward()
        grads.append(p.grad)
        kept.append(dict(fe._STATIC))
    assert kept[0].keys() == kept[1].keys()
    assert all(kept[0][k] is kept[1][k] for k in kept[0])
    assert torch.equal(*grads)

