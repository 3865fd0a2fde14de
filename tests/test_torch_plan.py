"""Port parity: configs, synthetic data, planners, layouts, id translation.

Integer outputs must equal the JAX reference exactly; the synthetic batches
must be byte-identical; the launcher's sample order must equal the
reference launcher's single-worker ``ShardDataLoader``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity  # noqa: E402,F401
from repro.configs import dlrm_models as jcfg  # noqa: E402
from repro.core.sharding_service import ShardingService  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.data.pipeline import ShardDataLoader  # noqa: E402
from repro.kernels import fused_embedding as jfe  # noqa: E402
from repro.sharding import policy as jpol  # noqa: E402
from repro_torch.configs import dlrm_models as tcfg  # noqa: E402
from repro_torch.configs.registry import DLRMS, get_dlrm  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import fused_embedding as tfe  # noqa: E402
from repro_torch.launch.train import sample_order  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROWS = (64, 40, 96, 24)
HOT = (16, 8, 24, 6)
KINDS = ("wide_deep", "xdeepfm", "dcn")
RANGE_PLANS = [
    [(0, 50), (50, 120), (120, 200), (200, 224)],
    [(0, 100), (100, 100), (100, 224)],          # an empty shard
    [(0, 224)],                                  # one shard
]


def _cfg_pair(kind, reduced):
    j = {"wide_deep": jcfg.WIDE_DEEP, "xdeepfm": jcfg.XDEEPFM,
         "dcn": jcfg.DCN}[kind]
    t = get_dlrm(kind)
    if reduced:
        return jcfg.reduced_dlrm(j), tcfg.reduced_dlrm(t)
    return j, t


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_configs_match(kind, reduced):
    j, t = _cfg_pair(kind, reduced)
    for field in ("name", "kind", "n_dense", "n_tables", "table_rows",
                  "embed_dim", "mlp_dims", "cross_layers", "cin_layers",
                  "batch_size", "pooling", "multi_hot"):
        assert getattr(j, field) == getattr(t, field), field
    assert j.total_embedding_rows == t.total_embedding_rows
    assert j.table_offsets == t.table_offsets
    assert j.param_count() == t.param_count()
    for k in (0, 64, 26 * 512):
        import dataclasses
        jk = dataclasses.replace(j, hot_rows_k=k)
        tk = dataclasses.replace(t, hot_rows_k=k)
        assert jk.table_hot == tk.table_hot
    assert set(DLRMS) == set(KINDS)


def test_full_wide_deep_is_model_x_at_full_width():
    cfg = get_dlrm("wide_deep")
    assert (cfg.n_tables, cfg.total_embedding_rows, cfg.embed_dim,
            cfg.batch_size, cfg.multi_hot, cfg.mlp_dims) == \
        (26, 3_294_238, 16, 512, 4, (512, 256, 128))


@pytest.mark.parametrize("alpha", [0.0, 0.7, 1.0, 1.05])
def test_zipf_indices_bytes_identical(alpha):
    a = jsyn.zipf_indices(np.random.default_rng(3), 1000, (7, 5), alpha)
    b = tsyn.zipf_indices(np.random.default_rng(3), 1000, (7, 5), alpha)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("alpha", [0.0, 1.05])
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_criteo_batch_bytes_identical(kind, reduced, alpha):
    j, t = _cfg_pair(kind, reduced)
    ids = np.array([0, 5, 17, 1023]) if not reduced else np.arange(0, 40, 3)
    a = jsyn.criteo_batch(j, 11, ids, zipf_alpha=alpha)
    b = tsyn.criteo_batch(t, 11, ids, zipf_alpha=alpha)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("steps,batch", [(20, 32), (7, 512), (3, 4),
                                         (17, 8), (1, 100)])
def test_sample_order_matches_single_worker_loader(steps, batch):
    svc = ShardingService(steps * batch, shard_size=max(batch * 8, 64))
    loader = ShardDataLoader(svc, "worker0", lambda idx: {"ids": idx},
                             batch_size=batch)
    ref = [b["ids"] for b in loader]
    got = list(sample_order(steps, batch))
    assert len(ref) == len(got) == steps
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)


def test_offsets_and_hot_ids_exact():
    assert tfe.table_offsets(ROWS) == jfe.table_offsets(ROWS)
    assert tfe.cache_slot_offsets(HOT) == jfe.cache_slot_offsets(HOT)
    offs = tfe.table_offsets(ROWS)
    for hot in (HOT, (0, 3, 0, 6), (0, 0, 0, 0)):
        a = jfe.hot_row_ids(offs, hot)
        b = tfe.hot_row_ids(offs, hot)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hot", [HOT, (0, 3, 0, 6), (64, 40, 96, 24)])
def test_encode_hot_indices_exact(hot):
    rng = np.random.default_rng(0)
    offs = np.asarray(tfe.table_offsets(ROWS))
    local = np.stack([rng.integers(0, r, (9, 3)) for r in ROWS], axis=1)
    flat = (local + offs[None, :, None]).astype(np.int32)
    je, jh = jfe.encode_hot_indices(jnp.asarray(flat), tuple(offs), hot)
    te, th = tfe.encode_hot_indices(torch.from_numpy(flat), tuple(offs), hot)
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    assert te.dtype == torch.int32


@pytest.mark.parametrize("ranges", RANGE_PLANS)
def test_padded_layout_geometry_and_translation_exact(ranges):
    jl = jpol.padded_layout_for_ranges(ranges)
    tl = tpol.padded_layout_for_ranges(ranges)
    for attr in ("n_ps", "max_range", "total_rows", "padded_rows",
                 "shard_starts", "shard_sizes"):
        assert getattr(jl, attr) == getattr(tl, attr), attr
    rows = np.arange(tl.total_rows)
    np.testing.assert_array_equal(jl.flat_to_padded(rows),
                                  tl.flat_to_padded(rows))
    np.testing.assert_array_equal(jl.row_translation(), tl.row_translation())
    np.testing.assert_array_equal(jfe.translate_rows_np(rows, jl),
                                  tl.flat_to_padded(rows))
    for dtype in (torch.int32, torch.int64):
        got = tfe.translate_rows(torch.as_tensor(rows, dtype=dtype), tl)
        assert got.dtype == dtype
        want = jfe.translate_rows(jnp.asarray(rows, jnp.int32), jl)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("ranges", RANGE_PLANS)
def test_pad_unpad_rows_match_reference(ranges):
    jl = jpol.padded_layout_for_ranges(ranges)
    tl = tpol.padded_layout_for_ranges(ranges)
    flat = np.random.default_rng(1).standard_normal(
        (tl.total_rows, 3)).astype(np.float32)
    jp = np.asarray(jl.pad_rows(jnp.asarray(flat)))
    tp = tl.pad_rows(torch.from_numpy(flat))
    np.testing.assert_array_equal(jp, tp.numpy())
    np.testing.assert_array_equal(tl.unpad_rows(tp).numpy(), flat)


def test_planners_match():
    for total, n in ((3_294_238, 4), (224, 3), (10, 4), (5, 1)):
        assert tpol.uniform_vocab_ranges(total, n) == \
            jpol.uniform_vocab_ranges(total, n)
    counts = np.random.default_rng(2).zipf(1.3, sum(ROWS)).astype(np.int64)
    counts[5:9] = 0
    for budget in (0, 7, 32, 500):
        assert tpol.pack_hot_ranges(counts, ROWS, budget) == \
            jpol.pack_hot_ranges(counts, ROWS, budget)
    with pytest.raises(AssertionError):
        tpol.padded_layout_for_ranges([(0, 4), (5, 9)])
    with pytest.raises(AssertionError):
        tpol.padded_layout_for_ranges([(1, 4)])


def test_embedding_plan_values():
    cfg = tcfg.reduced_dlrm(get_dlrm("wide_deep"))
    plan = cfg.embedding_plan(sparse_update=True)
    jplan = jcfg.reduced_dlrm(jcfg.WIDE_DEEP).embedding_plan(
        sparse_update=True)
    for attr in ("offsets", "combiner", "table_hot", "layout",
                 "sparse_update"):
        assert getattr(plan, attr) == getattr(jplan, attr), attr
    assert plan.with_combiner("max").combiner == "max"
    assert hash(plan) == hash(cfg.embedding_plan(sparse_update=True))
    with pytest.raises(ValueError):
        tpol.EmbeddingPlan(combiner="median")
    x = torch.ones(2)
    assert tpol.constrain(x, ("batch",)) is x


def test_kernel_constants_match():
    from repro.kernels import common as jcommon
    from repro_torch.kernels import common as tcommon
    assert tcommon.NEG_INF == jcommon.NEG_INF
    assert tcommon.MASK_VALUE == jcommon.MASK_VALUE
