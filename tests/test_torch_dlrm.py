"""Port parity: DLRM init, logits, loss, AUC and gradients for all three kinds.

The JAX ``init_dlrm`` params enter the port through ``params_from_jax``, the
same ``criteo_batch`` goes to both, and the reference runs ``impl="xla"``.
Tolerances: logits within 2e-5 absolute + 1e-5 relative (f32 matmuls that
sum in another order), loss within 1e-6 relative, AUC exact (a count of
ordered pairs), gradients within 1e-5 absolute + 1e-4 relative.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import flatten_jax_tree, jax_tree_to_np, to_np  # noqa: E402
from repro.configs import dlrm_models as jcfg  # noqa: E402
from repro.data.synthetic import criteo_batch  # noqa: E402
from repro.models import dlrm as jdlrm  # noqa: E402
from repro.sharding import policy as jpol  # noqa: E402
from repro_torch.configs import dlrm_models as tcfg  # noqa: E402
from repro_torch.configs.registry import get_dlrm  # noqa: E402
from repro_torch.launch.train import to_device  # noqa: E402
from repro_torch.models import dlrm as tdlrm  # noqa: E402
from repro_torch.models.common import dense_init  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

KINDS = ("wide_deep", "xdeepfm", "dcn")
LOGIT_TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs(kind, pooling="sum"):
    j = {"wide_deep": jcfg.WIDE_DEEP, "xdeepfm": jcfg.XDEEPFM,
         "dcn": jcfg.DCN}[kind]
    j = dataclasses.replace(jcfg.reduced_dlrm(j), zipf_alpha=1.05,
                            hot_rows_k=12, pooling=pooling)
    t = dataclasses.replace(tcfg.reduced_dlrm(get_dlrm(kind)),
                            zipf_alpha=1.05, hot_rows_k=12, pooling=pooling)
    return j, t


def _layouts(cfg, padded):
    if not padded:
        return None, None
    ranges = [(0, 100), (100, 150), (150, cfg.total_embedding_rows)]
    return (jpol.padded_layout_for_ranges(ranges),
            tpol.padded_layout_for_ranges(ranges))


def _setup(kind, padded, pooling="sum", seed=0):
    jc, tc = _cfgs(kind, pooling)
    jl, tl = _layouts(tc, padded)
    jparams = jdlrm.init_dlrm(jc, jax.random.PRNGKey(seed), layout=jl)
    tparams = tdlrm.params_from_jax(tc, jax_tree_to_np(jparams), "cpu")
    batch = criteo_batch(jc, 11, np.arange(jc.batch_size))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = to_device(batch, "cpu")
    return (jc, jl, jparams, jb), (tc, tl, tparams, tb)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_logits_loss_auc_match(kind, padded):
    (jc, jl, jp, jb), (tc, tl, tp, tb) = _setup(kind, padded)
    jplan = jc.embedding_plan(layout=jl)
    tplan = tc.embedding_plan(layout=tl)
    want = jdlrm.dlrm_forward(jp, jb, jc, plan=jplan)
    got = tdlrm.dlrm_forward(tp, tb, tc, tplan)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(
        float(tdlrm.dlrm_loss(tp, tb, tc, tplan)),
        float(jdlrm.dlrm_loss(jp, jb, jc, plan=jplan)), rtol=1e-6)
    assert float(tdlrm.dlrm_auc(tp, tb, tc, tplan)) == \
        float(jdlrm.dlrm_auc(jp, jb, jc, plan=jplan))


@pytest.mark.parametrize("pooling", ["mean", "max"])
@pytest.mark.parametrize("kind", KINDS)
def test_other_poolings_match(kind, pooling):
    (jc, jl, jp, jb), (tc, tl, tp, tb) = _setup(kind, True, pooling, seed=1)
    want = jdlrm.dlrm_forward(jp, jb, jc, plan=jc.embedding_plan(layout=jl))
    got = tdlrm.dlrm_forward(tp, tb, tc, tc.embedding_plan(layout=tl))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_grads_match(kind, padded):
    (jc, jl, jp, jb), (tc, tl, tp, tb) = _setup(kind, padded, seed=2)
    jplan = jc.embedding_plan(layout=jl)
    jg = jax.grad(lambda p: jdlrm.dlrm_loss(p, jb, jc, plan=jplan))(jp)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tdlrm.dlrm_loss(leaves, tb, tc, tc.embedding_plan(layout=tl)).backward()
    want = flatten_jax_tree(jg)
    assert set(want) == set(leaves)
    for k, w in want.items():
        np.testing.assert_allclose(to_np(leaves[k].grad), w, err_msg=k,
                                   **GRAD_TOL)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_init_names_shapes_and_padding(kind, padded):
    jc, tc = _cfgs(kind)
    jl, tl = _layouts(tc, padded)
    jp = flatten_jax_tree(jdlrm.init_dlrm(jc, jax.random.PRNGKey(0),
                                          layout=jl))
    tp = tdlrm.init_dlrm(tc, torch.Generator().manual_seed(0), layout=tl)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert tp[k].dtype == torch.float32, k
    assert tdlrm.sparse_param_keys(tc) == jdlrm.sparse_param_keys(jc)
    if padded:   # padded init holds the flat init's rows, zero padding
        flat = tdlrm.init_dlrm(tc, torch.Generator().manual_seed(0))
        assert torch.equal(tl.unpad_rows(tp["tables"]), flat["tables"])
        assert int((tp["tables"] != 0).any(-1).sum()) == \
            tc.total_embedding_rows


def test_dense_init_draws_the_reference_distribution():
    """N(0, 1/fan_in), from the given generator, on its device."""
    w = dense_init(torch.Generator().manual_seed(0), (2048, 64), 2048)
    assert w.dtype == torch.float32 and w.device.type == "cpu"
    assert abs(float(w.std()) * 2048 ** 0.5 - 1.0) < 0.02
    assert abs(float(w.mean())) < 1e-3
    again = dense_init(torch.Generator().manual_seed(0), (2048, 64), 2048)
    assert torch.equal(w, again)


def test_params_from_jax_rejects_wrong_trees():
    jc, tc = _cfgs("dcn")
    jp = jax_tree_to_np(jdlrm.init_dlrm(jc, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="do not match"):
        tdlrm.params_from_jax(_cfgs("wide_deep")[1], jp, "cpu")
    del jp["cross_b"]
    with pytest.raises(ValueError, match="do not match"):
        tdlrm.params_from_jax(tc, jp, "cpu")
