"""Port parity: 20-step DLRM loss trajectories, and the launcher end to end.

Both packages start from the JAX ``init_dlrm`` params (seed 0, through
``params_from_jax``) and train on the same ``criteo_batch`` batches in the
launcher's sample order, with the hot-row cache on (64 rows). Cells:
Wide&Deep × {adagrad, adam} × {dense, fused sparse update} × {flat,
padded}, plus one cell each for DCN and xDeepFM.

Tolerance: every step's loss within 2e-5 absolute of the reference (f32
sums in another order drift by a few ULP per step), and the final pooled
stores within 1e-4 absolute. Within the port, the sparse adagrad step equals
the dense one bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import jax_tree_to_np, to_np  # noqa: E402
from repro.configs import dlrm_models as jcfg  # noqa: E402
from repro.data.synthetic import criteo_batch  # noqa: E402
from repro.sharding import policy as jpol  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.configs import dlrm_models as tcfg  # noqa: E402
from repro_torch.configs.registry import get_dlrm  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models.dlrm import params_from_jax  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

STEPS = 20
LR = 3e-3
LOSS_ATOL = 2e-5
POOL_ATOL = 1e-4
N_PS = 4


def _cfgs(kind):
    j = {"wide_deep": jcfg.WIDE_DEEP, "xdeepfm": jcfg.XDEEPFM,
         "dcn": jcfg.DCN}[kind]
    kw = dict(zipf_alpha=1.05, hot_rows_k=64)
    return (dataclasses.replace(jcfg.reduced_dlrm(j), **kw),
            dataclasses.replace(tcfg.reduced_dlrm(get_dlrm(kind)), **kw))


def _layouts(cfg, padded):
    if not padded:
        return None, None
    ranges = tpol.uniform_vocab_ranges(cfg.total_embedding_rows, N_PS)
    return (jpol.padded_layout_for_ranges(ranges),
            tpol.padded_layout_for_ranges(ranges))


def _batches(cfg):
    return [criteo_batch(cfg, launch.DATA_SEED, ids)
            for ids in launch.sample_order(STEPS, cfg.batch_size)]


def _jax_run(jc, jl, opt_name, sparse, batches):
    opt = joptim.make(opt_name, LR)
    state = jtrainer.make_dlrm_train_state(jc, opt, jax.random.PRNGKey(0),
                                           layout=jl)
    init = jax_tree_to_np(state["params"])
    step = jax.jit(jtrainer.make_dlrm_train_step(
        jc, opt, plan=jc.embedding_plan(layout=jl, sparse_update=sparse)))
    losses = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return init, losses, jax_tree_to_np(state["params"])


def _torch_run(tc, tl, init, opt_name, sparse, batches):
    opt = toptim.make(opt_name, LR)
    params = params_from_jax(tc, init, "cpu")
    state = {"params": params, "opt": opt.init(params), "step": 0}
    step = ttrainer.make_dlrm_train_step(
        tc, opt, plan=tc.embedding_plan(layout=tl, sparse_update=sparse))
    losses = []
    for b in batches:
        state, m = step(state, launch.to_device(b, "cpu"))
        losses.append(float(m["loss"]))
    return losses, state


def _assert_trajectory(tlosses, jlosses, tstate, jparams):
    assert len(tlosses) == len(jlosses) == STEPS
    assert np.isfinite(tlosses).all()
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(to_np(tstate["params"]["tables"]),
                               jparams["tables"], rtol=0, atol=POOL_ATOL)
    assert tstate["step"] == STEPS


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("opt_name", ["adagrad", "adam"])
def test_wide_deep_trajectory(opt_name, sparse, padded):
    jc, tc = _cfgs("wide_deep")
    jl, tl = _layouts(tc, padded)
    batches = _batches(jc)
    init, jlosses, jparams = _jax_run(jc, jl, opt_name, sparse, batches)
    tlosses, tstate = _torch_run(tc, tl, init, opt_name, sparse, batches)
    _assert_trajectory(tlosses, jlosses, tstate, jparams)


@pytest.mark.parametrize("kind,opt_name,sparse,padded", [
    ("dcn", "adagrad", True, True),
    ("xdeepfm", "adam", True, False),
])
def test_other_kinds_trajectory(kind, opt_name, sparse, padded):
    jc, tc = _cfgs(kind)
    jl, tl = _layouts(tc, padded)
    batches = _batches(jc)
    init, jlosses, jparams = _jax_run(jc, jl, opt_name, sparse, batches)
    tlosses, tstate = _torch_run(tc, tl, init, opt_name, sparse, batches)
    _assert_trajectory(tlosses, jlosses, tstate, jparams)


def test_sparse_adagrad_step_equals_dense_step_bit_for_bit():
    jc, tc = _cfgs("wide_deep")
    _, tl = _layouts(tc, True)
    init = jax_tree_to_np(jtrainer.make_dlrm_train_state(
        jc, joptim.make("adagrad", LR), jax.random.PRNGKey(0),
        layout=_layouts(tc, True)[0])["params"])
    batches = _batches(jc)[:5]
    _, dense = _torch_run(tc, tl, init, "adagrad", False, batches)
    _, sparse = _torch_run(tc, tl, init, "adagrad", True, batches)
    for k in ("tables", "wide"):
        assert torch.equal(dense["params"][k], sparse["params"][k]), k
        assert torch.equal(dense["opt"]["acc"][k], sparse["opt"]["acc"][k]), k


def test_launcher_runs_the_slice_like_the_reference(capsys):
    """``train_dlrm`` on the CPU (fused update, padded, hot rows) from the
    reference's initial state follows the reference's trajectory."""
    jc, tc = _cfgs("wide_deep")
    jl, tl = _layouts(tc, True)
    batches = _batches(jc)
    init, jlosses, jparams = _jax_run(jc, jl, "adagrad", True, batches)
    params = params_from_jax(tc, init, "cpu")
    opt = toptim.make("adagrad", LR)
    args = launch.build_parser().parse_args(
        ["--arch", "wide_deep", "--steps", str(STEPS), "--fused-update",
         "--padded-shards", "--device", "cpu"])
    run = launch.train_dlrm(
        args, state={"params": params, "opt": opt.init(params), "step": 0})
    lines = capsys.readouterr().out.splitlines()
    assert run.plan.sparse_update and run.plan.layout == tl
    assert run.cfg.table_hot == tc.table_hot
    _assert_trajectory(run.losses, jlosses, run.state, jparams)
    assert any(line.startswith("step     1 loss=") for line in lines)
    assert any(line.startswith("step    20 loss=") for line in lines)
