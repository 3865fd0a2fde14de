"""Port parity: live re-planning, layout-stamped checkpoints, elastic resume.

The port's counterparts of ``tests/test_replan.py`` (the re-plan and its
restores) and ``tests/test_padded_layout.py`` (the padded re-plan, the
stamped flat/padded round trip, the resume onto another ``n_ps``). Within
the port a re-plan, a restore and a resume are bit-exact: forward losses,
resumed steps and moved rows are equal, not close. Against the reference,
the state movers are bit for bit on a carried state, and losses agree
within LOSS_ATOL (the two packages' f32 forwards differ by a few ULP).
Last, the launcher end to end with ``--replan-every`` and ``--resume``
against the reference launcher on the same flags.
"""
import dataclasses
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import jax_tree_to_np  # noqa: E402
from repro.configs import dlrm_models as jcfg  # noqa: E402
from repro.core import flash_checkpoint as jfc  # noqa: E402
from repro.data.synthetic import criteo_batch  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import dlrm as jdlrm  # noqa: E402
from repro.train import elastic as jelastic  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import replan as jreplan  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.configs import dlrm_models as tcfg  # noqa: E402
from repro_torch.configs.registry import get_dlrm  # noqa: E402
from repro_torch.core import flash_checkpoint as tfc  # noqa: E402
from repro_torch.core.sharding_service import HotTableTracker  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models.dlrm import dlrm_loss  # noqa: E402
from repro_torch.sharding.policy import (padded_layout_for_ranges,  # noqa: E402
                                         uniform_vocab_ranges)
from repro_torch.train import elastic, replan, state_tree  # noqa: E402
from repro_torch.train import optim, trainer  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

LOSS_ATOL = 2e-5
ROWS = 512
N_PS = 4
_KW = dict(table_rows=(ROWS,) * 6, zipf_alpha=1.05, hot_rows_k=48)
JCFG = dataclasses.replace(jcfg.reduced_dlrm(jcfg.WIDE_DEEP), **_KW)
CFG = dataclasses.replace(tcfg.reduced_dlrm(get_dlrm("wide_deep")), **_KW)
R = CFG.total_embedding_rows


def _batch(seed, lo, shift=0):
    """One criteo batch; ``shift`` rotates every table's ids (drifting skew)."""
    b = criteo_batch(JCFG, seed, np.arange(lo, lo + 256))
    if shift:
        b = dict(b, sparse=((b["sparse"].astype(np.int64) + shift) % ROWS
                            ).astype(b["sparse"].dtype))
    return b


def _tb(b):
    return launch.to_device(b, "cpu")


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _loss(params, b, table_hot=None, layout=None):
    plan = CFG.embedding_plan(table_hot=table_hot, layout=layout)
    return float(dlrm_loss(params, _tb(b), CFG, plan))


def _tracker():
    return HotTableTracker(CFG.table_rows, n_ps=N_PS,
                           hot_budget=CFG.hot_rows_k, decay=0.8,
                           trigger=1.2, cooldown=0, min_lookups=512)


def _drifted_decision(seed=3):
    t = _tracker()
    for i in range(6):
        t.observe(_batch(seed, 256 * i)["sparse"])
    d = t.maybe_replan()
    assert d is not None
    return d


def _jax_state(opt_name, key, layout=None, steps=1):
    """A reference train state carried ``steps`` dense steps (moments and
    adam's count are not zeros)."""
    opt = joptim.make(opt_name, 0.05)
    state = jtrainer.make_dlrm_train_state(JCFG, opt, jax.random.PRNGKey(key),
                                           layout=layout)
    step = jax.jit(jtrainer.make_dlrm_train_step(
        JCFG, opt, plan=JCFG.embedding_plan(layout=layout)))
    for i in range(steps):
        state, _ = step(state, _jb(_batch(17, 256 * i)))
    return state


def _assert_trees_equal(tstate, jstate):
    got = tfc._flatten(state_tree.to_tree(tstate))
    want = {jax.tree_util.keystr(p): np.asarray(l) for p, l in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def _port_state(jstate):
    return state_tree.from_tree(jax_tree_to_np(jstate), "cpu")


# --------------------------------------------------------- the state movers
@pytest.mark.parametrize("opt_name", ["adagrad", "adam"])
def test_state_movers_equal_the_reference(opt_name):
    d = _drifted_decision()
    old = padded_layout_for_ranges(uniform_vocab_ranges(R, N_PS))
    new = padded_layout_for_ranges(d.vocab_ranges)
    jold, jnew = (jreplan.padded_layout_for_ranges(x.ranges)
                  for x in (old, new))
    jflat = _jax_state(opt_name, 1)
    tflat = _port_state(jflat)
    jperm = jreplan.permute_train_state(jflat, R, d.permutation)
    tperm = replan.permute_train_state(tflat, R, d.permutation)
    _assert_trees_equal(tperm, jperm)
    jpad = jreplan.pad_train_state(jperm, R, jnew)
    tpad = replan.pad_train_state(tperm, R, new)
    _assert_trees_equal(tpad, jpad)
    _assert_trees_equal(replan.unpad_train_state(tpad, R, new),
                        jreplan.unpad_train_state(jpad, R, jnew))
    # a state carried on a padded layout moves the same way
    jp = _jax_state(opt_name, 2, layout=jold)
    _assert_trees_equal(replan.unpad_train_state(_port_state(jp), R, old),
                        jreplan.unpad_train_state(jp, R, jold))


def test_permute_train_state_touches_only_pooled_rows():
    opt = optim.adagrad(0.05)
    state = trainer.make_dlrm_train_state(CFG, opt,
                                          torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    perm = np.concatenate([o + rng.permutation(r) for o, r in
                           zip(CFG.table_offsets, CFG.table_rows)])
    out = replan.permute_train_state(state, R, perm)
    inv = torch.as_tensor(np.argsort(perm))
    for k in ("tables", "wide"):
        assert torch.equal(out["params"][k], state["params"][k][inv])
        assert torch.equal(out["opt"]["acc"][k], state["opt"]["acc"][k][inv])
        assert out["params"][k].data_ptr() != state["params"][k].data_ptr()
    assert out["params"]["mlp.w0"] is state["params"]["mlp.w0"]
    assert out["params"]["wide_dense"] is state["params"]["wide_dense"]
    assert out["step"] == state["step"]


def test_remapper_composes_and_rejects_out_of_range_ids():
    r = replan.EmbeddingRemapper((8, 8))
    jr = jreplan.EmbeddingRemapper((8, 8))
    p1 = np.array([1, 0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 15, 14])
    p2 = np.array([0, 2, 1, 3, 4, 5, 6, 7, 9, 8, 10, 11, 12, 13, 14, 15])
    for p in (p1, p2):
        r.compose(p)
        jr.compose(p)
    sparse = np.array([[[0, 1], [6, 7]]], np.int32)
    out = r.remap(sparse)
    np.testing.assert_array_equal(out[0, 0], [2, 0])
    np.testing.assert_array_equal(out[0, 1], [7, 6])
    assert out.dtype == sparse.dtype and r.n_plans == 2
    np.testing.assert_array_equal(out, jr.remap(sparse))
    bad = np.zeros((2, 2, 3), np.int64)
    bad[1, 1, 2] = 8
    with pytest.raises(ValueError, match=r"table 1 \(rows=8\)"):
        r.remap(bad)
    with pytest.raises(ValueError, match="out of range"):
        r.remap(-np.ones((1, 2, 1), np.int64))


# ------------------------------------------------------ bit-exact re-planning
@pytest.mark.parametrize("sparse", [False, True])
def test_replan_is_bit_exact_and_restores_across_plans(sparse):
    """Train, drift, re-plan: the permuted state, the resumed step, and an
    old-plan checkpoint restored onto the new plan give bit-identical
    losses; the old state stays valid. The pre-re-plan loss agrees with
    the reference on the same state."""
    opt = optim.adagrad(0.05)
    jstate = _jax_state("adagrad", 0, steps=0)
    state = _port_state(jstate)
    plan = CFG.embedding_plan(sparse_update=sparse)
    step_fn = trainer.make_dlrm_train_step(CFG, opt, plan=plan)
    tracker = _tracker()
    remapper = replan.EmbeddingRemapper(CFG.table_rows)
    jstep = jax.jit(jtrainer.make_dlrm_train_step(
        JCFG, joptim.adagrad(0.05),
        plan=JCFG.embedding_plan(sparse_update=sparse)))
    for i in range(3):
        b = _batch(7, 256 * i)
        tracker.observe(b["sparse"])
        state, m = step_fn(state, _tb(b))
        jstate, jm = jstep(jstate, _jb(b))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    shift = 157
    for i in range(6):
        tracker.observe(_batch(7, 2048 + 256 * i, shift=shift)["sparse"])
    decision = tracker.maybe_replan()
    assert decision is not None and decision.imbalance_before >= 1.2
    assert decision.imbalance_after <= 1.05

    probe = _batch(13, 10_000, shift=shift)
    loss_old = _loss(state["params"], probe)
    jloss = float(jdlrm.dlrm_loss(jstate["params"], _jb(probe), JCFG))
    assert abs(loss_old - jloss) <= LOSS_ATOL

    ckpt = tfc.FlashCheckpoint()
    snap_step = state["step"]
    replan.save_with_layout(ckpt, state, snap_step, remapper)
    res = replan.apply_replan(state, CFG, opt, decision, remapper=remapper,
                              plan=plan)
    tracker.mark_applied(decision)
    assert res.policy.vocab_ranges == decision.vocab_ranges
    assert res.plan == plan.with_replan(decision.table_hot, None)

    probe_new = remapper.remap_batch(probe)
    assert _loss(res.state["params"], probe_new,
                 decision.table_hot) == loss_old

    # one resumed step on each plan: equal loss, dense params and moved rows
    s_new, m_new = res.step_fn(res.state, _tb(probe_new))
    s_old, m_old = step_fn(state, _tb(probe))
    assert float(m_new["loss"]) == float(m_old["loss"])
    assert torch.equal(s_new["params"]["mlp.w0"], s_old["params"]["mlp.w0"])
    inv = torch.as_tensor(np.argsort(decision.permutation))
    for k in ("tables", "wide"):
        assert torch.equal(s_new["params"][k], s_old["params"][k][inv]), k
        assert torch.equal(s_new["opt"]["acc"][k],
                           s_old["opt"]["acc"][k][inv]), k

    # old-plan checkpoint -> new-plan state, still bit-exact
    state2, restored, step_fn2, policy2, remapper2 = replan.restore_on_plan(
        CFG, opt, "adagrad", ckpt, decision, device="cpu", plan=plan)
    assert restored == snap_step
    assert policy2.vocab_ranges == decision.vocab_ranges
    np.testing.assert_array_equal(remapper2.map, remapper.map)
    assert _loss(state2["params"], probe_new, decision.table_hot) == loss_old
    _, m2 = step_fn2(state2, _tb(probe_new))
    assert float(m2["loss"]) == float(m_old["loss"])


def test_layout_stamped_checkpoint_survives_process_restart():
    opt = optim.adagrad(0.05)
    state = trainer.make_dlrm_train_state(CFG, opt,
                                          torch.Generator().manual_seed(2))
    tracker = _tracker()
    remapper = replan.EmbeddingRemapper(CFG.table_rows)
    for i in range(6):
        tracker.observe(_batch(3, 256 * i)["sparse"])
    decision = tracker.maybe_replan()
    res = replan.apply_replan(state, CFG, opt, decision, remapper=remapper)
    tracker.mark_applied(decision)
    ckpt = tfc.FlashCheckpoint()
    for _ in range(2):                          # a re-save of the same step
        replan.save_with_layout(ckpt, res.state, 7, remapper,
                                decision.table_hot, decision.vocab_ranges)
    raw = _batch(13, 20_000)
    want = _loss(res.state["params"], remapper.remap_batch(raw),
                 decision.table_hot)
    state2, step2, remapper2, hot2, ranges2, layout2 = \
        replan.restore_with_layout(CFG, opt, ckpt, device="cpu")
    assert layout2 is None and step2 == 7 and state2["step"] == 0
    assert hot2 == decision.table_hot and ranges2 == decision.vocab_ranges
    np.testing.assert_array_equal(remapper2.map, remapper.map)
    assert _loss(state2["params"], remapper2.remap_batch(raw), hot2) == want
    t2 = HotTableTracker(CFG.table_rows, n_ps=N_PS, hot_budget=48, decay=0.8,
                         trigger=1.2, cooldown=0, min_lookups=512,
                         initial_ranges=ranges2, initial_hot=hot2)
    for i in range(4):
        t2.observe(remapper2.remap(_batch(3, 4096 + 256 * i)["sparse"]))
    assert t2.imbalance() < 1.1 and t2.maybe_replan() is None


# ----------------------------------------------------- padded physical shards
def test_replan_padded_job_matches_flat_replan_bit_exactly():
    opt = optim.adagrad(0.05)
    old_lay = padded_layout_for_ranges(uniform_vocab_ranges(R, N_PS))
    s_flat = trainer.make_dlrm_train_state(CFG, opt,
                                           torch.Generator().manual_seed(2))
    s_pad = replan.pad_train_state(s_flat, R, old_lay)
    decision = _drifted_decision()
    rm_flat = replan.EmbeddingRemapper(CFG.table_rows)
    rm_pad = replan.EmbeddingRemapper(CFG.table_rows)
    plan = CFG.embedding_plan(sparse_update=True)
    res_flat = replan.apply_replan(s_flat, CFG, opt, decision,
                                   remapper=rm_flat, plan=plan)
    res_pad = replan.apply_replan(s_pad, CFG, opt, decision, remapper=rm_pad,
                                  layout=old_lay,
                                  plan=plan.with_replan(None, old_lay))
    assert res_flat.layout is None
    assert res_pad.layout == padded_layout_for_ranges(decision.vocab_ranges)
    assert res_pad.layout.max_range > old_lay.max_range   # unequal ranges
    np.testing.assert_array_equal(
        res_pad.layout.padding_mask().sum(axis=1),
        [e - s for s, e in decision.vocab_ranges])
    probe = rm_flat.remap_batch(_batch(13, 10_000))
    loss_flat = _loss(res_flat.state["params"], probe, decision.table_hot)
    assert _loss(res_pad.state["params"], probe, decision.table_hot,
                 res_pad.layout) == loss_flat
    _, m_flat = res_flat.step_fn(res_flat.state, _tb(probe))
    _, m_pad = res_pad.step_fn(res_pad.state, _tb(probe))
    assert float(m_pad["loss"]) == float(m_flat["loss"])


def test_layout_stamped_checkpoint_roundtrips_flat_and_padded():
    opt = optim.adagrad(0.05)
    decision = _drifted_decision()
    lay = padded_layout_for_ranges(decision.vocab_ranges)
    s_flat = trainer.make_dlrm_train_state(CFG, opt,
                                           torch.Generator().manual_seed(4))
    s_flat = replan.permute_train_state(s_flat, R, decision.permutation)
    s_pad = replan.pad_train_state(s_flat, R, lay)
    remapper = replan.EmbeddingRemapper(CFG.table_rows)
    remapper.compose(decision.permutation)
    ckpt = tfc.FlashCheckpoint()
    replan.save_with_layout(ckpt, s_pad, 5, remapper, decision.table_hot,
                            decision.vocab_ranges, layout=lay)
    state2, step2, rm2, hot2, ranges2, lay2 = replan.restore_with_layout(
        CFG, opt, ckpt, device="cpu")
    assert step2 == 5 and lay2 == lay
    assert hot2 == decision.table_hot and ranges2 == decision.vocab_ranges
    np.testing.assert_array_equal(rm2.map, remapper.map)
    _assert_trees_equal(state2, jax_tree_to_np(state_tree.to_tree(s_pad)))
    back = replan.unpad_train_state(state2, R, lay2)
    _assert_trees_equal(back, jax_tree_to_np(state_tree.to_tree(s_flat)))
    raw = _batch(13, 20_000)
    want = _loss(s_flat["params"], remapper.remap_batch(raw),
                 decision.table_hot)
    assert _loss(state2["params"], rm2.remap_batch(raw), hot2, lay2) == want


def test_elastic_resume_onto_different_n_ps():
    """A plain blob saved padded on 4 shards resumes onto 2 shards and onto
    the flat pool, and a stamped blob onto 2 shards, with equal losses; the
    same blob restores in the reference within LOSS_ATOL."""
    opt = optim.adagrad(0.05)
    lay4 = padded_layout_for_ranges(uniform_vocab_ranges(R, 4))
    lay2 = padded_layout_for_ranges(uniform_vocab_ranges(R, 2))
    state = trainer.make_dlrm_train_state(CFG, opt,
                                          torch.Generator().manual_seed(5),
                                          layout=lay4)
    b = _batch(11, 0)
    want = _loss(state["params"], b, layout=lay4)
    ckpt = tfc.FlashCheckpoint()
    elastic.save_for_elasticity(ckpt, state, 3)
    s2, step2, _ = elastic.resume_dlrm_on_mesh(
        CFG, opt, "adagrad", ckpt, None, device="cpu", from_layout=lay4,
        layout=lay2)
    assert step2 == 3
    assert tuple(s2["params"]["tables"].shape[:2]) == (2, lay2.max_range)
    assert _loss(s2["params"], b, layout=lay2) == want
    s3, _, _ = elastic.resume_dlrm_on_mesh(
        CFG, opt, "adagrad", ckpt, None, device="cpu", from_layout=lay4)
    assert s3["params"]["tables"].shape[0] == R
    assert _loss(s3["params"], b) == want
    jck = jfc.FlashCheckpoint()
    jck._mem, jck._mem_order = ckpt._mem, ckpt._mem_order
    js, _, _ = jelastic.resume_dlrm_on_mesh(
        JCFG, joptim.adagrad(0.05), "adagrad", jck, None,
        from_layout=jreplan.padded_layout_for_ranges(lay4.ranges))
    jwant = float(jdlrm.dlrm_loss(js["params"], _jb(b), JCFG))
    assert abs(jwant - want) <= LOSS_ATOL

    remapper = replan.EmbeddingRemapper(CFG.table_rows)
    replan.save_with_layout(ckpt, state, 4, remapper, layout=lay4)
    s4, step4, rm4, hot4, ranges4, lay = elastic.resume_dlrm_stamped(
        CFG, opt, ckpt, device="cpu", onto_n_ps=2)
    assert step4 == 4 and lay == lay2 and hot4 is None
    assert ranges4 == tuple(uniform_vocab_ranges(R, 2))
    assert _loss(s4["params"], rm4.remap_batch(b), hot4, lay) == want
    with pytest.raises(ValueError, match="GSPMD"):
        elastic.resume_dlrm_stamped(CFG, opt, ckpt, device="cpu",
                                    mesh=object())


# ------------------------------------------------------- the launcher, e2e
FLAGS = ["--arch", "wide_deep", "--fused-update", "--padded-shards",
         "--replan-every", "5", "--ckpt-every", "5"]


def _run_reference(argv, monkeypatch, capsys):
    """The reference launcher's ``train_dlrm`` on ``argv``; its per-step
    losses are read off the jitted train steps it builds."""
    losses = []
    real_jit, real_make = jax.jit, jtrainer.make_dlrm_train_step

    def make(*a, **k):
        fn = real_make(*a, **k)
        fn.records_loss = True
        return fn

    def jit(fn, *a, **k):
        compiled = real_jit(fn, *a, **k)
        if not getattr(fn, "records_loss", False):
            return compiled

        def run(*args):
            out = compiled(*args)
            losses.append(float(out[1]["loss"]))
            return out
        return run

    monkeypatch.setattr(jax, "jit", jit)
    monkeypatch.setattr(jtrainer, "make_dlrm_train_step", make)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jlaunch.main()
    monkeypatch.undo()
    return losses, capsys.readouterr().out


def _replan_lines(out):
    return [re.sub(r"\s+", " ", line) for line in out.splitlines()
            if "RE-PLAN" in line or line.startswith("resumed from")]


def test_launcher_replans_and_resumes_like_the_reference(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    small = jcfg.reduced_dlrm(jcfg.WIDE_DEEP)      # the launcher's config
    jl = jreplan.padded_layout_for_ranges(
        uniform_vocab_ranges(small.total_embedding_rows, N_PS))
    jinit = jtrainer.make_dlrm_train_state(small, joptim.adagrad(3e-3),
                                           jax.random.PRNGKey(0), layout=jl)

    jlosses, jout = _run_reference(FLAGS + ["--steps", "12", "--ckpt-dir",
                                            jdir], monkeypatch, capsys)
    run = launch.train_dlrm(launch.build_parser().parse_args(
        FLAGS + ["--steps", "12", "--ckpt-dir", tdir, "--device", "cpu"]),
        state=_port_state(jinit))
    tout = capsys.readouterr().out
    assert len(run.losses) == len(jlosses) == 12
    np.testing.assert_allclose(run.losses, jlosses, rtol=0, atol=LOSS_ATOL)
    assert [d.observed_at for d in run.decisions] == [5]
    assert _replan_lines(tout) == _replan_lines(jout)
    assert "step     5 RE-PLAN" in tout and run.exactly_once
    assert run.layout == padded_layout_for_ranges(
        run.decisions[0].vocab_ranges)
    assert "checkpointed at step 12" in tout

    jlosses2, jout2 = _run_reference(
        FLAGS + ["--steps", "6", "--ckpt-dir", jdir, "--resume"],
        monkeypatch, capsys)
    run2 = launch.main(FLAGS + ["--steps", "6", "--ckpt-dir", tdir,
                                "--device", "cpu", "--resume"])
    tout2 = capsys.readouterr().out
    assert run2.restored_step == 12 and run2.state["step"] == 18
    assert run2.layout == run.layout and run2.plan == run.plan
    np.testing.assert_allclose(run2.losses, jlosses2, rtol=0,
                               atol=LOSS_ATOL)
    assert _replan_lines(tout2) == _replan_lines(jout2)
    # n=5 of the resumed run is global step 17; the final blob is 18
    assert tfc.FlashCheckpoint(tdir).valid_steps() == [17, 18]
