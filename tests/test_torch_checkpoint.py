"""Port parity: the flash checkpoint and the train-state tree.

``repro_torch.core.flash_checkpoint`` keeps the reference's on-disk schema
(``leaves.npz`` + ``MANIFEST.json`` with per-leaf CRC32, keystr leaf names,
the atomic commit): round trips, keep-eviction, and the newest-valid
fallback over a fixed set of damage cases; a missing leaf raises unless
named optional; a memory-tier snapshot does not follow in-place updates of
the live tensors. ``save_with_layout`` blobs written by either package
restore in the other, flat and padded: the restored leaves are bit-identical
and the forward losses agree within LOSS_ATOL (the two packages' f32
forwards differ by a few ULP).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import flatten_jax_tree, jax_tree_to_np  # noqa: E402
from repro.configs import dlrm_models as jcfg  # noqa: E402
from repro.core import flash_checkpoint as jfc  # noqa: E402
from repro.core import sharding_service as jss  # noqa: E402
from repro.data.synthetic import criteo_batch  # noqa: E402
from repro.models import dlrm as jdlrm  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import replan as jreplan  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.configs import dlrm_models as tcfg  # noqa: E402
from repro_torch.configs.registry import get_dlrm  # noqa: E402
from repro_torch.core import flash_checkpoint as tfc  # noqa: E402
from repro_torch.core import sharding_service as tss  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import dlrm as tdlrm  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import replan as treplan  # noqa: E402
from repro_torch.train import state_tree  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

LOSS_ATOL = 2e-5
N_PS = 4


def _state(x: float):
    return {"w": np.full(16, x, np.float32), "b": np.arange(4.0)}


def _dirname(step: int) -> str:
    return f"ckpt_{step:012d}"


@pytest.fixture()
def store(tmp_path):
    return tfc.FlashCheckpoint(str(tmp_path), keep=3,
                               async_persist=False), str(tmp_path)


# -------------------------------------------------------------------- basics
def test_save_restore_round_trip_and_schema(store):
    ck, d = store
    ck.save({"w": torch.full((16,), 1.5), "n": {"b": np.arange(4.0)}}, 10)
    manifest = json.load(open(os.path.join(d, _dirname(10), "MANIFEST.json")))
    assert manifest["format"] == 1 and manifest["step"] == 10
    assert manifest["leaves"]["['n']['b']"]["dtype"] == "float64"
    assert manifest["leaves"]["['w']"]["shape"] == [16]
    with np.load(os.path.join(d, _dirname(10), "leaves.npz")) as z:
        assert sorted(z.files) == ["['n']['b']", "['w']"]
    like = {"w": tfc.LeafSpec((16,), np.float32),
            "n": {"b": tfc.LeafSpec((4,), np.float64)}}
    for tier in ("memory", "disk"):
        if tier == "disk":
            ck.drop_memory_tier()
        restored, step = ck.restore(like)
        assert step == 10
        np.testing.assert_array_equal(restored["w"], np.full(16, 1.5))
        np.testing.assert_array_equal(restored["n"]["b"], np.arange(4.0))
    assert tfc.keystr(("state", "opt", 0)) == "['state']['opt'][0]"
    assert not [n for n in os.listdir(d) if ".tmp-" in n]


def test_eviction_keeps_newest_in_both_tiers(store):
    ck, d = store
    for s in (5, 10, 15, 20, 25):
        ck.save(_state(s), s)
    assert ck.valid_steps() == [15, 20, 25]     # keep=3
    ck.save(_state(15), 15)                     # a re-save refreshes recency
    ck.save(_state(30), 30)
    assert sorted(ck._mem) == [15, 25, 30]
    assert ck.latest_step() == 30


def test_async_persist_waits(tmp_path):
    ck = tfc.FlashCheckpoint(str(tmp_path), keep=2, async_persist=True)
    for s in (5, 10):
        ck.save(_state(s), s)
    ck.wait()
    ck.drop_memory_tier()
    _, step = ck.restore(_state(0.0))
    assert step == 10 and ck.last_persist_seconds > 0


def _flip(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _extra_leaf(path):
    manifest = json.load(open(path))
    manifest["leaves"]["['extra']"] = {"crc32": 0, "shape": [1],
                                       "dtype": "float32"}
    json.dump(manifest, open(path, "w"))


# the damage done to the newest blob (step 15) -> the event it must log
DAMAGE = {
    "corrupt": (lambda p: _flip(os.path.join(p, "leaves.npz")),
                "corrupt_blob_fallback"),
    "truncated": (lambda p: _truncate(os.path.join(p, "leaves.npz")),
                  "corrupt_blob_fallback"),
    "corrupt-manifest": (lambda p: _flip(os.path.join(p, "MANIFEST.json")),
                         "corrupt_blob_fallback"),
    "leaf-set-mismatch": (lambda p: _extra_leaf(
        os.path.join(p, "MANIFEST.json")), "corrupt_blob_fallback"),
    "torn-staging": (lambda p: os.replace(p, p + ".tmp-1"),
                     "skip_staging_dir"),
    "missing-manifest": (lambda p: os.remove(os.path.join(p,
                                                          "MANIFEST.json")),
                         "skip_missing_manifest"),
    "malformed-name": (lambda p: os.replace(p, p + "x"), "skip_malformed"),
}


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_newest_valid_fallback(store, damage):
    ck, d = store
    for s in (5, 10, 15):
        ck.save(_state(s), s)
    ck.drop_memory_tier()
    hurt, event = DAMAGE[damage]
    hurt(os.path.join(d, _dirname(15)))
    os.makedirs(os.path.join(d, "ckpt_garbage"))
    restored, step = ck.restore(_state(0.0))
    assert step == 10
    np.testing.assert_array_equal(restored["w"], _state(10)["w"])
    kinds = {e["kind"] for e in ck.events}
    assert event in kinds and "skip_malformed" in kinds
    assert ck.valid_steps() == [5, 10]
    # the reference reads the same directory the same way
    jck = jfc.FlashCheckpoint(d, keep=3, async_persist=False)
    jrestored, jstep = jck.restore(_state(0.0))
    assert jstep == 10
    np.testing.assert_array_equal(np.asarray(jrestored["w"]), restored["w"])
    if damage in ("corrupt", "truncated", "leaf-set-mismatch",
                  "corrupt-manifest"):
        with pytest.raises(tfc.CheckpointCorruptError):
            ck.restore(_state(0.0), step=15)    # asked for that exact blob
    ck.save(_state(20), 20)                     # eviction survives them
    assert ck.valid_steps() == [10, 20] or ck.valid_steps() == [5, 10, 20]


def test_all_corrupt_raises_and_memory_tier_shadows_disk(store):
    ck, d = store
    ck.save(_state(3.0), 5)
    _flip(os.path.join(d, _dirname(5), "leaves.npz"))
    restored, step = ck.restore(_state(0.0))    # memory intact
    assert step == 5
    np.testing.assert_array_equal(restored["w"], _state(3.0)["w"])
    ck.drop_memory_tier()
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        ck.restore(_state(0.0))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tfc.FlashCheckpoint().restore(_state(0.0))


def test_legacy_npz_blob_still_restores(store):
    ck, d = store
    flat = {"['w']": _state(7.0)["w"], "['b']": _state(7.0)["b"]}
    np.savez(os.path.join(d, "ckpt_000000000007.npz"), **flat)
    restored, step = ck.restore(_state(0.0))
    assert step == 7
    np.testing.assert_array_equal(restored["w"], _state(7.0)["w"])


def test_missing_leaf_raises_unless_optional(store):
    ck, _ = store
    ck.save({"w": np.ones(4)}, 5)
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore({"w": np.zeros(4), "extra": np.zeros(2)})
    like = {"w": np.zeros(4), "extra": tfc.LeafSpec((2,), torch.float32)}
    restored, _ = ck.restore(like, optional_leaves=("['extra']",))
    assert restored["extra"].dtype == np.float32
    np.testing.assert_array_equal(restored["extra"], np.zeros(2))


def test_hooks_see_staging_then_the_committed_dir(tmp_path):
    calls = []
    ck = tfc.FlashCheckpoint(
        str(tmp_path), async_persist=False,
        pre_commit_hook=lambda tmp, s: calls.append(
            ("pre", os.path.basename(tmp), s)),
        fault_hook=lambda final, s: calls.append(
            ("post", os.path.basename(final), os.path.isdir(final))))
    ck.save(_state(1.0), 7)
    assert calls == [("pre", f"{_dirname(7)}.tmp-{os.getpid()}", 7),
                     ("post", _dirname(7), True)]
    ck.note("restore_fallback", step=7)
    assert ck.events[-1]["kind"] == "restore_fallback"


def test_snapshot_does_not_follow_in_place_updates(store):
    """The fused sparse step updates pools in place; a snapshot must not."""
    ck, _ = store
    live = {"pool": torch.arange(8.0).reshape(4, 2), "n": np.arange(3)}
    ck.save(live, 1)
    live["pool"].add_(100.0)
    live["n"] += 7
    restored, _ = ck.restore(live)
    np.testing.assert_array_equal(restored["pool"],
                                  np.arange(8.0).reshape(4, 2))
    np.testing.assert_array_equal(restored["n"], np.arange(3))
    # and a restored state does not write back into the memory tier
    state = state_tree.from_tree(
        {"params": {"tables": restored["pool"]}, "opt": {}, "step": 0}, "cpu")
    state["params"]["tables"].add_(1.0)
    again, _ = ck.restore(live)
    np.testing.assert_array_equal(again["pool"], np.arange(8.0).reshape(4, 2))


# ------------------------------------------------- the train-state tree
def _cfgs():
    kw = dict(table_rows=(300,) * 6, zipf_alpha=1.05, hot_rows_k=48)
    return (dataclasses.replace(jcfg.reduced_dlrm(jcfg.WIDE_DEEP), **kw),
            dataclasses.replace(tcfg.reduced_dlrm(get_dlrm("wide_deep")),
                                **kw))


def _decision(mod, cfg):
    t = mod.HotTableTracker(cfg.table_rows, n_ps=N_PS, hot_budget=48,
                            decay=0.8, trigger=1.2, cooldown=0,
                            min_lookups=512)
    for i in range(6):
        t.observe(criteo_batch(cfg, 3, np.arange(64 * i, 64 * i + 64))[
            "sparse"])
    d = t.maybe_replan()
    assert d is not None
    return d


@pytest.mark.parametrize("opt_name", ["adagrad", "adam"])
def test_state_tree_names_and_like_tree(opt_name):
    jc, tc = _cfgs()
    jstate = jtrainer.make_dlrm_train_state(jc, joptim.make(opt_name, 0.1),
                                            jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): (np.asarray(l).shape,
                                      np.asarray(l).dtype)
            for p, l in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    topt = toptim.make(opt_name, 0.1)
    tstate = ttrainer.make_dlrm_train_state(tc, topt,
                                            torch.Generator().manual_seed(0))
    tstate["step"] = 3
    got = {k: (v.shape, v.dtype) for k, v in tfc._flatten(
        state_tree.to_tree(tstate)).items()}
    assert got == want
    like = {tfc.keystr(p): (l.shape, np.dtype(l.dtype))
            for p, l in tfc._leaves_with_path(
                state_tree.like_tree(tc, topt), ())
            if isinstance(l, tfc.LeafSpec)}
    assert like == want
    back = state_tree.from_tree(jax_tree_to_np(state_tree.to_tree(tstate)),
                                "cpu")
    assert back["step"] == 3 and set(back["params"]) == set(tstate["params"])
    for k, v in tstate["params"].items():
        assert torch.equal(back["params"][k], v)


def _jloss(cfg, params, batch, table_hot, layout):
    return float(jdlrm.dlrm_loss(params, {k: jnp.asarray(v)
                                          for k, v in batch.items()},
                                 cfg, table_hot=table_hot, layout=layout))


def _tloss(cfg, params, batch, table_hot, layout):
    plan = cfg.embedding_plan(table_hot=table_hot, layout=layout)
    return float(tdlrm.dlrm_loss(params, launch.to_device(batch, "cpu"), cfg,
                                 plan))


@pytest.mark.parametrize("padded", [False, True])
def test_reference_blob_restores_in_the_port(tmp_path, padded):
    jc, tc = _cfgs()
    opt = joptim.adagrad(0.05)
    d = _decision(jss, jc)
    jl = jreplan.padded_layout_for_ranges(
        jreplan.uniform_vocab_ranges(jc.total_embedding_rows, N_PS))
    state = jtrainer.make_dlrm_train_state(jc, opt, jax.random.PRNGKey(4),
                                           layout=jl if padded else None)
    rm = jreplan.EmbeddingRemapper(jc.table_rows)
    res = jreplan.apply_replan(state, jc, opt, d, remapper=rm,
                               layout=jl if padded else None)
    jck = jfc.FlashCheckpoint(str(tmp_path), async_persist=False)
    jreplan.save_with_layout(jck, res.state, 9, rm, d.table_hot,
                             d.vocab_ranges, layout=res.layout)

    tck = tfc.FlashCheckpoint(str(tmp_path))
    st, step, trm, hot, ranges, lay = treplan.restore_with_layout(
        tc, toptim.adagrad(0.05), tck, device="cpu")
    assert step == 9 and hot == d.table_hot and ranges == d.vocab_ranges
    np.testing.assert_array_equal(trm.map, rm.map)
    assert (lay is None) == (not padded)
    if padded:
        assert lay.ranges == res.layout.ranges
    want = flatten_jax_tree(jax_tree_to_np(res.state["params"]))
    assert set(st["params"]) == set(want)
    for k, v in want.items():
        assert np.array_equal(st["params"][k].numpy(), v), k
    for k, v in flatten_jax_tree(jax_tree_to_np(res.state["opt"]["acc"])
                                 ).items():
        assert np.array_equal(st["opt"]["acc"][k].numpy(), v), k
    raw = criteo_batch(jc, 13, np.arange(20_000, 20_064))
    b = rm.remap_batch(raw)
    jloss = _jloss(jc, res.state["params"], b, d.table_hot, res.layout)
    tloss = _tloss(tc, st["params"], trm.remap_batch(raw), hot, lay)
    assert abs(tloss - jloss) <= LOSS_ATOL


@pytest.mark.parametrize("padded", [False, True])
def test_port_blob_restores_in_the_reference(tmp_path, padded):
    jc, tc = _cfgs()
    topt = toptim.adam(0.05)
    d = _decision(tss, tc)
    tl = tpol.padded_layout_for_ranges(
        tpol.uniform_vocab_ranges(tc.total_embedding_rows, N_PS))
    state = ttrainer.make_dlrm_train_state(
        tc, topt, torch.Generator().manual_seed(4),
        layout=tl if padded else None)
    # carry the state one fused step, so moments and count are not zeros
    step = ttrainer.make_dlrm_train_step(
        tc, topt, plan=tc.embedding_plan(layout=tl if padded else None,
                                         sparse_update=True))
    state, _ = step(state, launch.to_device(
        criteo_batch(tc, 5, np.arange(64)), "cpu"))
    rm = treplan.EmbeddingRemapper(tc.table_rows)
    res = treplan.apply_replan(state, tc, topt, d, remapper=rm,
                               layout=tl if padded else None)
    tck = tfc.FlashCheckpoint(str(tmp_path), async_persist=False)
    treplan.save_with_layout(tck, res.state, 11, rm, d.table_hot,
                             d.vocab_ranges, layout=res.layout)

    jck = jfc.FlashCheckpoint(str(tmp_path))
    jst, step, jrm, hot, ranges, jlay = jreplan.restore_with_layout(
        jc, joptim.adam(0.05), jck)
    assert step == 11 and hot == d.table_hot and ranges == d.vocab_ranges
    np.testing.assert_array_equal(jrm.map, rm.map)
    assert (jlay is None) == (not padded)
    want = tfc._flatten(state_tree.to_tree(res.state))
    got = {jax.tree_util.keystr(p): np.asarray(l) for p, l in
           jax.tree_util.tree_flatten_with_path(jst)[0]}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    raw = criteo_batch(jc, 13, np.arange(20_000, 20_064))
    tloss = _tloss(tc, res.state["params"], rm.remap_batch(raw), d.table_hot,
                   res.layout)
    jloss = _jloss(jc, jst["params"], jrm.remap_batch(raw), hot, jlay)
    assert abs(tloss - jloss) <= LOSS_ATOL
