"""LM checkpoints, resume and the launcher's LM mode, on the CPU.

A ``FlashCheckpoint`` blob of an LM train state written by either package
restores in the other (the layer lists stacked into the reference's
``pattern``/``rest``, or ``enc``/``dec``, and back), bit for bit, and the
next step's loss agrees within the train-step bound; ``resume_on_mesh``
restores onto a device and refuses a mesh; a bfloat16 state goes through
the disk tier bit for bit, in the reference's on-disk form; the restore
template equals the saved tree's shapes and dtypes; ``unstack_params``
refuses a tree of another structure.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_lm_train as lmt  # noqa: E402
import _torch_zoo as zoo  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.flash_checkpoint import FlashCheckpoint as JCheckpoint  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.core.flash_checkpoint import (FlashCheckpoint,  # noqa: E402
                                               host_dtype)
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.train import elastic, state_tree  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

def _after_one_step(arch):
    """Both packages' states after one adamw step from the same params, and
    the batches of steps 1 and 2."""
    jcfg, cfg, jparams, tparams, inputs = zoo.setup(arch)
    japi, tapi = jbuild(jcfg), treg.build_model(cfg)
    jopt, topt = joptim.adamw(lmt.LR), toptim.adamw(lmt.LR)
    batches = lmt.step_batches(cfg, inputs, n=2)
    jstep = jax.jit(jtrainer.make_train_step(japi, jopt, remat=True))
    tstep = ttrainer.make_train_step(tapi, topt, remat=True)
    jstate, _ = jstep({"params": jparams, "opt": jopt.init(jparams),
                       "step": jnp.zeros((), jnp.int32)}, batches[0][0])
    tstate, _ = tstep({"params": tparams, "opt": topt.init(tparams),
                       "step": 0}, batches[0][1])
    return (jcfg, cfg, japi, tapi, jopt, topt, jstep, tstep, jstate, tstate,
            batches[1])


def _assert_tree_equal(got, want):
    got, want = zoo._flatten(got), zoo._flatten(want)
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("arch", ["llama3.2-3b", "recurrentgemma-2b",
                                  "whisper-medium"])
def test_port_blob_restores_in_reference(arch, tmp_path):
    (jcfg, cfg, japi, _, jopt, topt, jstep, tstep, _, tstate,
     (jb, tb)) = _after_one_step(arch)
    ck = FlashCheckpoint(str(tmp_path))
    ck.save(state_tree.lm_to_tree(tstate, cfg), 1)
    ck.wait()
    like = jax.eval_shape(lambda k: jtrainer.make_train_state(japi, jopt, k),
                          jax.random.PRNGKey(0))
    restored, step = JCheckpoint(str(tmp_path)).restore(like)
    assert step == 1 and int(restored["step"]) == 1
    _assert_tree_equal(
        lmt.unstack(cfg, jax.tree.map(np.asarray, restored["params"])),
        toptim.tree_map(lambda t: t.numpy(), tstate["params"]))
    _, jm = jstep(restored, jb)
    _, tm = tstep(tstate, tb)
    assert lmt.rel(tm["loss"], jm["loss"]) <= lmt.STEP_RTOL


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-2.7b",
                                  "whisper-medium"])
def test_reference_blob_restores_in_port(arch, tmp_path):
    (_, cfg, _, tapi, _, topt, jstep, tstep, jstate, _,
     (jb, tb)) = _after_one_step(arch)
    ck = JCheckpoint(str(tmp_path))
    ck.save(jstate, 1)
    ck.wait()
    restored, step, policy = elastic.resume_on_mesh(
        tapi, topt, "adamw", FlashCheckpoint(str(tmp_path)), None, None,
        device="cpu")
    assert step == 1 and restored["step"] == 1
    assert policy.vocab_ranges is None
    want = jax.tree.map(np.asarray, jstate)
    for name in ("m", "v"):
        _assert_tree_equal(toptim.tree_map(lambda t: t.numpy(),
                                           restored["opt"][name]),
                           lmt.unstack(cfg, want["opt"][name]))
    _, jm = jstep(jstate, jb)
    _, tm = tstep(restored, tb)
    assert lmt.rel(tm["loss"], jm["loss"]) <= lmt.STEP_RTOL


def test_resume_on_mesh_refuses_a_mesh(tmp_path):
    _, cfg, _, _, _ = zoo.setup("llama3.2-3b")
    with pytest.raises(ValueError, match="mesh"):
        elastic.resume_on_mesh(treg.build_model(cfg), toptim.adamw(lmt.LR),
                               "adamw", FlashCheckpoint(str(tmp_path)),
                               object(), None, device="cpu")


def _bf16_state(arch):
    _, cfg, _, tparams, _ = zoo.setup(arch)
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    api = treg.build_model(cfg)
    opt = toptim.adamw(lmt.LR)
    params = toptim.tree_map(lambda t: t.to(torch.bfloat16), tparams)
    return cfg, api, opt, {"params": params, "opt": opt.init(params),
                           "step": 7}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-medium"])
def test_bf16_state_round_trips_through_disk(arch, tmp_path):
    cfg, api, opt, state = _bf16_state(arch)
    ck = FlashCheckpoint(str(tmp_path))
    ck.save(state_tree.lm_to_tree(state, cfg), 7)
    ck.wait()
    restored, step, _ = elastic.resume_on_mesh(
        api, opt, "adamw", FlashCheckpoint(str(tmp_path)), None, None,
        device="cpu")
    assert step == 7 and restored["step"] == 7
    got, want = zoo._flatten(restored), zoo._flatten(state)
    assert set(got) == set(want)
    for k, w in want.items():
        if torch.is_tensor(w):
            assert got[k].dtype == w.dtype, k
            assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                               w.reshape(-1).view(torch.uint8)), k
    blob = tmp_path / "ckpt_000000000007"
    manifest = json.loads((blob / "MANIFEST.json").read_text())
    assert manifest["leaves"]["['params']['embed']"]["dtype"] == "bfloat16"
    # the reference writes its bfloat16 leaves the same way
    ref = tmp_path / "ref"
    ck = JCheckpoint(str(ref))
    ck.save({"x": jnp.asarray(state["params"]["embed"].float().numpy(),
                              jnp.bfloat16)}, 1)
    ck.wait()
    with np.load(blob / "leaves.npz") as ours, \
            np.load(ref / "ckpt_000000000001" / "leaves.npz") as theirs:
        assert ours["['params']['embed']"].dtype == theirs["['x']"].dtype
        assert ours["['params']['embed']"].tobytes() == \
            theirs["['x']"].tobytes()
    ref_manifest = json.loads(
        (ref / "ckpt_000000000001" / "MANIFEST.json").read_text())
    assert ref_manifest["leaves"]["['x']"]["dtype"] == "bfloat16"


@pytest.mark.parametrize("arch,dtype", [
    ("llama3.2-3b", "float32"), ("llama3.2-3b", "bfloat16"),
    ("recurrentgemma-2b", "float32"), ("whisper-medium", "bfloat16")])
def test_restore_template_matches_the_saved_tree(arch, dtype):
    if dtype == "bfloat16":
        cfg, api, opt, state = _bf16_state(arch)
    else:
        _, cfg, _, tparams, _ = zoo.setup(arch)
        api, opt = treg.build_model(cfg), toptim.adamw(lmt.LR)
        state = {"params": tparams, "opt": opt.init(tparams), "step": 0}
    like = zoo._flatten(state_tree.lm_like_tree(api, opt))
    tree = zoo._flatten(state_tree.lm_to_tree(state, cfg))
    assert set(like) == set(tree)
    for k, spec in like.items():
        assert spec.shape == tuple(tree[k].shape), k
        assert spec.dtype == host_dtype(tree[k].dtype), k


def test_unstack_params_refuses_a_wrong_tree():
    _, cfg, jparams, _, _ = zoo.setup("llama3.2-3b")
    tree = dict(jax.tree.map(np.asarray, jparams))
    tree["rest"] = list(tree["rest"]) + [{}]
    with pytest.raises(ValueError, match="rest layers"):
        ttf.unstack_params(cfg, tree)
    tree = dict(jax.tree.map(np.asarray, jparams), extra=np.zeros(1))
    with pytest.raises(ValueError, match="top-level keys"):
        ttf.unstack_params(cfg, tree)
