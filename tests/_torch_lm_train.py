"""Shared checks of the LM training parity tests
(``tests/test_torch_lm_train*.py``).

Each arch runs at ``reduce_config`` of its reference config (f32), from
the reference's params loaded through ``params_from_jax``
(``tests/_torch_zoo.setup``). Reference calls are wrapped in ``jax.jit``.

Bounds: the loss within 1e-5 relative of ``jax.value_and_grad(api.loss,
remat=True)``; every gradient leaf within ``‖Δ‖ ≤ 1e-4 ‖g‖``; three adamw
steps of ``make_train_step`` against the reference's jitted step, loss and
``grad_norm`` within 1e-4 relative at every step (f32 rounding of the same
math in another order, carried through three updates). ``remat=True``
equals ``remat=False`` bit for bit on the CPU: the recomputation repeats
the same operations.
"""
import functools

import numpy as np
import torch

import _torch_zoo as zoo
import jax
import jax.numpy as jnp

from repro.data.synthetic import lm_batch as jlm_batch
from repro.models.registry import build_model as jbuild
from repro.train import optim as joptim
from repro.train import trainer as jtrainer
from repro_torch.models import encdec as tencdec
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.train import optim as toptim
from repro_torch.train import trainer as ttrainer

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STEP_RTOL = 1e-4
N_STEPS = 3
LR = 3e-3


def unstack(cfg, np_tree):
    """A reference params-shaped tree (numpy leaves) in the port's layout."""
    mod = tencdec if cfg.family == "encdec" else ttf
    return mod.unstack_params(cfg, np_tree)


def to_np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def step_batches(cfg, inputs, n=N_STEPS):
    """``n`` (reference, port) batch pairs of ``lm_batch`` samples (2 per
    step, the zoo's sequence length), with the zoo's frames for the
    enc-dec."""
    B, S = inputs["tokens"].shape
    out = []
    for i in range(n):
        b = jlm_batch(0, np.arange(i * B, (i + 1) * B), S, cfg.vocab_size)
        if "frames" in inputs:
            b["frames"] = inputs["frames"]
        out.append(({k: jnp.asarray(v) for k, v in b.items()},
                    {k: torch.from_numpy(v) for k, v in b.items()}))
    return out


@functools.lru_cache(maxsize=None)
def reference_loss_and_grads(arch):
    jcfg, cfg, jparams, _, inputs = zoo.setup(arch)
    japi = jbuild(jcfg)
    jbatch, _ = zoo.batch_of(inputs, with_targets=True)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss(p, b, remat=True)))(jparams, jbatch)
    return float(loss), zoo._flatten(unstack(cfg, to_np_tree(grads)))


def check_loss_and_grads(arch):
    _, cfg, _, tparams, inputs = zoo.setup(arch)
    api = treg.build_model(cfg)
    _, tbatch = zoo.batch_of(inputs, with_targets=True)
    want_loss, want = reference_loss_and_grads(arch)
    loss, grads = ttrainer.loss_and_grads(api, tparams, tbatch, remat=True)
    assert rel(loss, want_loss) <= LOSS_RTOL, (arch, float(loss), want_loss)
    got = zoo._flatten(grads)
    assert set(got) == set(want)
    for name, g in want.items():
        g = g.astype(np.float64)
        d = got[name].numpy().astype(np.float64) - g
        assert got[name].dtype == torch.float32, (name, got[name].dtype)
        assert np.linalg.norm(d) <= GRAD_REL * np.linalg.norm(g), (
            arch, name, np.linalg.norm(d), np.linalg.norm(g))


def check_remat_is_exact(arch):
    _, cfg, _, tparams, inputs = zoo.setup(arch)
    api = treg.build_model(cfg)
    _, tbatch = zoo.batch_of(inputs, with_targets=True)
    l1, g1 = ttrainer.loss_and_grads(api, tparams, tbatch, remat=True)
    l0, g0 = ttrainer.loss_and_grads(api, tparams, tbatch, remat=False)
    assert torch.equal(l1, l0)
    f1, f0 = zoo._flatten(g1), zoo._flatten(g0)
    assert set(f1) == set(f0)
    for name in f0:
        assert torch.equal(f1[name], f0[name]), (arch, name)


def check_eval_step(arch):
    jcfg, cfg, jparams, tparams, inputs = zoo.setup(arch)
    api = treg.build_model(cfg)
    jbatch, tbatch = zoo.batch_of(inputs, with_targets=True)
    state = {"params": tparams, "opt": {}, "step": 0}
    got = ttrainer.make_eval_step(api)(state, tbatch)
    assert not got.requires_grad
    assert torch.equal(got, api.loss(tparams, tbatch))
    want = jax.jit(jtrainer.make_eval_step(jbuild(jcfg)))(
        {"params": jparams}, jbatch)
    assert rel(got, want) <= LOSS_RTOL, (arch, float(got), float(want))


def check_train_steps(arch, grad_compress=False):
    """``N_STEPS`` adamw steps of the port against the reference's jitted
    ``make_train_step`` from the same params, on the same batches."""
    jcfg, cfg, jparams, tparams, inputs = zoo.setup(arch)
    japi, tapi = jbuild(jcfg), treg.build_model(cfg)
    jopt, topt = joptim.adamw(LR), toptim.adamw(LR)
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tparams, "opt": topt.init(tparams), "step": 0}
    jstep = jax.jit(jtrainer.make_train_step(japi, jopt, remat=True,
                                             grad_compress=grad_compress))
    tstep = ttrainer.make_train_step(tapi, topt, remat=True,
                                     grad_compress=grad_compress)
    for i, (jb, tb) in enumerate(step_batches(cfg, inputs)):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        for key in ("loss", "grad_norm"):
            assert rel(tm[key], jm[key]) <= STEP_RTOL, (
                arch, i, key, float(tm[key]), float(jm[key]))
    assert tstate["step"] == int(jstate["step"]) == N_STEPS
    assert int(tstate["opt"]["count"]) == int(jstate["opt"]["count"])
