"""The launcher's LM mode and the port's quickstart example, on the CPU.

``repro_torch.launch.train --arch llama3.2-3b --steps 3 --batch 2 --seq 16
--device cpu``, started from the reference launcher's initial params,
prints the reference launcher's losses and ``done:`` line; a ``--resume``
run restores the saved state bit for bit and continues it (its first loss
is the saved state's step on samples 0 and 1, the stream restarting at
sample 0 as in the reference). ``examples/quickstart_torch.py`` runs at a
reduced size.
"""
import functools
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_zoo as zoo  # noqa: E402
import jax  # noqa: E402

from repro.configs.base import reduce_config as jreduce  # noqa: E402
from repro.configs.registry import get_arch as jget_arch  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.core.flash_checkpoint import FlashCheckpoint  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.train import state_tree  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _assert_tree_equal(got, want):
    got, want = zoo._flatten(got), zoo._flatten(want)
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), k


LAUNCH = ["--arch", "llama3.2-3b", "--steps", "3", "--batch", "2", "--seq",
          "16"]


def _printed(out):
    """(loss, gnorm) of the ``step 1`` line and the ``done:`` line."""
    step = next(l for l in out.splitlines() if l.startswith("step     1 "))
    loss = float(step.split("loss=")[1].split()[0])
    gnorm = float(step.split("gnorm=")[1].split()[0])
    done = next(l for l in out.splitlines() if l.startswith("done:"))
    return loss, gnorm, done


def _reference_initial_state():
    jcfg = jreduce(jget_arch("llama3.2-3b"))
    cfg = zoo.port_cfg(jcfg)
    jparams = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
    params = treg.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                  "cpu")
    return {"params": params, "opt": toptim.adamw(3e-3).init(params),
            "step": 0}


def test_launcher_lm_mode_matches_reference_launcher(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train"] + LAUNCH)
    jlaunch.main()
    want_loss, want_gnorm, want_done = _printed(capsys.readouterr().out)
    run = tlaunch.train_lm(tlaunch.build_parser().parse_args(
        LAUNCH + ["--device", "cpu"]), state=_reference_initial_state())
    loss, gnorm, done = _printed(capsys.readouterr().out)
    assert done == want_done == "done: 3 steps, exactly-once=True " \
        "(covered=6 dup=0)"
    # the reference prints 4 decimals of the loss and 3 of the norm
    assert abs(run.losses[0] - want_loss) <= 5e-5 + 1e-5 * want_loss
    assert abs(run.grad_norms[0] - want_gnorm) <= 5e-4 + 1e-4 * want_gnorm
    assert (loss, gnorm) == (want_loss, want_gnorm)
    assert len(run.losses) == 3 and run.state["step"] == 3
    assert run.exactly_once and (run.covered, run.dup) == (6, 0)


def test_launcher_resume_continues_the_saved_state(tmp_path):
    flags = LAUNCH + ["--device", "cpu", "--ckpt-dir", str(tmp_path),
                      "--ckpt-every", "2"]
    first = tlaunch.main(flags)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_000000000002",
                                            "ckpt_000000000003"]
    resumed = tlaunch.main(flags[:3] + ["2"] + flags[4:] + ["--resume"])
    assert resumed.restored_step == 3 and resumed.state["step"] == 5
    # the restored state is the saved one, bit for bit
    api, opt = first.api, first.opt
    tree, _ = FlashCheckpoint(str(tmp_path)).restore(
        state_tree.lm_like_tree(api, opt), 3)
    as_np = functools.partial(
        toptim.tree_map, lambda t: t.numpy() if torch.is_tensor(t) else t)
    _assert_tree_equal(
        as_np(state_tree.lm_from_tree(tree, first.cfg, "cpu")),
        as_np(first.state))
    # its first loss is the saved state's step on sample 0..1 (the stream
    # restarts at sample 0, as in the reference)
    batch = tlaunch.to_device(tlaunch.lm_batch(0, np.arange(2), 16,
                                               first.cfg.vocab_size), "cpu")
    _, m = ttrainer.make_train_step(api, opt)(first.state, batch)
    assert float(m["loss"]) == resumed.losses[0]


def test_quickstart_example_runs_on_cpu():
    path = ROOT / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    state, restored, losses, exact = mod.main(["--device", "cpu",
                                               "--samples", "96"])
    assert exact and len(losses) == 6 and state["step"] == 6
    assert all(np.isfinite(losses))
    assert restored["step"] == 6
    for k, v in zoo._flatten(state["params"]).items():
        assert torch.equal(zoo._flatten(restored["params"])[k], v), k


@pytest.mark.parametrize("flag", [["--chaos", "ps_loss@1"], ["--supervise"],
                                  ["--chaos-proc", "kill@1"]],
                         ids=lambda f: f[0].lstrip("-"))
def test_launcher_lm_mode_ignores_dlrm_only_flags(capsys, monkeypatch, flag):
    """``--chaos``, ``--supervise`` and ``--chaos-proc`` are DLRM modes: the
    reference's ``main`` dispatches them only for a DLRM arch and trains an
    LM as if they were absent; the port does the same."""
    argv = LAUNCH[:3] + ["2"] + LAUNCH[4:]
    monkeypatch.setattr(sys, "argv", ["train"] + argv + flag)
    assert jlaunch.main() is None
    out = capsys.readouterr().out
    assert "done: 2 steps, exactly-once=True" in out
    assert "CHAOS" not in out
    plain = tlaunch.main(argv + ["--device", "cpu"])
    flagged = tlaunch.main(argv + ["--device", "cpu"] + flag)
    assert isinstance(flagged, tlaunch.LMRun)
    assert len(flagged.losses) == 2 and flagged.state["step"] == 2
    assert flagged.losses == plain.losses
    assert flagged.grad_norms == plain.grad_norms
