"""LM training of the MoE, SSM, hybrid and enc-dec archs against the
reference, on the CPU.

granite-moe-1b-a400m, mixtral-8x22b, mamba2-2.7b, recurrentgemma-2b and
whisper-medium at ``reduce_config`` (f32): the loss and every gradient leaf against
``jax.value_and_grad(api.loss, remat=True)``, three adamw steps of
``trainer.make_train_step`` against the reference's jitted step, the eval
step against ``api.loss`` and the reference's eval step, and ``remat``
exact. Bounds in ``tests/_torch_lm_train.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_lm_train as lmt  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "mixtral-8x22b", "mamba2-2.7b",
         "recurrentgemma-2b", "whisper-medium"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    lmt.check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    lmt.check_train_steps(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_is_the_loss(arch):
    lmt.check_eval_step(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_exact(arch):
    lmt.check_remat_is_exact(arch)
