"""The dense and VLM archs of the LM zoo against the reference, on the CPU.

minitron-8b, gemma3-27b (local/global pattern, qk-norm, embedding scale,
GELU), command-r-35b and chameleon-34b (qk-norm, untied head), each at
``reduce_config`` (f32): forward, loss, prefill and decode against the
reference, the port's decode against its own forward and the loaded params'
names, shapes and dtypes. Tolerances in ``tests/_torch_zoo.py``. Also
``common.layer_norm``, which no model calls.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_zoo as zoo  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import common as jcommon  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402

ARCHS = ["minitron-8b", "gemma3-27b", "command-r-35b", "chameleon-34b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    zoo.check_forward_and_loss(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    zoo.check_prefill_and_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_matches_port_forward(arch):
    zoo.check_decode_matches_own_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_names_shapes_dtypes(arch):
    zoo.check_params_from_jax(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 5, 48)) * 3 + 1).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    b = (0.1 * rng.standard_normal(48)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = tcommon.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                             torch.from_numpy(b))
    want = jcommon.layer_norm(jnp.asarray(x).astype(getattr(jnp, dtype)),
                              jnp.asarray(w), jnp.asarray(b))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 8e-3   # one bf16 step
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
