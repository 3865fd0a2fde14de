"""Mamba-2 SSD and the mamba2 arch of the LM zoo against the reference, on
the CPU.

``ssd_chunked`` (one chunk, several, and a length that is no multiple of
the chunk, which pads with dt = 0 steps), ``ssm_forward`` and
``ssm_decode`` from a filled cache, then mamba2-2.7b at ``reduce_config``
(f32) through ``tests/_torch_zoo.py``.

Tolerances: SSD outputs and states within 2e-5 absolute and 2e-5 relative
(the same f32 products, exponentials and cumulative sums in another
order), block outputs within the logits' 3e-5 / 1e-5.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_zoo as zoo  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import KeyGen  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

ARCH = "mamba2-2.7b"
SSD_TOL = 2e-5


def _cfg():
    return jbase.reduce_config(JARCHS[ARCH])


def _params(jcfg, seed=3):
    p, _ = jssm.init_ssm(KeyGen(jax.random.PRNGKey(seed)), jcfg, jnp.float32)
    # non-trivial dt_bias, D and norm weights
    rng = np.random.default_rng(seed)
    p = dict(p)
    for name in ("dt_bias", "D", "norm_w", "conv_b"):
        p[name] = p[name] + 0.2 * rng.standard_normal(p[name].shape).astype(
            np.float32)
    return p, {k: torch.tensor(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("L,chunk,G", [(16, 16, 1), (48, 16, 1),
                                       (37, 16, 1), (21, 8, 2)])
def test_ssd_chunked_matches_reference(L, chunk, G):
    rng = np.random.default_rng(L * 10 + chunk)
    B, H, P, N = 2, 4, 8, 6
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.linspace(0.5, 2.0, H).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, L, G, N)).astype(np.float32)
              for _ in range(2))
    want_y, want_s = jax.jit(functools.partial(jssm.ssd_chunked,
                                               chunk=chunk))(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    got_y, got_s = tssm.ssd_chunked(*(torch.from_numpy(a)
                                      for a in (x, dt, A, Bm, Cm)), chunk)
    assert got_y.shape == (B, L, H, P) and got_s.shape == (B, H, P, N)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=SSD_TOL, rtol=SSD_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=SSD_TOL, rtol=SSD_TOL)


@pytest.mark.parametrize("L", [16, 23])
def test_ssm_forward_matches_reference(L):
    jcfg = _cfg()
    p, tp = _params(jcfg)
    x = np.random.default_rng(L).standard_normal(
        (2, L, jcfg.d_model)).astype(np.float32)
    want = jax.jit(functools.partial(jssm.ssm_forward, cfg=jcfg))(
        p, jnp.asarray(x))
    got = tssm.ssm_forward(tp, torch.from_numpy(x), zoo.port_cfg(jcfg))
    zoo.close(got, want, "ssm_forward")


def test_ssm_decode_matches_reference():
    jcfg = _cfg()
    cfg = zoo.port_cfg(jcfg)
    p, tp = _params(jcfg, seed=4)
    rng = np.random.default_rng(9)
    conv = rng.standard_normal((2, jcfg.ssm_conv_width - 1,
                                jssm.conv_dim(jcfg))).astype(np.float32)
    state = rng.standard_normal((2, jcfg.ssm_nheads, jcfg.ssm_headdim,
                                 jcfg.ssm_state)).astype(np.float32)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    want, want_cache = jax.jit(functools.partial(jssm.ssm_decode, cfg=jcfg))(
        p, jnp.asarray(x), {"conv": jnp.asarray(conv),
                            "state": jnp.asarray(state)})
    cache = {"conv": torch.from_numpy(conv.copy()),
             "state": torch.from_numpy(state.copy())}
    got, got_cache = tssm.ssm_decode(tp, torch.from_numpy(x), cache, cfg)
    assert got_cache is cache
    zoo.close(got, want, "ssm_decode out")
    for k in ("conv", "state"):
        zoo.close(cache[k], want_cache[k], f"cache {k}", zoo.CACHE_ATOL,
                  zoo.CACHE_RTOL)
    fresh = tssm.init_ssm_cache(cfg, 3, torch.bfloat16, "cpu")
    assert fresh["conv"].dtype == torch.bfloat16 and \
        fresh["state"].dtype == torch.float32


def test_init_ssm_keeps_reference_dtypes():
    cfg = zoo.port_cfg(_cfg())
    p = tssm.init_ssm(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert {k for k, v in p.items() if v.dtype == torch.float32} == \
        {"dt_bias", "A_log", "D"}


def test_forward_and_loss_match_reference():
    zoo.check_forward_and_loss(ARCH)


def test_prefill_and_decode_match_reference():
    zoo.check_prefill_and_decode(ARCH)


def test_port_decode_matches_port_forward():
    zoo.check_decode_matches_own_forward(ARCH)


def test_params_from_jax_names_shapes_dtypes():
    zoo.check_params_from_jax(ARCH)
