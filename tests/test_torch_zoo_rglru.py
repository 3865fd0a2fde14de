"""The RG-LRU block and the recurrentgemma arch of the LM zoo against the
reference, on the CPU.

``rglru_forward`` with and without an initial state (the port's log-depth
scan against the reference's ``associative_scan``), ``rglru_decode`` from a
filled cache, ``linear_scan`` against the sequential recurrence, then
recurrentgemma-2b at ``reduce_config`` (f32; recurrent, recurrent, local
with a 16-slot window, so 20 tokens wrap the ring) through
``tests/_torch_zoo.py``.

Tolerances: block outputs within the logits' 3e-5 / 1e-5; the final state
within 2e-5 / 1e-5 (two scan orders, about 2 log2(L) f32 roundings of
each term apart; see ``models/rglru.py``).
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
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.common import KeyGen  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402

ARCH = "recurrentgemma-2b"


def _cfg():
    return jbase.reduce_config(JARCHS[ARCH])


def _params(jcfg, seed=3):
    p, _ = jrglru.init_rglru(KeyGen(jax.random.PRNGKey(seed)), jcfg,
                             jnp.float32)
    rng = np.random.default_rng(seed)
    p = dict(p)
    for name in ("gate_a_b", "gate_i_b", "conv_b"):
        p[name] = p[name] + 0.3 * rng.standard_normal(p[name].shape).astype(
            np.float32)
    return p, {k: torch.tensor(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("L,with_h0", [(20, False), (33, False), (20, True),
                                       (1, True)])
def test_rglru_forward_matches_reference(L, with_h0):
    jcfg = _cfg()
    p, tp = _params(jcfg)
    rng = np.random.default_rng(L)
    x = rng.standard_normal((2, L, jcfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((2, jcfg.lru_width)).astype(np.float32) \
        if with_h0 else None
    fwd = jax.jit(lambda p, x, h0: jrglru.rglru_forward(p, x, jcfg, h0=h0))
    want, want_h = fwd(p, jnp.asarray(x),
                       None if h0 is None else jnp.asarray(h0))
    got, got_h = trglru.rglru_forward(
        tp, torch.from_numpy(x), zoo.port_cfg(jcfg),
        h0=None if h0 is None else torch.from_numpy(h0))
    zoo.close(got, want, "rglru_forward out")
    zoo.close(got_h, want_h, "final h", zoo.CACHE_ATOL, zoo.CACHE_RTOL)


def test_rglru_decode_matches_reference():
    jcfg = _cfg()
    cfg = zoo.port_cfg(jcfg)
    p, tp = _params(jcfg, seed=5)
    rng = np.random.default_rng(6)
    conv = rng.standard_normal((2, trglru.CONV_W - 1,
                                jcfg.lru_width)).astype(np.float32)
    h = rng.standard_normal((2, jcfg.lru_width)).astype(np.float32)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    want, want_cache = jax.jit(functools.partial(jrglru.rglru_decode,
                                                 cfg=jcfg))(
        p, jnp.asarray(x), {"conv": jnp.asarray(conv), "h": jnp.asarray(h)})
    cache = {"conv": torch.from_numpy(conv.copy()),
             "h": torch.from_numpy(h.copy())}
    got, got_cache = trglru.rglru_decode(tp, torch.from_numpy(x), cache, cfg)
    assert got_cache is cache
    zoo.close(got, want, "rglru_decode out")
    for k in ("conv", "h"):
        zoo.close(cache[k], want_cache[k], f"cache {k}", zoo.CACHE_ATOL,
                  zoo.CACHE_RTOL)


@pytest.mark.parametrize("L", [1, 2, 7, 64])
def test_linear_scan_is_the_recurrence(L):
    rng = np.random.default_rng(L)
    a = rng.uniform(0.5, 1.0, (2, L, 5)).astype(np.float32)
    b = rng.standard_normal((2, L, 5)).astype(np.float32)
    h = np.zeros((2, 5), np.float32)
    want = []
    for t in range(L):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = trglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), atol=1e-5,
                               rtol=1e-5)


def test_init_rglru_keeps_reference_dtypes():
    cfg = zoo.port_cfg(_cfg())
    p = trglru.init_rglru(torch.Generator().manual_seed(0), cfg,
                          torch.bfloat16)
    assert {k for k, v in p.items() if v.dtype == torch.float32} == \
        {"gate_a_w", "gate_a_b", "gate_i_w", "gate_i_b", "lam"}


def test_forward_and_loss_match_reference():
    zoo.check_forward_and_loss(ARCH)


def test_prefill_and_decode_match_reference():
    zoo.check_prefill_and_decode(ARCH)


def test_port_decode_matches_port_forward():
    zoo.check_decode_matches_own_forward(ARCH)


def test_params_from_jax_names_shapes_dtypes():
    zoo.check_params_from_jax(ARCH)
