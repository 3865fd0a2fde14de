"""The MoE block and the MoE archs of the LM zoo against the reference, on
the CPU.

``moe_block``: the same routing as the reference's (the experts chosen,
each pair's capacity slot and which pairs are dropped, integers compared
with ``==``), the same outputs and the same Switch aux loss, with and
without capacity drops; and the port against the dense oracle of
``tests/test_moe.py`` (every expert on every token, no dispatch) when the
capacity drops nothing. Then granite-moe-1b-a400m and mixtral-8x22b (local
attention) at ``reduce_config`` (f32) through ``tests/_torch_zoo.py``.

Tolerances: outputs within 1e-5 (f32, the same products in another order);
the dense oracle within its own test's 1e-4; the aux loss within 1e-6.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_zoo as zoo  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models.common import KeyGen  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from test_moe import _dense_oracle  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "mixtral-8x22b"]


def _cfg(E=4, k=2, d=16, ff=32, cf=8.0, act="silu"):
    return JModelConfig(
        name="moe-test", family="moe", num_layers=1, d_model=d, n_heads=2,
        n_kv_heads=1, d_ff=ff, vocab_size=64, n_experts=E, top_k=k,
        capacity_factor=cf, activation=act, param_dtype="float32",
        compute_dtype="float32")


def _jax_routing(p, x, cfg):
    """The reference's dispatch plan: the lines of ``moe_block``
    (``repro/models/mlp.py:87-114``) up to the expert FFNs."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    P = S * k
    logits = jnp.einsum("gsd,de->gse", x.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    top_g, top_i = jax.lax.top_k(probs, k)
    cap = int(max(k, (S * k * cfg.capacity_factor) / E))
    cap = min(((cap + 7) // 8) * 8, P)
    pair_e = top_i.reshape(B, P)
    pair_t = jnp.broadcast_to(jnp.repeat(jnp.arange(S), k)[None, :], (B, P))
    order = jnp.argsort(pair_e, axis=1)
    inv_order = jnp.argsort(order, axis=1)
    se = jnp.take_along_axis(pair_e, order, axis=1)
    st = jnp.take_along_axis(pair_t, order, axis=1)
    counts = jnp.sum(pair_e[:, :, None] == jnp.arange(E)[None, None], axis=1)
    starts = jnp.cumsum(counts, axis=1) - counts
    slot = jnp.arange(P)[None, :] - jnp.take_along_axis(starts, se, axis=1)
    pos = jnp.where(slot < cap, se * cap + slot, E * cap)
    idx_ec = starts[:, :, None] + jnp.arange(cap)[None, None, :]
    valid_ec = jnp.arange(cap)[None, None, :] < counts[:, :, None]
    idx_flat = jnp.clip(idx_ec.reshape(B, E * cap), 0, P - 1)
    tok_at = jnp.take_along_axis(st, idx_flat, axis=1)
    return {"top_i": top_i, "cap": cap, "pos": pos, "inv_order": inv_order,
            "tok_at": tok_at, "valid_ec": valid_ec.reshape(B, E * cap)}


def _setup(cfg, seed, B, S):
    p, _ = jmlp.init_moe(KeyGen(jax.random.PRNGKey(seed)), cfg, jnp.float32)
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    return p, x, tp, zoo.port_cfg(cfg)


# E, k, capacity factor, B, S, activation: drops where the capacity is
# below the busiest expert's load
MOE_CASES = {
    "no-drops": (4, 2, 4.0, 2, 9, "silu"),
    "drops": (4, 2, 0.25, 2, 32, "silu"),
    "drops-gelu-top1": (8, 1, 0.5, 3, 64, "gelu"),
    "granite-like": (32, 8, 1.25, 1, 16, "silu"),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block_matches_reference(case):
    E, k, cf, B, S, act = MOE_CASES[case]
    cfg = _cfg(E=E, k=k, cf=cf, act=act)
    p, x, tp, tcfg = _setup(cfg, 5, B, S)
    want_route = jax.jit(functools.partial(_jax_routing, cfg=cfg))(
        p, jnp.asarray(x))
    got_route = tmlp.moe_route(tp, torch.from_numpy(x), tcfg)
    assert got_route["cap"] == want_route["cap"]
    for key in ("top_i", "pos", "inv_order", "tok_at", "valid_ec"):
        np.testing.assert_array_equal(got_route[key].numpy(),
                                      np.asarray(want_route[key]),
                                      err_msg=key)
    dropped = int((got_route["pos"] == E * got_route["cap"]).sum())
    assert (dropped > 0) == case.startswith("drops"), dropped
    want, want_aux = jax.jit(functools.partial(jmlp.moe_block, cfg=cfg))(
        p, jnp.asarray(x))
    got, aux = tmlp.moe_block(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("E,k,act", [(4, 2, "silu"), (8, 1, "gelu"),
                                     (2, 2, "silu")])
def test_moe_block_matches_dense_oracle_without_drops(E, k, act):
    cfg = _cfg(E=E, k=k, cf=float(E), act=act)
    p, x, tp, tcfg = _setup(cfg, 11, 3, 9)
    got, _ = tmlp.moe_block(tp, torch.from_numpy(x), tcfg)
    want = jax.jit(functools.partial(_dense_oracle, cfg=cfg))(
        p, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_moe_capacity_is_static_and_drops_shrink_the_output():
    cfg = _cfg(E=4, k=2, cf=8.0)
    p, x, tp, tcfg = _setup(cfg, 0, 2, 32)
    tight = dataclasses.replace(tcfg, capacity_factor=0.25)
    assert tmlp.moe_capacity(32, tight) == 8 and \
        tmlp.moe_capacity(32, tcfg) == 64
    full, _ = tmlp.moe_block(tp, torch.from_numpy(x), tcfg)
    drop, _ = tmlp.moe_block(tp, torch.from_numpy(x), tight)
    assert float(drop.norm()) < float(full.norm())


def test_init_moe_router_stays_f32():
    cfg = zoo.port_cfg(_cfg())
    p = tmlp.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert {p[k].dtype for k in ("w1", "w2", "w3")} == {torch.bfloat16}


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
