"""The LM slice of the port (configs, common blocks, MLP, transformer) against
the reference, on the CPU.

The reference's params (``repro.models.transformer.init_lm``) go to the port
through ``params_from_jax``; the same numpy tokens go through both. The
configs are ``reduce_config`` of the reference's archs (f32): llama3.2-3b
as it is, and gemma3-27b (qk-norm, embedding scale, GELU, a local rope
theta) cut to a local/global/local stack with an 8-slot window and a
softcap, so both attention kinds, the ring caches and the softcap run.

Tolerances: logits within 3e-5 absolute and 1e-5 relative (observed about
3e-6 at logits of magnitude 4: f32 rounding of the same math in another
order), the loss within 1e-5 relative; the port's own forward-vs-decode
check uses the reference's bound, rel < 2e-4.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401  (sets torch threads)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

LOGIT_ATOL, LOGIT_RTOL = 3e-5, 1e-5


def _port_cfg(jcfg) -> tbase.ModelConfig:
    """The port's ModelConfig with every field of a reference config."""
    return tbase.ModelConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(jcfg)})


VARIANTS = {
    "llama3.2-3b": lambda: jbase.reduce_config(JARCHS["llama3.2-3b"]),
    "gemma3-local-global-softcap": lambda: jbase.reduce_config(
        JARCHS["gemma3-27b"], layer_pattern=("local", "global"),
        num_layers=3, local_window=8, logit_softcap=5.0),
}


@functools.lru_cache(maxsize=None)
def _setup(variant):
    jcfg = VARIANTS[variant]()
    cfg = _port_cfg(jcfg)
    jparams = jax.jit(functools.partial(jtf.init_lm, jcfg))(
        jax.random.PRNGKey(1))
    tparams = ttf.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                  "cpu")
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    return jcfg, cfg, jparams, tparams, toks


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL, err_msg=msg)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_configs_match_reference():
    assert list(treg.ARCHS) == list(JARCHS)
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for name, jcfg in JARCHS.items():
        tcfg = treg.get_arch(name)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), name
        assert tcfg.layer_kinds == jcfg.layer_kinds, name
        assert tcfg.param_count() == jcfg.param_count(), name
        assert tcfg.param_count(active_only=True) == \
            jcfg.param_count(active_only=True), name
        assert dataclasses.asdict(tbase.reduce_config(tcfg)) == \
            dataclasses.asdict(jbase.reduce_config(jcfg)), name
        for shape in jbase.SHAPES.values():
            assert tbase.shape_applicable(tcfg, tbase.SHAPES[shape.name]) \
                == jbase.shape_applicable(jcfg, shape)
    for shape in jbase.SHAPES:
        assert dataclasses.asdict(treg.get_shape(shape)) == \
            dataclasses.asdict(jreg.get_shape(shape))
    assert treg.all_cells() == jreg.all_cells()
    for bad in (treg.get_arch, treg.get_shape):
        with pytest.raises(KeyError):
            bad("nope")


# ---------------------------------------------------------------------------
# common blocks and the MLP
# ---------------------------------------------------------------------------
def test_common_blocks_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w)), atol=1e-6,
        rtol=1e-6)
    np.testing.assert_allclose(tcommon.rope_frequencies(16, 5e5).numpy(),
                               jcommon.rope_frequencies(16, 5e5), rtol=1e-6)
    for positions in (np.arange(5) + 7, np.array([[3], [40]])):
        xx = x if positions.ndim == 1 else x[:, :1]
        np.testing.assert_allclose(
            tcommon.apply_rope(torch.from_numpy(xx),
                               torch.from_numpy(positions), 1e4).numpy(),
            jcommon.apply_rope(jnp.asarray(xx), jnp.asarray(positions), 1e4),
            atol=2e-6, rtol=1e-5)
    for act in ("silu", "gelu"):
        np.testing.assert_allclose(
            tcommon.act_fn(act)(torch.from_numpy(x)).numpy(),
            jcommon.act_fn(act)(jnp.asarray(x)), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        tcommon.softcap(torch.from_numpy(x), 2.0).numpy(),
        jcommon.softcap(jnp.asarray(x), 2.0), atol=1e-6, rtol=1e-6)
    assert tcommon.softcap(torch.from_numpy(x), 0.0) is not None
    for v in (1, 255, 256, 257, 128256):
        assert tcommon.pad_vocab(v) == jcommon.pad_vocab(v)
    for name, cfg in JARCHS.items():
        assert tcommon.pattern_split(_port_cfg(cfg)) == \
            jcommon.pattern_split(cfg), name
    assert tcommon.dtype_of("bfloat16") == torch.bfloat16


@pytest.mark.parametrize("activation,bias", [("silu", False), ("gelu", True)])
def test_mlp_block_matches_reference(activation, bias):
    jcfg = jbase.reduce_config(JARCHS["llama3.2-3b"], activation=activation,
                               mlp_bias=bias)
    p, _ = jmlp.init_mlp(jcommon.KeyGen(jax.random.PRNGKey(3)), jcfg,
                         jnp.float32)
    if bias:
        p = {k: v + 0.1 if k.startswith("b") else v for k, v in p.items()}
    x = np.random.default_rng(1).standard_normal((2, 4, 64)).astype(np.float32)
    got = tmlp.mlp_block({k: torch.tensor(np.asarray(v))
                          for k, v in p.items()}, torch.from_numpy(x),
                         _port_cfg(jcfg))
    np.testing.assert_allclose(got.numpy(), jmlp.mlp_block(p, jnp.asarray(x),
                                                           jcfg),
                               atol=1e-5, rtol=1e-5)
    names = set(tmlp.init_mlp(torch.Generator().manual_seed(0),
                              _port_cfg(jcfg), torch.float32))
    assert names == set(p)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def test_params_from_jax_unstacks_the_pattern_groups():
    jcfg, cfg, jparams, tparams, _ = _setup("gemma3-local-global-softcap")
    n_groups, pattern, rest = jcommon.pattern_split(jcfg)
    assert n_groups == 1 and rest == ("local",)
    assert len(tparams["layers"]) == jcfg.num_layers
    for g in range(n_groups):
        for i in range(len(pattern)):
            layer = tparams["layers"][g * len(pattern) + i]
            np.testing.assert_array_equal(
                layer["attn"]["wq"].numpy(),
                np.asarray(jparams["pattern"][i]["attn"]["wq"][g]))
    for j in range(len(rest)):
        np.testing.assert_array_equal(
            tparams["layers"][n_groups * len(pattern) + j]["mlp"]["w1"].numpy(),
            np.asarray(jparams["rest"][j]["mlp"]["w1"]))
    # the port's own init has the same names, shapes and dtypes
    own = ttf.init_lm(cfg, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in _flatten(own).items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in _flatten(tparams).items()}


def _flatten(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_params_from_jax_rejects_missing_and_extra_leaves():
    jcfg, cfg, jparams, _, _ = _setup("llama3.2-3b")
    tree = jax.tree.map(np.asarray, jparams)
    layer = dict(tree["pattern"][0])
    del layer["ln2"]
    missing = {**tree, "pattern": [layer]}
    with pytest.raises(ValueError, match="leaves"):
        ttf.params_from_jax(cfg, missing, "cpu")
    extra = {**tree, "lm_head": np.zeros((64, 256), np.float32)}
    with pytest.raises(ValueError, match="top-level"):
        ttf.params_from_jax(cfg, extra, "cpu")
    attn = {**tree["pattern"][0]["attn"], "bk": np.zeros((2, 2, 16))}
    extra_leaf = {**tree, "pattern": [{**tree["pattern"][0], "attn": attn}]}
    with pytest.raises(ValueError, match="leaves"):
        ttf.params_from_jax(cfg, extra_leaf, "cpu")
    bf16 = ttf.params_from_jax(dataclasses.replace(cfg, param_dtype="bfloat16"),
                               tree, "cpu")
    assert bf16["embed"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# forward, loss and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_and_loss_match_reference(variant):
    jcfg, cfg, jparams, tparams, toks = _setup(variant)
    want, _ = jax.jit(functools.partial(jtf.forward_lm, cfg=jcfg))(
        jparams, jnp.asarray(toks))
    got, aux = ttf.forward_lm(tparams, torch.from_numpy(toks), cfg)
    assert got.shape == want.shape and float(aux) == 0.0
    _close(got, want, "forward_lm logits")
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    jloss = jax.jit(functools.partial(jtf.lm_loss, cfg=jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss = ttf.lm_loss(tparams, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    api = build_model(cfg)
    assert torch.equal(api.prefill(tparams, {"tokens": torch.from_numpy(toks)}),
                       got)
    assert float(api.loss(tparams, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})) == float(tloss)


def _unstacked_caches(jcfg, jcache):
    n_groups, pattern, rest = jcommon.pattern_split(jcfg)
    out = []
    for g in range(n_groups):
        for i in range(len(pattern)):
            out.append({k: np.asarray(v[g])
                        for k, v in jcache["pattern"][i].items()})
    return out + [{k: np.asarray(v) for k, v in c.items()}
                  for c in jcache["rest"]]


@pytest.mark.parametrize("max_len", [20, 12])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_match_reference(variant, max_len):
    """Sequential decode through the caches. ``max_len`` 12 < 20 steps runs
    the global caches past their end (the write slot clamps to the last)
    and wraps the local rings."""
    jcfg, cfg, jparams, tparams, toks = _setup(variant)
    jcache = jtf.init_cache_lm(jcfg, 2, max_len, jnp.float32)
    jcache, want = jax.jit(functools.partial(jtf.prefill_into_cache,
                                             cfg=jcfg))(
        jparams, jcache, jnp.asarray(toks))
    tcache = ttf.init_cache_lm(cfg, 2, max_len, torch.float32, "cpu")
    tcache, got = ttf.prefill_into_cache(tparams, tcache,
                                         torch.from_numpy(toks), cfg)
    _close(got, want, "prefill logits")
    assert tcache["step"] == int(jcache["step"]) == toks.shape[1]
    for key in ("global_pos", "local_pos"):
        if key in jcache:
            np.testing.assert_array_equal(tcache[key].numpy(),
                                          np.asarray(jcache[key]))
    for n, (tc, jc) in enumerate(zip(tcache["layers"],
                                     _unstacked_caches(jcfg, jcache))):
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), jc[k], atol=2e-5,
                                       rtol=1e-5, err_msg=f"layer {n} {k}")
    # one more step through ModelAPI.decode_step
    nxt = np.array([[5], [7]], np.int32)
    want1, _ = jax.jit(functools.partial(jtf.decode_step_lm, cfg=jcfg))(
        jparams, jcache, jnp.asarray(nxt))
    got1, tcache = build_model(cfg).decode_step(tparams, tcache,
                                                torch.from_numpy(nxt))
    _close(got1, want1, "decode_step_lm logits")
    assert tcache["step"] == toks.shape[1] + 1


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_port_decode_matches_port_forward(variant):
    """The reference's consistency check, on the port alone: sequential
    decode reproduces the teacher-forced forward (rel < 2e-4)."""
    _, cfg, _, tparams, toks = _setup(variant)
    full, _ = ttf.forward_lm(tparams, torch.from_numpy(toks), cfg)
    cache = ttf.init_cache_lm(cfg, 2, toks.shape[1], torch.float32,
                              "cpu")
    _, seq = ttf.prefill_into_cache(tparams, cache, torch.from_numpy(toks),
                                    cfg)
    rel = float((full - seq).abs().max() / full.abs().max())
    assert rel < 2e-4, rel
