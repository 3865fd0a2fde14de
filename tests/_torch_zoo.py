"""Shared checks of the LM zoo's parity tests (``tests/test_torch_zoo_*.py``).

Each arch runs at ``reduce_config`` of its reference config (f32). The
reference's params (its ``ModelAPI.init``) go to the port through
``params_from_jax``; the same numpy tokens (and, for the enc-dec, frames)
go through both. Reference calls are wrapped in ``jax.jit``.

Tolerances: logits within ``LOGIT_ATOL``/``LOGIT_RTOL`` of
``tests/test_torch_lm.py`` (f32 rounding of the same math in another
order), losses within 1e-5 relative, cache contents within 2e-5 absolute
and 1e-5 relative; the port's own decode against its own forward within
the reference's rel < 2e-4 (``tests/test_models_consistency.py``).
"""
import dataclasses
import functools

import numpy as np
import torch

import _torch_parity  # noqa: F401  (sets torch threads)
import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.configs.registry import ARCHS as JARCHS
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.models import transformer as jtf
from repro.models.registry import build_model as jbuild
from repro_torch.configs import base as tbase
from repro_torch.models import encdec as tencdec
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttf

jax.config.update("jax_platform_name", "cpu")

LOGIT_ATOL, LOGIT_RTOL = 3e-5, 1e-5
CACHE_ATOL, CACHE_RTOL = 2e-5, 1e-5
B, S = 2, 20


def port_cfg(jcfg) -> tbase.ModelConfig:
    """The port's ModelConfig with every field of a reference config."""
    return tbase.ModelConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(jcfg)})


def close(got, want, msg="", atol=LOGIT_ATOL, rtol=LOGIT_RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=msg)


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(jcfg, cfg, jparams, tparams, inputs) of ``arch`` reduced; inputs
    holds numpy ``tokens`` (B, S) and, for the enc-dec, ``frames``."""
    jcfg = jbase.reduce_config(JARCHS[arch])
    cfg = port_cfg(jcfg)
    jparams = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(1))
    tparams = treg.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                   "cpu")
    rng = np.random.default_rng(2)
    inputs = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
              .astype(np.int32)}
    if cfg.family == "encdec":
        inputs["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jparams, tparams, inputs


def batch_of(inputs, with_targets=False):
    batch = dict(inputs)
    if with_targets:
        batch["targets"] = np.roll(inputs["tokens"], -1, axis=1)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def unstacked_caches(jcfg, jcache):
    """The reference's per-layer caches in ``cfg.layer_kinds`` order."""
    n_groups, pattern, rest = jcommon.pattern_split(jcfg)
    out = []
    for g in range(n_groups):
        for i in range(len(pattern)):
            out.append({k: np.asarray(v[g])
                        for k, v in jcache["pattern"][i].items()})
    return out + [{k: np.asarray(v) for k, v in c.items()}
                  for c in jcache["rest"]]


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------
def check_forward_and_loss(arch):
    jcfg, cfg, jparams, tparams, inputs = setup(arch)
    api = treg.build_model(cfg)
    jbatch, tbatch = batch_of(inputs, with_targets=True)
    if cfg.family == "encdec":
        want = jax.jit(functools.partial(jencdec.forward_encdec, cfg=jcfg))(
            jparams, jbatch)
        got = tencdec.forward_encdec(tparams, tbatch, cfg)
        jloss = jax.jit(functools.partial(jencdec.encdec_loss, cfg=jcfg))(
            jparams, jbatch)
    else:
        want, want_aux = jax.jit(functools.partial(jtf.forward_lm, cfg=jcfg))(
            jparams, jbatch["tokens"])
        got, aux = ttf.forward_lm(tparams, tbatch["tokens"], cfg)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5,
                                   atol=1e-6, err_msg="router aux loss")
        jloss = jax.jit(functools.partial(jtf.lm_loss, cfg=jcfg))(
            jparams, jbatch)
    assert got.shape == want.shape
    close(got, want, f"{arch} forward logits")
    tloss = api.loss(tparams, tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert torch.equal(api.prefill(tparams, tbatch), got)


def check_prefill_and_decode(arch):
    """Sequential decode through the caches, logits and cache contents,
    then one more step through ``ModelAPI.decode_step``."""
    jcfg, cfg, jparams, tparams, inputs = setup(arch)
    api = treg.build_model(cfg)
    toks = inputs["tokens"]
    jcache = jtf.init_cache_lm(jcfg, B, S, jnp.float32)
    jcache, want = jax.jit(functools.partial(jtf.prefill_into_cache,
                                             cfg=jcfg))(
        jparams, jcache, jnp.asarray(toks))
    tcache = api.init_cache(B, S, torch.float32, "cpu")
    tcache, got = ttf.prefill_into_cache(tparams, tcache,
                                         torch.from_numpy(toks), cfg)
    close(got, want, f"{arch} prefill logits")
    assert tcache["step"] == int(jcache["step"]) == S
    for key in ("global_pos", "local_pos"):
        assert (key in tcache) == (key in jcache)
        if key in jcache:
            np.testing.assert_array_equal(tcache[key].numpy(),
                                          np.asarray(jcache[key]))
    for n, (tc, jc) in enumerate(zip(tcache["layers"],
                                     unstacked_caches(jcfg, jcache))):
        assert set(tc) == set(jc), (n, set(tc), set(jc))
        for k in jc:
            assert tc[k].dtype == torch.float32, (n, k, tc[k].dtype)
            close(tc[k], jc[k], f"layer {n} cache {k}", CACHE_ATOL,
                  CACHE_RTOL)
    nxt = np.array([[5], [7]], np.int32)
    want1, _ = jax.jit(functools.partial(jtf.decode_step_lm, cfg=jcfg))(
        jparams, jcache, jnp.asarray(nxt))
    got1, tcache = api.decode_step(tparams, tcache, torch.from_numpy(nxt))
    close(got1, want1, f"{arch} decode_step_lm logits")
    assert tcache["step"] == S + 1


def check_decode_matches_own_forward(arch):
    """The reference's consistency check on the port alone (MoE at
    ``capacity_factor = n_experts``, so the forward drops no pair)."""
    jcfg = jbase.reduce_config(JARCHS[arch])
    cfg = port_cfg(jcfg)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    api = treg.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, 24)).astype(np.int32))
    full, _ = ttf.forward_lm(params, toks, cfg)
    cache = api.init_cache(B, 24, torch.float32, "cpu")
    _, seq = ttf.prefill_into_cache(params, cache, toks, cfg)
    rel = float((full - seq).abs().max() / full.abs().max())
    assert rel < 2e-4, (arch, rel)


def check_params_from_jax(arch):
    """Names, shapes and dtypes of the loaded tree equal the port's own
    init; at bf16 each leaf keeps the reference's dtype (f32 for the MoE
    router, the SSM's dt_bias/A_log/D and the RG-LRU gates and lam)."""
    jcfg, cfg, jparams, tparams, _ = setup(arch)
    own = treg.build_model(cfg).init(torch.Generator().manual_seed(0))
    assert _specs(own) == _specs(tparams)
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    jbf16 = dataclasses.replace(jcfg, param_dtype="bfloat16")
    jtree = jax.eval_shape(jbuild(jbf16).init, jax.random.PRNGKey(0))
    loaded = treg.params_from_jax(bf16, jax.tree.map(np.asarray, jparams),
                                  "cpu")
    own_bf16 = treg.build_model(bf16).init(torch.Generator().manual_seed(0))
    assert _specs(loaded) == _specs(own_bf16)
    ref_dtypes = {k: str(v.dtype) for k, v in _flatten_ref(
        jcfg, jtree).items()}
    got_dtypes = {k: str(v.dtype).replace("torch.", "")
                  for k, v in _flatten(loaded).items()}
    assert got_dtypes == ref_dtypes


def _specs(tree):
    return {k: (tuple(v.shape), v.dtype) for k, v in _flatten(tree).items()}


def _flatten(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _flatten_ref(jcfg, jtree):
    """The reference's (stacked) tree flattened under the port's names."""
    if jcfg.family == "encdec":
        tree = {k: v for k, v in jtree.items() if k not in ("enc", "dec")}
        for key, n in (("enc", jcfg.encoder_layers), ("dec", jcfg.num_layers)):
            tree[key] = [jax.tree.map(lambda a: a, jtree[key])
                         for _ in range(n)]
        return _flatten(tree)
    n_groups, pattern, rest = jcommon.pattern_split(jcfg)
    layers = [jtree["pattern"][i] for _ in range(n_groups)
              for i in range(len(pattern))] + list(jtree["rest"])
    tree = {k: v for k, v in jtree.items() if k not in ("pattern", "rest")}
    tree["layers"] = layers
    return _flatten(tree)
