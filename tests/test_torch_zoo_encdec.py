"""The Whisper encoder-decoder of the LM zoo against the reference, on the
CPU.

whisper-medium at ``reduce_config`` (f32: 2 encoder and 2 decoder layers,
8 frames): ``encode``, ``forward_encdec``, ``encdec_loss``,
``fill_cross_cache`` and 20 ``decode_step_encdec`` steps (logits of every
step, the self and cross caches) against the reference; the port's decoded
logits against its own teacher-forced pass; ``params_from_jax`` of the
reference's stacked ``enc``/``dec``; ``input_specs``; and the serve
launcher's exit for an enc-dec arch, as the reference's. Tolerances in
``tests/_torch_zoo.py``; the decode-vs-forward check within the
reference's rel < 2e-4.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_zoo as zoo  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

ARCH = "whisper-medium"


def test_forward_and_loss_match_reference():
    zoo.check_forward_and_loss(ARCH)


def test_encode_matches_reference():
    jcfg, cfg, jparams, tparams, inputs = zoo.setup(ARCH)
    want = jax.jit(functools.partial(jencdec.encode, cfg=jcfg))(
        jparams, jnp.asarray(inputs["frames"]))
    got = tencdec.encode(tparams, torch.from_numpy(inputs["frames"]), cfg)
    zoo.close(got, want, "encoder states")


def test_sinusoid_positions_match_reference():
    """Within 4 f32 ulps of the largest angle: the two ``pow`` calls may
    round the frequency one ulp apart, and sin/cos pass that on."""
    for seq, d, off in ((8, 64, 0), (1, 1024, 1499), (3, 16, 7)):
        np.testing.assert_allclose(
            tencdec.sinusoid_positions(seq, d, offset=off).numpy(),
            np.asarray(jencdec.sinusoid_positions(seq, d, offset=off)),
            atol=4 * float(np.spacing(np.float32(seq + off))), rtol=0)


def test_cross_cache_and_decode_steps_match_reference():
    jcfg, cfg, jparams, tparams, inputs = zoo.setup(ARCH)
    toks, frames = inputs["tokens"], inputs["frames"]
    B, S = toks.shape
    jcache = jencdec.init_cache_encdec(jcfg, B, S, jnp.float32)
    jcache = jax.jit(functools.partial(jencdec.fill_cross_cache, cfg=jcfg))(
        jparams, jcache, jnp.asarray(frames))
    api = treg.build_model(cfg)
    tcache = api.init_cache(B, S, torch.float32, "cpu")
    assert tencdec.fill_cross_cache(tparams, tcache, torch.from_numpy(frames),
                                    cfg) is tcache
    for n, c in enumerate(tcache["cross"]):
        for k in ("k", "v"):
            zoo.close(c[k], jcache["cross"][k][n], f"cross {k} layer {n}",
                      zoo.CACHE_ATOL, zoo.CACHE_RTOL)
    jstep = jax.jit(functools.partial(jencdec.decode_step_encdec, cfg=jcfg))
    for t in range(S):
        want, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]))
        got, tcache = api.decode_step(tparams, tcache,
                                      torch.from_numpy(toks[:, t:t + 1]))
        zoo.close(got, want, f"decode step {t}")
    assert tcache["step"] == int(jcache["step"]) == S
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for n, c in enumerate(tcache["self"]):
        for k in ("k", "v"):
            zoo.close(c[k], jcache["self"][k][n], f"self {k} layer {n}",
                      zoo.CACHE_ATOL, zoo.CACHE_RTOL)


def test_port_decode_matches_port_teacher_forced():
    _, cfg, _, tparams, inputs = zoo.setup(ARCH)
    toks = torch.from_numpy(inputs["tokens"])
    frames = torch.from_numpy(inputs["frames"])
    full = tencdec.forward_encdec(tparams, {"frames": frames, "tokens": toks},
                                  cfg)
    cache = tencdec.init_cache_encdec(cfg, toks.shape[0], toks.shape[1],
                                      torch.float32, "cpu")
    tencdec.fill_cross_cache(tparams, cache, frames, cfg)
    seq = []
    for t in range(toks.shape[1]):
        logits, cache = tencdec.decode_step_encdec(tparams, cache,
                                                   toks[:, t:t + 1], cfg)
        seq.append(logits[:, 0])
    rel = float((full - torch.stack(seq, 1)).abs().max() / full.abs().max())
    assert rel < 2e-4, rel


def test_params_from_jax_unstacks_and_checks():
    jcfg, cfg, jparams, tparams, _ = zoo.setup(ARCH)
    assert len(tparams["enc"]) == jcfg.encoder_layers
    assert len(tparams["dec"]) == jcfg.num_layers
    np.testing.assert_array_equal(tparams["dec"][1]["cross"]["wq"].numpy(),
                                  np.asarray(jparams["dec"]["cross"]["wq"][1]))
    zoo.check_params_from_jax(ARCH)
    tree = jax.tree.map(np.asarray, jparams)
    bad = {**tree, "dec": {k: v for k, v in tree["dec"].items()
                           if k != "lnx"}}
    with pytest.raises(ValueError, match="leaves"):
        treg.params_from_jax(cfg, bad, "cpu")
    with pytest.raises(ValueError, match="top-level"):
        treg.params_from_jax(cfg, {**tree, "lm_head": tree["embed"]}, "cpu")


def test_input_specs_match_reference():
    jcfg, cfg, *_ = zoo.setup(ARCH)
    japi, api = jbuild(jcfg), treg.build_model(cfg)
    for name, shape in jbase.SHAPES.items():
        want = japi.input_specs(shape)
        got = api.input_specs(tbase.SHAPES[name])
        assert {k: v[0] for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert {k: str(v[1]).replace("torch.", "") for k, v in got.items()} \
            == {k: str(v.dtype) for k, v in want.items()}


def test_serve_launcher_exits_for_encdec():
    with pytest.raises(SystemExit, match="enc-dec"):
        tlaunch.main(["--arch", ARCH, "--device", "cpu", "--requests", "1"])
