"""The port's serving engine and launcher against the reference, on the CPU.

``ServeEngine`` of the port and of the reference run the same requests on
the same weights (the reference's ``init_lm`` params, loaded through
``params_from_jax``) on ``reduce_config(llama3.2-3b)``; greedy decoding
must give identical tokens. The setups are those of
``tests/test_serve_brain.py``, plus a cache shorter than prompt + output
(global caches clamp their write slot) and an EOS stop.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401  (sets torch threads)
import jax  # noqa: E402

from repro.configs.base import reduce_config  # noqa: E402
from repro.configs.registry import ARCHS  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def models():
    jcfg = reduce_config(ARCHS["llama3.2-3b"])
    japi = jbuild(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    tparams = ttf.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                  "cpu")
    return japi, jparams, build_model(cfg), tparams


def _run(module, api, params, requests, **kw):
    eng = module.ServeEngine(api, params, **kw)
    for rid, prompt, max_new, eos in requests:
        eng.submit(module.Request(rid=rid, prompt=prompt,
                                  max_new_tokens=max_new, eos_id=eos))
    outs = eng.run()
    return {rid: list(c.tokens) for rid, c in outs.items()}, eng.steps


CASES = {
    # the batched setup of test_serve_brain: 5 requests through 2 slots
    "batched": (dict(slots=2, max_len=48),
                [(r, np.arange(4) + r, 3, None) for r in range(5)]),
    # its single-slot greedy setup
    "single": (dict(slots=1, max_len=32), [(0, np.arange(6), 4, None)]),
    # prompt + output longer than the cache: the write slot clamps
    "past-max-len": (dict(slots=2, max_len=8),
                     [(0, np.arange(6) + 3, 6, None),
                      (1, np.arange(5) * 7, 5, None)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_reference_engine(models, case):
    japi, jparams, api, tparams = models
    kw, requests = CASES[case]
    want, want_steps = _run(jengine, japi, jparams, requests, **kw)
    got, got_steps = _run(tengine, api, tparams, requests, **kw)
    assert got == want
    assert got_steps == want_steps
    assert all(len(got[rid]) == n for rid, _, n, _ in requests)


def test_engine_stops_at_eos_like_the_reference(models):
    japi, jparams, api, tparams = models
    first, _ = _run(tengine, api, tparams, [(0, np.arange(5), 6, None)],
                    slots=1, max_len=32)
    eos = first[0][2]                  # the third token generated
    requests = [(0, np.arange(5), 6, eos), (1, np.arange(3) + 9, 2, None)]
    want, _ = _run(jengine, japi, jparams, requests, slots=1, max_len=32)
    got, _ = _run(tengine, api, tparams, requests, slots=1, max_len=32)
    assert got == want
    assert len(got[0]) < 6


def test_engine_caches_are_f32_batch_one(models):
    _, _, api, tparams = models
    eng = tengine.ServeEngine(api, tparams, slots=3, max_len=16)
    assert len(eng.caches) == 3
    for cache in eng.caches:
        assert cache["global_pos"].shape == (1, 16)
        assert all(c["k"].dtype == torch.float32 and c["k"].shape[0] == 1
                   for c in cache["layers"])


def test_launcher_serves_on_the_cpu(capsys):
    cuda_lib.reset_launches()
    run = tlaunch.main(["--device", "cpu", "--requests", "3", "--slots",
                        "2", "--max-new", "4", "--max-len", "32"])
    assert run.tokens == 12 and len(run.outputs) == 3
    assert all(len(c.tokens) == 4 for c in run.outputs.values())
    out = capsys.readouterr().out
    assert "arch=llama3.2-3b slots=2: 12 tokens in " in out
    assert f"{run.steps} steps)" in out
    assert cuda_lib.LAUNCHES["decode_attention"] == 0


def test_launcher_flags_mirror_the_reference():
    args = tlaunch.build_parser().parse_args([])
    assert (args.arch, args.requests, args.slots, args.max_new, args.max_len,
            args.seed, args.full, args.device) == \
        ("llama3.2-3b", 8, 4, 8, 128, 0, False, "cuda")


def test_launcher_raises_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tlaunch.main(["--requests", "1", "--max-new", "1"])
    run = tlaunch.main(["--requests", "1", "--max-new", "1", "--device",
                        "cpu"])
    assert run.tokens == 1
