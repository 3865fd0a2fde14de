"""The port's serving engine and launcher on the new decoder families,
against the reference engine, on the CPU.

granite-moe-1b-a400m (MoE), mamba2-2.7b (SSM, no attention layer) and
recurrentgemma-2b (RG-LRU with local attention; an 8-slot window, so the
ring wraps) at ``reduce_config`` (f32), on the reference's weights
(``params_from_jax``): 5 requests through 2 slots, greedy tokens equal to
the reference engine's; then the launcher on each arch.
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
from repro_torch.models.registry import build_model, params_from_jax  # noqa: E402,E501
from repro_torch.serve import engine as tengine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ZOO = {
    "granite-moe-1b-a400m": {},
    "mamba2-2.7b": {},
    "recurrentgemma-2b": {"local_window": 8},
}
REQUESTS = [(r, np.arange(4) + 3 * r, 3 + r % 2) for r in range(5)]


def _run(module, api, params, **kw):
    eng = module.ServeEngine(api, params, **kw)
    for rid, prompt, max_new in REQUESTS:
        eng.submit(module.Request(rid=rid, prompt=prompt,
                                  max_new_tokens=max_new))
    outs = eng.run()
    return {rid: list(c.tokens) for rid, c in outs.items()}, eng.steps


@pytest.mark.parametrize("arch", sorted(ZOO))
def test_engine_matches_reference_engine(arch):
    jcfg = reduce_config(ARCHS[arch], **ZOO[arch])
    japi = jbuild(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    tparams = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    want, want_steps = _run(jengine, japi, jparams, slots=2, max_len=16)
    got, got_steps = _run(tengine, build_model(cfg), tparams, slots=2,
                          max_len=16)
    assert got == want
    assert got_steps == want_steps
    assert all(len(got[rid]) == n for rid, _, n in REQUESTS)


@pytest.mark.parametrize("arch", sorted(ZOO))
def test_launcher_serves_the_arch_on_the_cpu(arch, capsys):
    cuda_lib.reset_launches()
    run = tlaunch.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                        "--slots", "2", "--max-new", "3", "--max-len", "32"])
    assert run.tokens == 9 and len(run.outputs) == 3
    assert 3 * 4 <= run.prompt_tokens <= 3 * 15
    assert f"arch={arch} slots=2: 9 tokens in " in capsys.readouterr().out
    assert sum(cuda_lib.LAUNCHES.values()) == 0
