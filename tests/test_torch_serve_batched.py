"""The port's batched-serving example, ``examples/serve_batched_torch.py``,
on the CPU.

Its ``main`` runs at the example's reduced size with ``--device cpu`` and
prints the reference example's lines. Its ``serve`` function, fed the
reference's params (``params_from_jax``) and the example's request stream,
gives the tokens of the reference example's engine (``repro.serve.engine``
on ``api.init(PRNGKey(0))``, 3 slots, 96-slot caches) for llama3.2-3b and
mamba2-2.7b, exactly (greedy decoding, f32).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401  (sets torch threads)
import _torch_zoo as zoo  # noqa: E402
import jax  # noqa: E402

from repro.configs.base import reduce_config as jreduce  # noqa: E402
from repro.configs.registry import get_arch as jget_arch  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.models.registry import params_from_jax  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]


def _example():
    path = ROOT / "examples" / "serve_batched_torch.py"
    spec = importlib.util.spec_from_file_location("serve_batched_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXAMPLE = _example()


def test_main_serves_the_reduced_llama_on_the_cpu(capsys):
    cuda_lib.reset_launches()
    outs = EXAMPLE.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert cuda_lib.LAUNCHES == {k: 0 for k in cuda_lib.LAUNCHES}
    assert lines[0] == "arch=llama3.2-3b slots=3 requests=6"
    cfg = EXAMPLE.reduce_config(EXAMPLE.get_arch("llama3.2-3b"))
    reqs = EXAMPLE.make_requests(cfg, 6)
    assert sorted(outs) == list(range(6))
    for req, line in zip(reqs, lines[1:7]):
        assert line == f"  req {req.rid}: {outs[req.rid].tokens}"
        assert len(outs[req.rid].tokens) == req.max_new_tokens
        assert all(0 <= t < 256 for t in outs[req.rid].tokens)
    total = sum(r.max_new_tokens for r in reqs)
    assert lines[7].startswith(f"{total} tokens in ")


def test_main_raises_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        EXAMPLE.main(["--requests", "1"])


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-2.7b"])
def test_serve_matches_the_reference_example_engine(arch):
    jcfg = jreduce(jget_arch(arch))
    japi = jbuild(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = zoo.port_cfg(jcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    reqs = EXAMPLE.make_requests(cfg, 6)

    eng = jengine.ServeEngine(japi, jparams, slots=3, max_len=EXAMPLE.MAX_LEN)
    for r in reqs:
        eng.submit(jengine.Request(rid=r.rid, prompt=r.prompt,
                                   max_new_tokens=r.max_new_tokens))
    want = {rid: list(c.tokens) for rid, c in eng.run().items()}

    outs, steps = EXAMPLE.serve(cfg, params, reqs, 3, "cpu")
    got = {rid: list(c.tokens) for rid, c in outs.items()}
    assert got == want
    assert steps == eng.steps
    with pytest.raises(ValueError, match="not meta"):
        EXAMPLE.serve(cfg, params, reqs, 3, "meta")
