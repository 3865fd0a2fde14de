"""How far bf16 rounding alone moves an LM's logits, reference and port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/zoo_bf16_sensitivity.py

On the CPU, at ``reduce_config`` width (d_model 64) and the depth given
below, for one set of the reference's seeded weights: the reference's
(``repro``) bf16 forward against its f32 forward and against its bf16
decode (``prefill_into_cache``), and the same two numbers for the port
(``repro_torch``) on the same weights. Each number is max |a - b| / max |a|
over the logits of one 32-token prompt. It shows whether a bf16
forward-vs-decode gap is the arithmetic's (both packages show it) or the
port's. MoE configs run at ``capacity_factor = n_experts``, as the
reference's decode-vs-forward test does.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import ARCHS  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

CASES = [("llama3.2-3b", 16), ("mamba2-2.7b", 2), ("mamba2-2.7b", 16),
         ("granite-moe-1b-a400m", 8), ("mixtral-8x22b", 2)]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(a).max())


def main() -> None:
    torch.set_num_threads(4)
    for arch, layers in CASES:
        j32 = jbase.reduce_config(ARCHS[arch], num_layers=layers)
        if j32.n_experts:
            j32 = dataclasses.replace(j32,
                                      capacity_factor=float(j32.n_experts))
        jb16 = dataclasses.replace(j32, param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
        params = jax.jit(jbuild(j32).init)(jax.random.PRNGKey(1))
        # the bf16 config's own leaf dtypes (f32 routers, SSM scalars)
        like = jax.eval_shape(jbuild(jb16).init, jax.random.PRNGKey(0))
        p16 = jax.tree.map(lambda a, s: a.astype(s.dtype), params, like)
        toks = np.random.default_rng(2).integers(
            0, j32.vocab_size, (1, 32)).astype(np.int32)
        ref32 = jax.jit(functools.partial(jtf.forward_lm, cfg=j32))(
            params, toks)[0]
        ref16 = jax.jit(functools.partial(jtf.forward_lm, cfg=jb16))(
            p16, toks)[0]
        _, ref16_dec = jax.jit(functools.partial(jtf.prefill_into_cache,
                                                 cfg=jb16))(
            p16, jtf.init_cache_lm(jb16, 1, 32, jnp.float32), toks)
        cfg16 = tbase.ModelConfig(**dataclasses.asdict(jb16))
        tp = treg.params_from_jax(
            cfg16, jax.tree.map(lambda a: np.asarray(a, np.float32), params),
            "cpu")
        t = torch.from_numpy(toks)
        port16, _ = ttf.forward_lm(tp, t, cfg16)
        _, port16_dec = ttf.prefill_into_cache(
            tp, ttf.init_cache_lm(cfg16, 1, 32, torch.float32, "cpu"), t,
            cfg16)
        port16, port16_dec = (x.float().numpy() for x in (port16, port16_dec))
        print(f"{arch}, {layers} layers (d_model {j32.d_model}): reference "
              f"bf16 forward vs f32 forward {_rel(ref32, ref16):.3g}, bf16 "
              f"forward vs bf16 decode {_rel(ref16, ref16_dec):.3g}; port "
              f"{_rel(ref32, port16):.3g}, {_rel(port16, port16_dec):.3g}",
              flush=True)


if __name__ == "__main__":
    main()
