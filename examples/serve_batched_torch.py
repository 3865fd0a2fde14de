"""Batched serving of the PyTorch/CUDA port: decode a small LM with
slot-based continuous batching.

The port's counterpart of ``examples/serve_batched.py``: the same flags,
the same request stream (``np.random.default_rng(0)``), the same printed
lines, on ``reduce_config(get_arch(--arch))`` (f32). The weights are drawn
from a seeded CPU ``torch.Generator`` and then moved to ``--device``, so
the card and the CPU serve the same weights. Runs on ``cuda`` unless
``--device cpu`` is given (it never falls back); there a llama decode step
runs K5, a mamba2 step no kernel.

    PYTHONPATH=src python examples/serve_batched_torch.py \
        [--arch mamba2-2.7b] [--requests 6] [--slots 3] [--device cpu]
"""
import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, reduce_config
from repro_torch.configs.registry import get_arch
from repro_torch.launch.train import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Completion, Request, ServeEngine

MAX_LEN = 96
SEED = 0


def make_requests(cfg: ModelConfig, n: int) -> List[Request]:
    """The reference example's stream: ``n`` prompts of 4-11 tokens, each
    asking for 4-9 new ones, from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(n):
        prompt = rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12))
        reqs.append(Request(rid=rid, prompt=prompt,
                            max_new_tokens=int(rng.integers(4, 10))))
    return reqs


def serve(cfg: ModelConfig, params, requests: Sequence[Request], slots: int,
          device) -> Tuple[Dict[int, Completion], int]:
    """Serve ``requests`` through ``slots`` slots of the port's engine on
    ``params`` (on ``device``); returns the completions by request id and
    the engine's decode steps."""
    if params["embed"].device.type != torch.device(device).type:
        raise ValueError(f"params on {params['embed'].device}, not {device}")
    eng = ServeEngine(build_model(cfg), params, slots=slots, max_len=MAX_LEN)
    for req in requests:
        eng.submit(req)
    return eng.run(), eng.steps


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduce_config(get_arch(args.arch))
    params = tf.params_to(
        build_model(cfg).init(torch.Generator().manual_seed(SEED)), device)
    requests = make_requests(cfg, args.requests)

    t0 = time.time()
    outs, steps = serve(cfg, params, requests, args.slots, device)
    dt = time.time() - t0
    total_tokens = sum(len(c.tokens) for c in outs.values())
    print(f"arch={cfg.name} slots={args.slots} requests={args.requests}")
    for rid in sorted(outs):
        print(f"  req {rid}: {outs[rid].tokens}")
    print(f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s, {steps} engine steps)")
    return outs


if __name__ == "__main__":
    main()
