"""Serving launcher: batched greedy decoding for an ``--arch`` of the LM zoo.

Port of ``repro/launch/serve.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        --full --requests 8 --slots 4 --max-new 16 [--device cpu]

``--arch`` is any decoder arch of the zoo; an encoder-decoder arch
(whisper-medium) exits as the reference does, since the engine serves
decoder-only models. The same flags as the reference, plus ``--full`` (the
published config; without it ``reduce_config`` shrinks the model to its
CPU-test size) and ``--device``. Runs on ``cuda`` unless ``--device cpu`` is given; with no GPU
and no such request it raises. Weights are random, drawn from a
``torch.Generator`` seeded with ``--seed`` on the device; prompts come from
``numpy.random.default_rng(--seed)`` as in the reference.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, reduce_config
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.launch.train import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Completion, Request, ServeEngine


class ServeRun(NamedTuple):
    """What ``serve`` ran and what it produced."""
    cfg: ModelConfig
    outputs: Dict[int, Completion]
    tokens: int
    seconds: float
    steps: int
    prompt_tokens: int


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    return ap


def serve(args) -> ServeRun:
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduce_config(cfg)
    if cfg.family == "encdec":
        raise SystemExit("use whisper-specific pipelines for enc-dec serving")
    device = resolve_device(args.device)
    api = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.init(gen)
    eng = ServeEngine(api, params, slots=args.slots, max_len=args.max_len)

    rng = np.random.default_rng(args.seed)
    prompt_tokens = 0
    for rid in range(args.requests):
        plen = int(rng.integers(4, 16))
        prompt_tokens += plen
        eng.submit(Request(rid=rid,
                           prompt=rng.integers(0, cfg.vocab_size, plen),
                           max_new_tokens=args.max_new))
    t0 = time.time()
    outs = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = sum(len(c.tokens) for c in outs.values())
    print(f"arch={cfg.name} slots={args.slots}: {toks} tokens "
          f"in {dt:.2f}s ({toks/dt:.1f} tok/s, {eng.steps} steps)")
    return ServeRun(cfg, outs, toks, dt, eng.steps, prompt_tokens)


def main(argv: Optional[Sequence[str]] = None) -> ServeRun:
    return serve(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
