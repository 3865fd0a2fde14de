"""Quickstart of the PyTorch/CUDA port: train a small LM with the substrate.

The port's counterpart of ``examples/quickstart.py``: config registry ->
model build -> shard-queue data pipeline -> train step -> flash checkpoint
-> restore. Runs on ``cuda`` unless ``--device cpu`` is given (it never
falls back), in about a minute on the CPU.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] \
        [--samples 2048]
"""
import argparse
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import reduce_config
from repro_torch.configs.registry import get_arch
from repro_torch.core.flash_checkpoint import FlashCheckpoint
from repro_torch.core.sharding_service import ShardingService
from repro_torch.data.pipeline import ShardDataLoader
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch.train import resolve_device, to_device
from repro_torch.models.registry import build_model
from repro_torch.train import elastic, optim, state_tree, trainer


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    ap.add_argument("--samples", type=int, default=2048,
                    help="samples in the dataset (16 per step)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduce_config(get_arch("llama3.2-3b"), d_model=128, n_heads=4,
                        n_kv_heads=2, head_dim=32, d_ff=256, num_layers=4,
                        vocab_size=512)
    api = build_model(cfg)
    opt = optim.adamw(3e-3)
    state = trainer.make_train_state(
        api, opt, torch.Generator(device=device).manual_seed(0))
    step = trainer.make_train_step(api, opt, remat=True, donate=True)

    svc = ShardingService(total_samples=args.samples, shard_size=256)
    loader = ShardDataLoader(svc, "worker0",
                             lambda idx: lm_batch(0, idx, 64, cfg.vocab_size),
                             batch_size=16)

    print(f"arch={cfg.name} params={cfg.param_count():,} device={device}")
    losses = []
    for i, batch in enumerate(loader):
        state, m = step(state, to_device(batch, device))
        losses.append(float(m["loss"]))
        if i % 16 == 0:
            print(f"step {state['step']:4d} loss={losses[-1]:.4f} "
                  f"gnorm={float(m['grad_norm']):.3f}")

    ok, covered, dup = svc.coverage(0)
    print(f"data coverage exact={ok} covered={covered} dup={dup}")

    with tempfile.TemporaryDirectory() as d:
        ck = FlashCheckpoint(d)
        ck.save(state_tree.lm_to_tree(state, cfg), state["step"])
        ck.wait()
        print(f"flash-checkpoint: mem tier {ck.last_save_seconds*1e3:.1f} ms, "
              f"async disk tier {ck.last_persist_seconds*1e3:.1f} ms")
        restored, restored_step, _ = elastic.resume_on_mesh(
            api, opt, "adamw", FlashCheckpoint(d), None, None, device=device)
        print(f"restored at step {restored_step}")
    return state, restored, losses, ok


if __name__ == "__main__":
    main()
