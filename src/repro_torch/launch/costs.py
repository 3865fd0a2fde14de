"""One-device cost accounting: model FLOPs, counted step FLOPs, HBM bytes.

The part of ``repro/launch/costs.py`` and ``repro/launch/dryrun.py`` that
applies to one card:

* ``model_flops``: 6·N·tokens for a train step, 2·N·tokens for a prefill,
  2·N·B for a decode step (N the active params of an MoE), the
  reference's bookkeeping.
* ``flops_of``: the exact FLOPs of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` where the reference walks
  the jaxpr. Run on ``meta`` tensors (``meta_state``, ``meta_inputs``), a
  full-width model at the reference's shapes costs no memory; the kernel
  wrappers run their plain versions on meta tensors, since no kernel can
  read a tensor with no data.
* ``analytic_hbm_bytes``: the reference's first-principles HBM traffic of a
  step with every mesh axis of size 1, in the reference's order of
  floating-point operations less its (exact) divisions by those sizes, so
  the results are ``==``.
* ``cost_cell``: the one-device record of the reference's ``lower_cell``.

The counter counts ``mm``/``bmm``/``addmm``/``baddbmm``, convolutions and
SDPA where the reference's walker counts ``dot_general`` and
``conv_general_dilated``; neither counts a gather, a scatter, an
elementwise op or a reduction (the embedding lookup and its backward, the
loss's target gather, the optimizer, the causal depthwise conv of the SSM
and RG-LRU blocks, a multiply-add sum in both packages). Every product of
the port's LM paths is one of those ops where the reference's is a
``dot_general``, so the counts agree wherever the two run the same
algorithm, and differ only where they do not:

* the train step: the port's chunked attention recomputes each block's
  scores in the backward (``models/attention.py``), one more ``q·kᵀ``
  product per block pair and attention call, 2·B·Hq·Sq·Skv·D for a global
  layer;
* the SSD block's three-operand einsums (``models/ssm.py``) contract in
  another pairwise order: the reference's path forms a product with no
  contracted index as a ``dot_general``, which its walker counts, where
  ``torch.einsum`` forms an elementwise product, which the counter does
  not;
* decode: the reference spells the SSM and RG-LRU conv step as an einsum
  (a ``dot_general``), the port as a multiply-add sum.

A prefill is counted on the chunked route, the reference's ``xla`` walk
(``step_flops`` marks the params as requiring grad so that attention takes
it, and runs no backward): K4's plain version walks 64 x 64 tiles in a
Python loop, ~10^5 iterations per layer at 32k tokens. K4 itself skips the
tiles a causal or window mask leaves empty, so for a global causal layer
the count is up to twice K4's attention work.

There is no mesh, no collective model and no compile: those wait for a
multi-card port.

    PYTHONPATH=src python -m repro_torch.launch.costs --arch llama3.2-3b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.costs --all --out build/costs
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.configs.registry import ARCHS, get_arch, get_shape
from repro_torch.models.common import pad_vocab
from repro_torch.models.registry import ModelAPI, build_model
from repro_torch.train import optim as optim_mod
from repro_torch.train import trainer as trainer_mod

META = torch.device("meta")


# ===========================================================================
# model FLOPs (config only) and the counted FLOPs of one call
# ===========================================================================
def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS bookkeeping: 6·N·D train, 2·N·D prefill/decode (MoE: active)."""
    n = cfg.param_count(active_only=cfg.n_experts > 0)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch                     # decode: 1 token each


def flops_of(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of ``fn(*args, **kwargs)``, backward passes and recomputation
    included, as ``FlopCounterMode`` counts them while it runs."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the ``meta`` device: ``api.init`` puts
    every leaf on its generator's device, and ``torch.randn`` on the meta
    device draws nothing."""

    @property
    def device(self) -> torch.device:
        return META


def meta_params(api: ModelAPI) -> Any:
    """``api``'s params as meta tensors (the shapes and dtypes of
    ``api.init``, no data)."""
    return api.init(_MetaGenerator())


def meta_state(api: ModelAPI, optimizer: optim_mod.Optimizer):
    """A fresh train state of ``api`` on the meta device."""
    return trainer_mod.make_train_state(api, optimizer, _MetaGenerator())


def meta_inputs(api: ModelAPI, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The batch of ``api.input_specs(shape)`` as meta tensors."""
    return {k: torch.empty(s, dtype=dt, device=META)
            for k, (s, dt) in api.input_specs(shape).items()}


def step_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Counted FLOPs of the call ``lower_cell`` lowers for ``shape.kind``:
    the train step (adam, remat), the prefill (on the chunked route) or
    one decode step over a bf16 cache of ``shape.seq_len`` slots, on meta
    tensors."""
    api = build_model(cfg)
    batch = meta_inputs(api, shape)
    if shape.kind == "train":
        optimizer = optim_mod.adam(
            1e-3, master_weights=cfg.param_dtype == "bfloat16")
        step = trainer_mod.make_train_step(api, optimizer, remat=True)
        return flops_of(step, meta_state(api, optimizer), batch)
    params = meta_params(api)
    if shape.kind == "prefill":
        # params that require grad send attention down the chunked route
        # (models/transformer.full_attention); no backward runs
        params = optim_mod.tree_map(lambda t: t.requires_grad_(), params)
        with torch.enable_grad():
            return flops_of(api.prefill, params, batch)
    cache = api.init_cache(shape.global_batch, shape.seq_len, torch.bfloat16,
                           META)
    with torch.no_grad():
        return flops_of(api.decode_step, params, cache, batch["tokens"])


# ===========================================================================
# analytic HBM-traffic model (one device, per step)
# ===========================================================================
def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig,
                       param_bytes_total: float,
                       flops_per_device: float) -> Dict[str, float]:
    """Dominant HBM traffic components of one step on one device: the
    reference's model with every axis size 1, whose divisions by those
    sizes are exact and dropped (``flops_per_device`` is taken, as there,
    and not used)."""
    B, S = shape.global_batch, shape.seq_len
    dt = 2.0
    out: Dict[str, float] = {}
    tokens = float(B * S)

    if shape.kind == "train":
        # params read (fwd + bwd + remat fwd) + grads written + adam state r/w
        out["params"] = 3.0 * param_bytes_total
        out["grads"] = 2.0 * param_bytes_total
        out["optimizer"] = 4.0 * param_bytes_total     # m,v read+write (f32≈2×)
        act_per_layer = tokens * cfg.d_model * dt
        out["activations"] = 6.0 * act_per_layer * cfg.num_layers
        out["logits"] = 2.0 * tokens * pad_vocab(cfg.vocab_size) * dt
    elif shape.kind == "prefill":
        out["params"] = param_bytes_total
        out["activations"] = 4.0 * tokens * cfg.d_model * dt * cfg.num_layers
        out["kv_write"] = 2.0 * tokens * (cfg.n_kv_heads or 1) \
            * (cfg.head_dim or 1) * dt * cfg.num_layers
    else:  # decode: weight-streaming + cache read dominate
        out["params"] = param_bytes_total
        cache_bytes = 0.0
        for k in cfg.layer_kinds:
            if k == "global":
                L = S
            elif k == "local":
                L = min(cfg.local_window, S)
            elif k == "ssm":
                cache_bytes += B * cfg.ssm_nheads * cfg.ssm_headdim \
                    * cfg.ssm_state * 4.0
                continue
            else:  # recurrent
                cache_bytes += B * (cfg.lru_width or cfg.d_model) * 4.0
                continue
            cache_bytes += 2.0 * B * L * (cfg.n_kv_heads or 1) \
                * (cfg.head_dim or 1) * dt
        out["kv_cache_read"] = cache_bytes
    out["total"] = sum(out.values())
    return out


def param_bytes(cfg: ModelConfig) -> float:
    """Bytes of the params at their stored dtype, as ``lower_cell``."""
    return cfg.param_count() * (2.0 if cfg.param_dtype == "bfloat16"
                                else 4.0)


# ===========================================================================
# one cell: the one-device record of the reference's lower_cell
# ===========================================================================
def cost_cell(arch: str, shape_name: str) -> Dict[str, Any]:
    """``arch`` at its full config and ``shape_name`` on one device:
    ``model_flops``, the counted ``step_flops``, ``analytic_hbm`` and the
    param counts; ``{"skipped": why}`` where ``shape_applicable`` says so."""
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "n_devices": 1}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec["skipped"] = why
        return rec
    t0 = time.perf_counter()
    rec["step_flops"] = step_flops(cfg, shape)
    rec["count_s"] = time.perf_counter() - t0
    rec["model_flops"] = model_flops(cfg, shape)
    rec["analytic_hbm"] = analytic_hbm_bytes(cfg, shape, param_bytes(cfg),
                                             rec["step_flops"])
    rec["params"] = cfg.param_count()
    rec["params_active"] = cfg.param_count(active_only=cfg.n_experts > 0)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="write one JSON per cell here (default: print)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in ARCHS for shape in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all, required")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for arch, shape in cells:
        try:
            rec = cost_cell(arch, shape)
        except Exception as e:      # one failed cell does not stop --all
            rec = {"arch": arch, "shape": shape, "n_devices": 1,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            print("FAILED:", arch, shape, rec["error"])
        if args.out:
            path = os.path.join(args.out, f"{arch}_{shape}.json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
        else:
            print(json.dumps(rec))


if __name__ == "__main__":
    main()
