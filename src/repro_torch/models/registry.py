"""Unified model API: one object per arch exposing init/loss/prefill/decode.

Port of ``repro/models/registry.py`` for the decoder-only families this
package has ported (dense attention layers). ``init`` takes a
``torch.Generator`` (its device is where the params live) instead of a JAX
key; ``init_cache`` takes the dtype and the device of its cache, with no
default: a cache goes where the caller's params are.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf_mod


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Any]
    loss: Callable[..., torch.Tensor]          # (params, batch)
    prefill: Callable[..., torch.Tensor]       # (params, batch) -> logits
    init_cache: Callable[..., Any]             # (batch, max_len, dtype, device)
    decode_step: Callable[..., Any]            # (params, cache, tokens)


def build_model(cfg: ModelConfig) -> ModelAPI:
    """The API of ``cfg``; raises ``NotImplementedError`` for the families
    and layer kinds not ported yet (ROADMAP §1 item 11)."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            "(ROADMAP §1 item 11: encdec.py)")
    for kind in set(cfg.layer_kinds):
        tf_mod.require_supported(kind, cfg)
    return ModelAPI(
        cfg=cfg,
        init=lambda gen: tf_mod.init_lm(cfg, gen),
        loss=lambda params, batch: tf_mod.lm_loss(params, batch, cfg),
        prefill=lambda params, batch: tf_mod.forward_lm(
            params, batch["tokens"], cfg)[0],
        init_cache=lambda batch, max_len, dtype, device:
            tf_mod.init_cache_lm(cfg, batch, max_len, dtype, device),
        decode_step=lambda params, cache, tokens: tf_mod.decode_step_lm(
            params, cache, tokens, cfg),
    )
