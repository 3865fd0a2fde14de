"""Unified model API: one object per arch exposing init/loss/prefill/decode.

Port of ``repro/models/registry.py``, for every family: the decoder-only
LMs (``models/transformer.py``) and the encoder-decoder (``models/
encdec.py``). ``init`` takes a ``torch.Generator`` (its device is where the
params live) instead of a JAX key; ``init_cache`` takes the dtype and the
device of its cache, with no default: a cache goes where the caller's
params are. ``input_specs`` gives ``{name: (shape, torch.dtype)}``.
``params_from_jax`` loads a reference param tree of either family.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import dtype_of

Spec = Tuple[Tuple[int, ...], torch.dtype]


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Any]
    loss: Callable[..., torch.Tensor]          # (params, batch, remat=False)
    prefill: Callable[..., torch.Tensor]       # (params, batch) -> logits
    init_cache: Callable[..., Any]             # (batch, max_len, dtype, device)
    decode_step: Callable[..., Any]            # (params, cache, tokens)
    input_specs: Callable[[ShapeConfig], Dict[str, Spec]]


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "encdec":
        return _build_encdec(cfg)
    return _build_lm(cfg)


def params_from_jax(cfg: ModelConfig, np_tree: Mapping[str, Any],
                    device) -> Any:
    """A reference param tree (numpy leaves) of ``cfg`` as this package's
    params on ``device``."""
    if cfg.family == "encdec":
        return encdec_mod.params_from_jax(cfg, np_tree, device)
    return tf_mod.params_from_jax(cfg, np_tree, device)


# --- decoder-only families -----------------------------------------------------
def _build_lm(cfg: ModelConfig) -> ModelAPI:
    def input_specs(shape: ShapeConfig) -> Dict[str, Spec]:
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if shape.kind == "train":
            return {"tokens": ((B, S), i32), "targets": ((B, S), i32)}
        if shape.kind == "prefill":
            return {"tokens": ((B, S), i32)}
        # decode: one new token; the KV cache (length S) is a separate input
        return {"tokens": ((B, 1), i32)}

    return ModelAPI(
        cfg=cfg,
        init=lambda gen: tf_mod.init_lm(cfg, gen),
        loss=lambda params, batch, remat=False: tf_mod.lm_loss(
            params, batch, cfg, remat=remat),
        prefill=lambda params, batch: tf_mod.forward_lm(
            params, batch["tokens"], cfg)[0],
        init_cache=lambda batch, max_len, dtype, device:
            tf_mod.init_cache_lm(cfg, batch, max_len, dtype, device),
        decode_step=lambda params, cache, tokens: tf_mod.decode_step_lm(
            params, cache, tokens, cfg),
        input_specs=input_specs,
    )


# --- encoder-decoder (whisper) ---------------------------------------------------
def _build_encdec(cfg: ModelConfig) -> ModelAPI:
    def input_specs(shape: ShapeConfig) -> Dict[str, Spec]:
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        frames = ((B, cfg.n_frames, cfg.d_model), dtype_of(cfg.compute_dtype))
        if shape.kind == "train":
            return {"frames": frames, "tokens": ((B, S), i32),
                    "targets": ((B, S), i32)}
        if shape.kind == "prefill":
            return {"frames": frames, "tokens": ((B, S), i32)}
        return {"tokens": ((B, 1), i32)}

    return ModelAPI(
        cfg=cfg,
        init=lambda gen: encdec_mod.init_encdec(cfg, gen),
        loss=lambda params, batch, remat=False: encdec_mod.encdec_loss(
            params, batch, cfg, remat=remat),
        prefill=lambda params, batch: encdec_mod.forward_encdec(
            params, batch, cfg),
        init_cache=lambda batch, max_len, dtype, device:
            encdec_mod.init_cache_encdec(cfg, batch, max_len, dtype, device),
        decode_step=lambda params, cache, tokens:
            encdec_mod.decode_step_encdec(params, cache, tokens, cfg),
        input_specs=input_specs,
    )
