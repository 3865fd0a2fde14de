"""Dense MLP block (SwiGLU or plain GELU).

Port of the dense half of ``repro/models/mlp.py``. The MoE block is not
ported yet (ROADMAP §1 item 11); ``init_moe``/``moe_block`` are absent and
``models/transformer.py`` refuses configs with experts.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import act_fn, dense_init


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             dtype) -> Dict[str, torch.Tensor]:
    d, ff = cfg.d_model, cfg.d_ff
    p = {"w1": dense_init(gen, (d, ff), d, dtype),
         "w2": dense_init(gen, (ff, d), ff, dtype)}
    if cfg.activation == "silu":
        p["w3"] = dense_init(gen, (d, ff), d, dtype)
    if cfg.mlp_bias:
        p["b1"] = torch.zeros((ff,), dtype=dtype, device=gen.device)
        p["b2"] = torch.zeros((d,), dtype=dtype, device=gen.device)
    return p


def mlp_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    act = act_fn(cfg.activation)
    dt = x.dtype
    h = x @ p["w1"].to(dt)
    if "b1" in p:
        h = h + p["b1"].to(dt)
    if cfg.activation == "silu":
        h = act(h) * (x @ p["w3"].to(dt))
    else:
        h = act(h)
    y = h @ p["w2"].to(dt)
    if "b2" in p:
        y = y + p["b2"].to(dt)
    return y
