"""Shared building blocks: init, norms, RoPE, activations, pattern groups.

Port of ``repro/models/common.py``. ``dense_init`` draws from a
``torch.Generator``; everything else repeats the reference's expressions
(f32 inside the norms and RoPE, the result cast back to the input dtype).
The reference's ``KeyGen`` (JAX keys) and ``stack_trees`` (stacks layer
pytrees for ``lax.scan``) have no counterpart: the port draws from a
``torch.Generator`` and keeps layers as lists.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    """Pad vocab to a multiple of ``multiple`` (the reference's layout)."""
    return ((vocab + multiple - 1) // multiple) * multiple


# --- init --------------------------------------------------------------------
def dense_init(generator: torch.Generator, shape, in_axis_size: int,
               dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 1/sqrt(in_axis_size)) init drawn from ``generator``, on the
    generator's device. The reference's distribution; not its bits (JAX and
    torch generators differ), so parity tests load the reference's params
    through ``params_from_jax``."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.mul_(scale).to(dtype)


# --- norms -------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the reference's ``(1 + w)`` scale (zero-initialised w)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 with a plain ``w`` scale and ``b`` shift, the result
    in ``x``'s dtype (no model of the zoo calls it; kept so that this module
    holds all of the reference's)."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


# --- causal depthwise conv (SSM and RG-LRU blocks) -----------------------------
def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, as ``_causal_conv`` of the reference's
    ``ssm.py`` and ``rglru.py``. x: (B, L, C); w: (W, C)."""
    W, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:L, :] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + L, :] * w[i]
    return out + b


def conv_step(window: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """The last position of ``causal_conv`` over a (B, W, C) window: the
    same products and sums in the same order, so a decode step rounds as
    the forward does (the reference writes it as an einsum)."""
    out = window[:, 0] * w[0]
    for i in range(1, w.shape[0]):
        out = out + window[:, i] * w[i]
    return out + b


# --- RoPE --------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                      # (head_dim//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Half-split rotation (the first and second halves of ``head_dim`` form
    the pairs), not interleaved, as in the reference."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)
    angles = positions[..., :, None].float() * freqs       # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]               # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- activation --------------------------------------------------------------
def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# --- pattern-group utilities -------------------------------------------------
def pattern_split(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...], Tuple[str, ...]]:
    """num full pattern groups, the pattern, and the remainder layer kinds."""
    pat = cfg.layer_pattern
    n_groups = cfg.num_layers // len(pat)
    rest = cfg.layer_kinds[n_groups * len(pat):]
    return n_groups, pat, rest
