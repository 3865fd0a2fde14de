"""Shared building blocks: init, norms, RoPE, activations, pattern groups.

Port of ``repro/models/common.py``. ``dense_init`` draws from a
``torch.Generator``; everything else repeats the reference's expressions
(f32 inside the norm and RoPE, the result cast back to the input dtype).
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
    return (x * scale).to(dtype)


# --- norms -------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the reference's ``(1 + w)`` scale (zero-initialised w)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


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
