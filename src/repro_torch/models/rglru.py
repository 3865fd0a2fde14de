"""Griffin / RecurrentGemma RG-LRU recurrent block.

Port of ``repro/models/rglru.py``:

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * xi_t),
    a_t = exp(-c * softplus(lam) * r_t)

with block-diagonal recurrence and input gates (one block per head), a
causal depthwise conv on the recurrent branch and a GeLU-gated linear
branch [arXiv:2402.19427].

The reference runs the recurrence of the forward pass as
``jax.lax.associative_scan``; here it is a log-depth (Hillis-Steele) scan
over the sequence: ceil(log2 L) rounds, each combining every position with
the one ``2^r`` before it. Both compute the same linear recurrence with the
products associated in another order, so they differ by f32 rounding only:
each ``h_t`` is a sum of at most ``t`` terms ``(prod a) * gated``, every
``a`` in (0, 1), and each of the two orders rounds every term and every
partial sum once per round, about ``2 ceil(log2 L)`` roundings of 2^-24
relative to the largest ``|h|`` each. The decode step is the O(1)
recurrent update, with the cache (``conv``, ``h``) written in place; its
conv is ``common.conv_step``, which rounds as the forward's conv does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import causal_conv, conv_step, dense_init

_C = 8.0
CONV_W = 4


def init_rglru(gen: torch.Generator, cfg: ModelConfig,
               dtype) -> Dict[str, torch.Tensor]:
    """Projections in ``dtype``; the gates and ``lam`` in f32, as the
    reference keeps them."""
    d = cfg.d_model
    lru = cfg.lru_width or d
    nb = max(cfg.n_heads, 1)
    bw = lru // nb
    dev = gen.device
    f32 = torch.float32
    return {
        "in_y": dense_init(gen, (d, lru), d, dtype),
        "in_x": dense_init(gen, (d, lru), d, dtype),
        "conv_w": dense_init(gen, (CONV_W, lru), CONV_W, dtype),
        "conv_b": torch.zeros((lru,), dtype=dtype, device=dev),
        "gate_a_w": dense_init(gen, (nb, bw, bw), bw, f32),
        "gate_a_b": torch.zeros((nb, bw), dtype=f32, device=dev),
        "gate_i_w": dense_init(gen, (nb, bw, bw), bw, f32),
        "gate_i_b": torch.zeros((nb, bw), dtype=f32, device=dev),
        # lam so that a ~ 0.9..0.999 at r = 0.5 (Griffin appendix)
        "lam": torch.linspace(0.3, 1.5, lru, dtype=f32, device=dev),
        "out": dense_init(gen, (lru, d), lru, dtype),
    }


def _gates(p: Dict[str, torch.Tensor],
           xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal gate projections. xi (..., lru) -> (r, i) in f32."""
    nb, bw, _ = p["gate_a_w"].shape
    xb = xi.float().reshape(*xi.shape[:-1], nb, bw)
    r = torch.sigmoid(torch.einsum("...nb,nbc->...nc", xb, p["gate_a_w"])
                      + p["gate_a_b"])
    i = torch.sigmoid(torch.einsum("...nb,nbc->...nc", xb, p["gate_i_w"])
                      + p["gate_i_b"])
    return r.reshape(xi.shape), i.reshape(xi.shape)


def _log_a(p: Dict[str, torch.Tensor], r: torch.Tensor) -> torch.Tensor:
    return -_C * F.softplus(p["lam"]) * r


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1 with h_{-1} = 0, by a
    log-depth scan: after round r, (a_t, b_t) hold the composition of the
    steps t - 2^(r+1) + 1 .. t."""
    L = a.shape[1]
    off = 1
    while off < L:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        b = torch.cat([b[:, :off], a[:, off:] * b_prev + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a_prev], dim=1)
        off *= 2
    return b


def rglru_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: ModelConfig, h0: Optional[torch.Tensor] = None):
    """Train/prefill. x (B, L, d) -> (out (B, L, d), final h (B, lru))."""
    dt = x.dtype
    y = F.gelu(x @ p["in_y"].to(dt), approximate="tanh")
    xi = causal_conv(x @ p["in_x"].to(dt), p["conv_w"].to(dt),
                      p["conv_b"].to(dt))
    r, i = _gates(p, xi)
    log_a = _log_a(p, r)                                     # (B, L, lru) f32
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xi.float())
    if h0 is not None:
        gated = torch.cat([gated[:, :1] + a[:, :1] * h0[:, None],
                           gated[:, 1:]], dim=1)
    h = linear_scan(a, gated)
    out = (h.to(dt) * y) @ p["out"].to(dt)
    return out, h[:, -1]


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    """The conv window in ``dtype``, the recurrent state in f32."""
    lru = cfg.lru_width or cfg.d_model
    return {"conv": torch.zeros((batch, CONV_W - 1, lru), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, lru), dtype=torch.float32,
                             device=device)}


def rglru_decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], cfg: ModelConfig):
    """One-token step. x (B, 1, d) -> (out (B, 1, d), cache), the cache
    written in place."""
    dt = x.dtype
    y = F.gelu(x[:, 0] @ p["in_y"].to(dt), approximate="tanh")
    xi_lin = x[:, 0] @ p["in_x"].to(dt)                       # (B, lru)
    conv_in = torch.cat([cache["conv"].to(dt), xi_lin[:, None, :]], dim=1)
    xi = conv_step(conv_in, p["conv_w"].to(dt), p["conv_b"].to(dt))
    r, i = _gates(p, xi)
    log_a = _log_a(p, r)
    a = torch.exp(log_a)
    h = a * cache["h"] + torch.sqrt(
        torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xi.float())
    cache["conv"].copy_(conv_in[:, 1:, :])
    cache["h"].copy_(h)
    out = ((h.to(dt) * y) @ p["out"].to(dt))[:, None, :]
    return out, cache
