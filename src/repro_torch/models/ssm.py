"""Mamba-2 SSD (state-space duality) block: chunked forward, recurrent decode.

Port of ``repro/models/ssm.py`` (the minimal SSD algorithm of
arXiv:2405.21060 §6): within each chunk an attention-like quadratic term,
across chunks a state recurrence. The reference scans the chunks with
``lax.scan``; here it is a loop over the chunks. The reference computes SSD
outside any Pallas kernel, and so does the port: matrix products and
elementwise operations, no kernel of its own.

The decode step writes the cache (``conv``, ``state``) in place and returns
it, as the attention layers' decode does; its conv is ``common.conv_step``,
which rounds as the forward's conv does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (causal_conv, conv_step, dense_init,
                                       rms_norm)


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def init_ssm(gen: torch.Generator, cfg: ModelConfig,
             dtype) -> Dict[str, torch.Tensor]:
    """Weights in ``dtype``; ``dt_bias``, ``A_log`` and ``D`` in f32, as the
    reference keeps them."""
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    cd = conv_dim(cfg)
    dev = gen.device
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * G * N + H), d, dtype),
        "conv_w": dense_init(gen, (cfg.ssm_conv_width, cd),
                             cfg.ssm_conv_width, dtype),
        "conv_b": torch.zeros((cd,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((H,), dtype=f32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=dev)),
        "D": torch.ones((H,), dtype=f32, device=dev),
        "norm_w": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (di, d), di, dtype),
    }


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum_{j<k<=i} dA[..., k] for
    i >= j, -inf above the diagonal."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]               # (..., i, j)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, seg, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x (B, L, H, P), dt (B, L, H), A (H,), Bm/Cm (B, L, G, N)
    -> (y (B, L, H, P) f32, final state (B, H, P, N) f32).

    When ``L`` is no multiple of the chunk, the tail is padded with
    ``dt = 0`` steps: decay exp(0) = 1 and zero input, an exact no-op."""
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, L)
    L0 = L
    if L % Q:
        pad = Q - L % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        L = L + pad
    nc = L // Q

    xc = x.reshape(B, nc, Q, H, P).float()
    dtc = dt.reshape(B, nc, Q, H).float()
    Bc = Bm.reshape(B, nc, Q, G, N).float()
    Cc = Cm.reshape(B, nc, Q, G, N).float()

    dA = dtc * A                                            # (B,nc,Q,H) < 0
    dA_hq = dA.movedim(-1, -2)                              # (B,nc,H,Q)
    cum = torch.cumsum(dA_hq, dim=-1)
    dt_hq = dtc.movedim(-1, -2)                             # (B,nc,H,Q)

    # within-chunk (quadratic, attention-like)
    Lmat = torch.exp(_segsum(dA_hq))                        # (B,nc,H,Q,Q)
    scores = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)     # (B,nc,G,Q,Q)
    scores = scores.repeat_interleave(rep, dim=2)           # (B,nc,H,Q,Q)
    M = scores * Lmat * dt_hq[..., None, :]
    Yd = torch.einsum("bchij,bcjhp->bcihp", M, xc)          # (B,nc,Q,H,P)

    # chunk states
    decay_states = torch.exp(cum[..., -1:] - cum)           # (B,nc,H,Q)
    sdt = (decay_states * dt_hq).movedim(-1, -2)            # (B,nc,Q,H)
    S = torch.einsum("bcjgn,bcjh,bcjhp->bchpn", Bc, sdt, xc)  # (B,nc,H,P,N)

    # inter-chunk recurrence, the state before each chunk
    chunk_decay = torch.exp(cum[..., -1])                   # (B,nc,H)
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (B,nc,H,P,N)

    # inter-chunk output
    state_decay = torch.exp(cum)                            # (B,nc,H,Q)
    Ch = Cc.repeat_interleave(rep, dim=3)                   # (B,nc,Q,H,N)
    Yo = torch.einsum("bcihn,bchpn,bchi->bcihp", Ch, prev_states,
                      state_decay)

    y = (Yd + Yo).reshape(B, L, H, P)[:, :L0]
    return y, state


def ssm_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """The Mamba-2 block, train/prefill. x (B, L, d) -> (B, L, d)."""
    B, L, _ = x.shape
    di, G, N, H = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    P = cfg.ssm_headdim
    cdt = x.dtype
    zxbcdt = x @ p["in_proj"].to(cdt)
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    xBC = F.silu(causal_conv(xBC, p["conv_w"].to(cdt),
                              p["conv_b"].to(cdt)))
    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    y, _ = ssd_chunked(xs.reshape(B, L, H, P), dt, A,
                       Bm.reshape(B, L, G, N), Cm.reshape(B, L, G, N),
                       cfg.ssm_chunk)
    y = y + p["D"].float()[:, None] * xs.reshape(B, L, H, P).float()
    y = y.reshape(B, L, di).to(cdt)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"].to(cdt)


# --- decode -------------------------------------------------------------------
def init_ssm_cache(cfg: ModelConfig, batch: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    """The conv window in ``dtype``, the SSM state in f32."""
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim(cfg)),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
    }


def ssm_decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cache: Dict[str, torch.Tensor], cfg: ModelConfig):
    """One-token step. x (B, 1, d) -> (y (B, 1, d), cache), the cache
    written in place."""
    B = x.shape[0]
    di, G, N, H = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    P = cfg.ssm_headdim
    cdt = x.dtype
    zxbcdt = x[:, 0] @ p["in_proj"].to(cdt)                 # (B, ...)
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)

    conv_in = torch.cat([cache["conv"].to(cdt), xBC[:, None, :]], dim=1)
    xBC = F.silu(conv_step(conv_in, p["conv_w"].to(cdt),
                            p["conv_b"].to(cdt)))
    cache["conv"].copy_(conv_in[:, 1:, :])

    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])              # (B, H)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)                                  # (B, H)
    xh = xs.reshape(B, H, P).float()
    Bh = Bm.reshape(B, G, N).repeat_interleave(H // G, dim=1)  # (B, H, N)
    Ch = Cm.reshape(B, G, N).repeat_interleave(H // G, dim=1)
    state = cache["state"] * dA[..., None, None] \
        + dt[..., None, None] * xh[..., None] * Bh[:, :, None, :].float()
    cache["state"].copy_(state)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch.float()) \
        + p["D"].float()[:, None] * xh
    y = y.reshape(B, di).to(cdt)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return (y @ p["out_proj"].to(cdt))[:, None, :], cache
