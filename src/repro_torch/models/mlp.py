"""Dense MLP block (SwiGLU or plain GELU) and the MoE block.

Port of ``repro/models/mlp.py``. The MoE block keeps the reference's
group-local, gather-only dispatch: each batch row is a dispatch group, the
(token, choice) pairs are sorted by expert with a stable sort, every data
movement is a gather (the inverse permutation is ``argsort(argsort)``), the
capacity comes from the static shapes (no host sync), and pairs past an
expert's capacity point at a zero sentinel row and are dropped. The expert
FFNs are batched matrix products, as the reference leaves them to XLA
outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

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


# --- MoE ---------------------------------------------------------------------
def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype) -> Dict[str, torch.Tensor]:
    """Router in f32 (as the reference keeps it), experts in ``dtype``."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": dense_init(gen, (d, E), d, torch.float32),
         "w1": dense_init(gen, (E, d, ff), d, dtype),
         "w2": dense_init(gen, (E, ff, d), ff, dtype)}
    if cfg.activation == "silu":
        p["w3"] = dense_init(gen, (E, d, ff), d, dtype)
    return p


def moe_capacity(S: int, cfg: ModelConfig) -> int:
    """Slots per expert and group: from the static shapes alone."""
    k, E = cfg.top_k, cfg.n_experts
    cap = int(max(k, (S * k * cfg.capacity_factor) / E))
    return min(((cap + 7) // 8) * 8, S * k)


def moe_route(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The router and the dispatch plan of ``moe_block``. x: (B, S, d).

    Returns ``top_g`` (B, S, k) renormalised gates, ``top_i`` (B, S, k)
    experts, ``aux`` the Switch load-balancing loss, ``pos`` (B, S*k) the
    expert-major slot of each pair in sorted order (``E * cap`` = dropped),
    ``inv_order`` (B, S*k) its inverse permutation, ``tok_at`` (B, E*cap)
    the token in each (expert, slot) and ``valid_ec`` (B, E*cap) which
    slots hold one."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    P = S * k
    dev = x.device
    logits = torch.einsum("gsd,de->gse", x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)                   # (B, S, E)
    top_g, top_i = torch.topk(probs, k, dim=-1)             # (B, S, k)
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)

    # aux load-balancing loss (Switch-style, over all tokens)
    frac_routed = F.one_hot(top_i, E).float().sum(2).mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_routed / k * mean_prob)

    cap = moe_capacity(S, cfg)
    pair_e = top_i.reshape(B, P)
    pair_t = torch.arange(S, device=dev).repeat_interleave(k)[None, :] \
        .expand(B, P)
    order = torch.argsort(pair_e, dim=1, stable=True)      # stable per group
    inv_order = torch.argsort(order, dim=1, stable=True)   # inverse perm
    se = torch.take_along_dim(pair_e, order, dim=1)
    st = torch.take_along_dim(pair_t, order, dim=1)

    counts = (pair_e[:, :, None] == torch.arange(E, device=dev)).sum(1)
    starts = torch.cumsum(counts, dim=1) - counts           # (B, E) exclusive
    slot = torch.arange(P, device=dev)[None, :] - \
        torch.take_along_dim(starts, se, dim=1)
    pos = torch.where(slot < cap, se * cap + slot, E * cap)  # sentinel = drop

    # token index for each (expert, capacity slot): pure gathers
    slots = torch.arange(cap, device=dev)
    idx_ec = starts[:, :, None] + slots[None, None, :]      # (B, E, cap)
    valid_ec = (slots[None, None, :] < counts[:, :, None]).reshape(B, E * cap)
    idx_flat = torch.clamp(idx_ec.reshape(B, E * cap), 0, P - 1)
    tok_at = torch.take_along_dim(st, idx_flat, dim=1)     # (B, E*cap)
    return {"top_g": top_g, "top_i": top_i, "aux": aux, "cap": cap,
            "pos": pos, "inv_order": inv_order, "tok_at": tok_at,
            "valid_ec": valid_ec}


def moe_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k expert dispatch with capacity dropping. x: (B, S, d) ->
    (out (B, S, d), aux loss (f32 scalar))."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    act = act_fn(cfg.activation)
    dt = x.dtype
    r = moe_route(p, x, cfg)
    cap = r["cap"]
    xe = torch.gather(x, 1, r["tok_at"][..., None].expand(B, E * cap, d))
    xe = torch.where(r["valid_ec"][..., None], xe, torch.zeros((), dtype=dt,
                                                               device=x.device))
    xe = xe.reshape(B, E, cap, d)

    h = torch.einsum("gecd,edf->gecf", xe, p["w1"].to(dt))
    if cfg.activation == "silu":
        h = act(h) * torch.einsum("gecd,edf->gecf", xe, p["w3"].to(dt))
    else:
        h = act(h)
    ye = torch.einsum("gecf,efd->gecd", h, p["w2"].to(dt))  # (B, E, cap, d)

    ye_pad = torch.cat([ye.reshape(B, E * cap, d),
                        torch.zeros((B, 1, d), dtype=ye.dtype,
                                    device=x.device)], dim=1)
    pair_pos = torch.take_along_dim(r["pos"], r["inv_order"], dim=1)
    vals = torch.gather(ye_pad, 1, pair_pos[..., None].expand(B, S * k, d))
    out = torch.sum(vals.reshape(B, S, k, d)
                    * r["top_g"].reshape(B, S, k, 1).to(dt), dim=2)
    return out.to(dt), r["aux"]
