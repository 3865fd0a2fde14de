"""Whisper-style encoder-decoder backbone.

Port of ``repro/models/encdec.py``. The audio frontend is a stub, as
there: the encoder takes precomputed frame embeddings (B, n_frames,
d_model). Sinusoidal absolute positions; bidirectional encoder
self-attention (non-causal); a decoder with causal self-attention
(teacher-forced, or K5 when decoding) and cross-attention to the encoder
states (non-causal, against all ``n_frames`` keys: ``Sq = S``
teacher-forced, ``Sq = 1`` per decode step). Full-sequence attention goes
through ``transformer.full_attention``: the chunked training route when
autograd records it, K4 otherwise. ``remat=True`` recomputes each decoder
layer in the backward, as the reference checkpoints its decoder's scan
body; the encoder is not wrapped, as there.

Differences from the reference, all of form, none of result:

* Encoder and decoder layers are lists (``params["enc"][l]``,
  ``params["dec"][l]``); the reference stacks them with ``vmap`` and scans.
  ``params_from_jax`` unstacks a reference tree.
* A decode cache is ``{"step": int, "pos": (B, max_len) int32, "self":
  [{"k", "v"}, ...], "cross": [{"k", "v"}, ...]}``, one entry per decoder
  layer. ``fill_cross_cache`` and ``decode_step_encdec`` write it in place
  and return it.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, reduce_config
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import dense_init, dtype_of, pad_vocab, rms_norm
from repro_torch.models.transformer import (
    _heads, _leaf_names, _map_leaves, _out_proj, _stack_leaves, _zip_leaves,
    attn_apply, attn_decode, full_attention, init_attn,
)

Params = Dict[str, Any]


def sinusoid_positions(seq: int, d: int, offset: int = 0,
                       device=None) -> torch.Tensor:
    """(seq, d) f32: sin of the first d/2 frequencies, then cos."""
    pos = offset + torch.arange(seq, dtype=torch.float32,
                                device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2.0 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --- init ---------------------------------------------------------------------
def _init_enc_layer(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    d, dev = cfg.d_model, gen.device
    p = {"ln1": torch.zeros((d,), dtype=dtype, device=dev)}
    p["attn"] = init_attn(gen, cfg, dtype)
    p["ln2"] = torch.zeros((d,), dtype=dtype, device=dev)
    p["mlp"] = mlp_mod.init_mlp(gen, cfg, dtype)
    return p


def _init_dec_layer(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    p = _init_enc_layer(cfg, gen, dtype)
    p["lnx"] = torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)
    p["cross"] = init_attn(gen, cfg, dtype)
    return p


def init_encdec(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random params of ``cfg`` drawn from ``gen``, on its device."""
    dtype = dtype_of(cfg.param_dtype)
    d, dev = cfg.d_model, gen.device
    return {
        "embed": dense_init(gen, (pad_vocab(cfg.vocab_size), d), d, dtype),
        "enc_norm": torch.zeros((d,), dtype=dtype, device=dev),
        "final_norm": torch.zeros((d,), dtype=dtype, device=dev),
        "enc": [_init_enc_layer(cfg, gen, dtype)
                for _ in range(cfg.encoder_layers)],
        "dec": [_init_dec_layer(cfg, gen, dtype)
                for _ in range(cfg.num_layers)],
    }


_LAYERS = (("enc", "encoder_layers", _init_enc_layer),
           ("dec", "num_layers", _init_dec_layer))


def unstack_params(cfg: ModelConfig, tree: Mapping[str, Any]) -> Params:
    """The reference's ``init_encdec`` tree (``enc`` and ``dec`` stacked
    over their layers) as this package's structure, leaves picked but not
    converted. Any tree of that structure works (adam moments too). Raises
    if the tree does not hold exactly the parameters of ``cfg``."""
    top = {"embed", "enc_norm", "final_norm", "enc", "dec"}
    if set(tree) != top:
        raise ValueError(f"unstack_params: top-level keys {sorted(tree)}"
                         f" do not match {sorted(top)}")
    out: Params = {k: tree[k] for k in ("embed", "enc_norm", "final_norm")}
    for key, n_attr, init in _LAYERS:
        n = getattr(cfg, n_attr)
        probe = _probe(cfg, init)
        if _leaf_names(tree[key]) != _leaf_names(probe):
            raise ValueError(f"unstack_params: {key} has leaves "
                             f"{_leaf_names(tree[key])}, expected "
                             f"{_leaf_names(probe)}")

        def pick(a, i, key=key, n=n):
            if a.ndim == 0 or a.shape[0] != n:
                raise ValueError(f"unstack_params: {key} leaf of shape "
                                 f"{tuple(a.shape)} is not stacked over {n} "
                                 "layers")
            return a[i]
        out[key] = [_zip_leaves(lambda a, _t, i=i: pick(a, i), tree[key],
                                probe) for i in range(n)]
    return out


def stack_params(cfg: ModelConfig, params: Params, stack) -> Params:
    """The inverse of ``unstack_params``: ``enc`` and ``dec`` stacked over
    their layers by ``stack(list of leaves)``; other leaves as they are."""
    del cfg
    out = {k: v for k, v in params.items() if k not in ("enc", "dec")}
    for key, _, _ in _LAYERS:
        out[key] = _stack_leaves(stack, params[key])
    return out


def _probe(cfg: ModelConfig, init) -> Params:
    """A tiny layer of ``cfg``'s structure in its param dtype (names and
    dtypes only)."""
    return init(reduce_config(cfg), torch.Generator().manual_seed(0),
                dtype_of(cfg.param_dtype))


def params_from_jax(cfg: ModelConfig, np_tree: Mapping[str, Any],
                    device) -> Params:
    """The reference's ``init_encdec`` tree (numpy leaves; ``enc`` and
    ``dec`` stacked over their layers) as this package's params on
    ``device``, in ``cfg.param_dtype``. Unstacked by ``unstack_params``,
    which raises if the tree does not hold exactly the parameters of
    ``cfg``."""
    dtype = dtype_of(cfg.param_dtype)
    tree = unstack_params(cfg, _map_leaves(np.asarray, np_tree))

    def conv(leaf):
        return torch.tensor(np.asarray(leaf, np.float32),
                            device=device).to(dtype)

    return _map_leaves(conv, tree)


# --- attention helpers ----------------------------------------------------------
def _cross_attn(p: Params, x: torch.Tensor,
                kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """x (B, S, d) queries; kv = (k, v) precomputed (B, F, K, Dh);
    non-causal over all F keys, by ``full_attention``."""
    k, v = kv
    dt = x.dtype
    q = _heads(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(dt)
    out = full_attention(q, k.to(dt), v.to(dt), causal=False, window=None)
    return _out_proj(p, out)


def cross_kv(p: Params, enc_out: torch.Tensor):
    dt = enc_out.dtype
    k = _heads(enc_out, p["wk"])
    v = _heads(enc_out, p["wv"])
    if "bv" in p:
        v = v + p["bv"].to(dt)
    return k, v


# --- forward --------------------------------------------------------------------
def encode(params: Params, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames (B, F, d_model) stub embeddings -> encoder states (B, F, d)."""
    dt = dtype_of(cfg.compute_dtype)
    x = frames.to(dt) + sinusoid_positions(
        frames.shape[1], cfg.d_model, device=frames.device).to(dt)
    for lp in params["enc"]:
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attn_apply(lp["attn"], h, cfg, "global", causal=False)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp_mod.mlp_block(lp["mlp"], h, cfg)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["embed"].T.to(x.dtype)


def _dec_layer(lp: Params, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + attn_apply(lp["attn"], h, cfg, "global", causal=True)
    h = rms_norm(x, lp["lnx"], cfg.norm_eps)
    x = x + _cross_attn(lp["cross"], h, cross_kv(lp["cross"], enc_out))
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp_mod.mlp_block(lp["mlp"], h, cfg)


def decode_full(params: Params, enc_out: torch.Tensor, tokens: torch.Tensor,
                cfg: ModelConfig, *, remat: bool = False) -> torch.Tensor:
    """Teacher-forced decoder pass. tokens (B, S) -> logits (B, S, Vp)."""
    dt = dtype_of(cfg.compute_dtype)
    x = params["embed"][tokens.long()].to(dt)
    x = x + sinusoid_positions(tokens.shape[1], cfg.d_model,
                               device=x.device).to(dt)
    for lp in params["dec"]:
        if remat:
            x = checkpoint(_dec_layer, lp, x, enc_out, cfg,
                           use_reentrant=False)
        else:
            x = _dec_layer(lp, x, enc_out, cfg)
    return _logits(params, x, cfg)


def forward_encdec(params: Params, batch: Mapping[str, torch.Tensor],
                   cfg: ModelConfig, *, remat: bool = False) -> torch.Tensor:
    enc_out = encode(params, batch["frames"], cfg)
    return decode_full(params, enc_out, batch["tokens"], cfg, remat=remat)


def encdec_loss(params: Params, batch: Mapping[str, torch.Tensor],
                cfg: ModelConfig, *, remat: bool = False) -> torch.Tensor:
    logits = forward_encdec(params, batch, cfg, remat=remat)
    Vp = logits.shape[-1]
    mask = torch.arange(Vp, device=logits.device) < cfg.vocab_size
    logits = torch.where(mask, logits.float(), -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, batch["targets"].long()[..., None])[..., 0]
    return torch.mean(logz - tgt)


# --- decode (serve step) ----------------------------------------------------------
def init_cache_encdec(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device) -> Dict[str, Any]:
    K, Dh = cfg.n_kv_heads, cfg.head_dim

    def kv(n):
        return {"k": torch.zeros((batch, n, K, Dh), dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, n, K, Dh), dtype=dtype,
                                 device=device)}
    return {"step": 0,
            "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device),
            "self": [kv(max_len) for _ in range(cfg.num_layers)],
            "cross": [kv(cfg.n_frames) for _ in range(cfg.num_layers)]}


def fill_cross_cache(params: Params, cache: Dict[str, Any],
                     frames: torch.Tensor, cfg: ModelConfig):
    """Run the encoder and write every layer's cross K/V into ``cache``
    (the serving prefill); returns the cache."""
    enc_out = encode(params, frames, cfg)
    for lp, c in zip(params["dec"], cache["cross"]):
        k, v = cross_kv(lp["cross"], enc_out)
        c["k"].copy_(k)
        c["v"].copy_(v)
    return cache


def decode_step_encdec(params: Params, cache: Dict[str, Any],
                       tokens: torch.Tensor, cfg: ModelConfig):
    """One decoder token. tokens (B, 1) -> (logits (B, 1, Vp), cache).

    The position ring is written first (slot ``min(step, max_len - 1)``),
    so this step's self-attention slot is valid when the layers attend."""
    dt = dtype_of(cfg.compute_dtype)
    step = int(cache["step"])
    Lc = cache["pos"].shape[1]
    cache["pos"][:, min(step, Lc - 1)] = step
    x = params["embed"][tokens.long()].to(dt)
    x = x + sinusoid_positions(1, cfg.d_model, offset=step,
                               device=x.device).to(dt)
    for n, lp in enumerate(params["dec"]):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, cache["self"][n] = attn_decode(lp["attn"], h, cache["self"][n],
                                          cache["pos"], step, cfg, "global")
        x = x + y
        h = rms_norm(x, lp["lnx"], cfg.norm_eps)
        cross = cache["cross"][n]
        x = x + _cross_attn(lp["cross"], h, (cross["k"], cross["v"]))
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp_mod.mlp_block(lp["mlp"], h, cfg)
    cache["step"] = step + 1
    return _logits(params, x, cfg), cache

