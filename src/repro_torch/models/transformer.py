"""Decoder-only LM of every decoder family: dense, MoE, SSM, hybrid, VLM.

Port of ``repro/models/transformer.py``. Layers are ``global`` and
``local`` attention (full-sequence forward through ``full_attention``,
decoding through K5, by way of ``kernels/ops.py``), ``ssm`` (Mamba-2 SSD,
``models/ssm.py``) and ``recurrent`` (RG-LRU, ``models/rglru.py``); the
MLP of an attention layer is the MoE block when the config has experts.

Differences from the reference, all of form, none of result:

* Parameters are nested dicts of tensors with one entry per layer
  (``params["layers"][l]``); the reference stacks each position of the
  layer pattern over the pattern groups and scans over them.
  ``params_from_jax`` unstacks a reference tree into this form.
* A decode cache is ``{"step": int, "global_pos"/"local_pos": (B, Lc)
  int32, "layers": [...]}``, one entry per layer: ``{"k", "v"}`` for
  attention, ``{"conv", "state"}`` for SSM and ``{"conv", "h"}`` for
  RG-LRU layers. ``decode_step_lm`` writes this step into it in place and
  returns it, where the reference returns a new tree: a full-width cache
  is rewritten one slot per step instead of copied whole. The step is a
  host integer, so slot indices cost no device round trip.

Full-sequence attention takes one of two routes, by a stated rule
(``full_attention``): when autograd records it (grad mode on and q, k or v
requires grad), the chunked path of ``models/attention.py`` with the
reference's 1024-query and 1024-key chunks, which is the reference's
``xla`` route and what the reference trains through (K4 has no backward,
there or here); otherwise K4 (its plain version on the CPU). ``remat=True``
wraps each pattern group in ``torch.utils.checkpoint``, as the reference
wraps its scan body in ``jax.checkpoint``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, reduce_config
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (apply_rope, dense_init, dtype_of,
                                       pad_vocab, pattern_split, rms_norm)

Params = Dict[str, Any]


# ===========================================================================
# attention sub-block
# ===========================================================================
def init_attn(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, H, Dh), d, dtype),
        "wk": dense_init(gen, (d, K, Dh), d, dtype),
        "wv": dense_init(gen, (d, K, Dh), d, dtype),
        "wo": dense_init(gen, (H, Dh, d), H * Dh, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((Dh,), dtype=dtype, device=dev)
        p["k_norm"] = torch.zeros((Dh,), dtype=dtype, device=dev)
    if cfg.attn_bias:
        p["bq"] = torch.zeros((H, Dh), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((K, Dh), dtype=dtype, device=dev)
        p["bo"] = torch.zeros((d,), dtype=dtype, device=dev)
    return p


def _rope_theta(cfg: ModelConfig, kind: str) -> float:
    if kind == "local" and cfg.rope_local_theta is not None:
        return cfg.rope_local_theta
    return cfg.rope_theta


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matrix product."""
    d, H, Dh = w.shape
    return (x @ w.reshape(d, H * Dh).to(x.dtype)).reshape(
        x.shape[:-1] + (H, Dh))


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, kind: str):
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        theta = _rope_theta(cfg, kind)
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def _out_proj(p: Params, out: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", out, wo) (+ bo)."""
    H, Dh, d = p["wo"].shape
    y = out.reshape(out.shape[:-2] + (H * Dh,)) @ \
        p["wo"].reshape(H * Dh, d).to(out.dtype)
    if "bo" in p:
        y = y + p["bo"].to(y.dtype)
    return y


TRAIN_CHUNK = 1024     # the reference's q_chunk = k_chunk on its xla route


def records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an operation on ``tensors``: grad mode is
    on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window, softcap: float = 0.0,
                   q_offset: int = 0) -> torch.Tensor:
    """Full-sequence attention. q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D).

    The training route when autograd records it (``records_grad``): the
    reference's chunked ``xla`` path (``attention.chunked_attention``,
    1024-key chunks), on either device. Otherwise K4 (eval, prefill,
    serving). K4 refuses inputs that require grad under grad mode, so a
    kernel output never drops a gradient."""
    if records_grad(q, k, v):
        return attn_mod.chunked_attention(
            q, k, v, causal=causal, window=window, softcap=softcap,
            q_chunk=TRAIN_CHUNK, k_chunk=TRAIN_CHUNK, q_offset=q_offset)
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset)


def attn_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str,
               q_offset: int = 0, causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (train/prefill), by ``full_attention``."""
    S = x.shape[1]
    positions = q_offset + torch.arange(S, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions, kind)
    window = cfg.local_window if kind == "local" else None
    out = full_attention(q, k, v, causal=causal, window=window,
                         softcap=cfg.logit_softcap, q_offset=q_offset)
    return _out_proj(p, out)


def attn_decode(p: Params, x: torch.Tensor, kv_cache: Dict[str, torch.Tensor],
                cache_pos: torch.Tensor, step: int, cfg: ModelConfig,
                kind: str):
    """One-token attention through K5. kv_cache: {"k","v"} (B, Lc, K, Dh);
    this step's K/V go into slot ``step mod Lc`` (local ring) or
    ``min(step, Lc - 1)`` (global), in place."""
    B = x.shape[0]
    Lc = kv_cache["k"].shape[1]
    pos_b = torch.full((B,), step, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, pos_b[:, None], kind)
    idx = step % Lc if kind == "local" else min(step, Lc - 1)
    kv_cache["k"][:, idx] = k[:, 0].to(kv_cache["k"].dtype)
    kv_cache["v"][:, idx] = v[:, 0].to(kv_cache["v"].dtype)
    window = cfg.local_window if kind == "local" else None
    out = ops.decode_attention(q, kv_cache["k"], kv_cache["v"], cache_pos,
                               pos_b, window=window,
                               softcap=cfg.logit_softcap)
    return _out_proj(p, out), kv_cache


# ===========================================================================
# layer init / apply / decode by kind
# ===========================================================================
def init_layer(kind: str, cfg: ModelConfig, gen: torch.Generator,
               dtype) -> Params:
    d, dev = cfg.d_model, gen.device
    if kind == "ssm":
        return {"ln1": torch.zeros((d,), dtype=dtype, device=dev),
                "ssm": ssm_mod.init_ssm(gen, cfg, dtype)}
    p: Params = {"ln1": torch.zeros((d,), dtype=dtype, device=dev),
                 "ln2": torch.zeros((d,), dtype=dtype, device=dev)}
    if kind == "recurrent":
        p["rec"] = rglru_mod.init_rglru(gen, cfg, dtype)
    else:
        p["attn"] = init_attn(gen, cfg, dtype)
    if cfg.n_experts and kind in ("global", "local"):
        p["moe"] = mlp_mod.init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = mlp_mod.init_mlp(gen, cfg, dtype)
    return p


def apply_layer(kind: str, p: Params, x: torch.Tensor, cfg: ModelConfig,
                q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux_loss); aux is the MoE router's loss, else 0."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "ssm":
        return x + ssm_mod.ssm_forward(p["ssm"], h, cfg), aux
    if kind == "recurrent":
        y, _ = rglru_mod.rglru_forward(p["rec"], h, cfg)
    else:
        y = attn_apply(p["attn"], h, cfg, kind, q_offset)
    x = x + y
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        y, aux = mlp_mod.moe_block(p["moe"], h, cfg)
    else:
        y = mlp_mod.mlp_block(p["mlp"], h, cfg)
    return x + y, aux


def init_layer_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, device) -> Dict[str, torch.Tensor]:
    if kind == "ssm":
        return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    if kind == "recurrent":
        return rglru_mod.init_rglru_cache(cfg, batch, dtype, device)
    Lc = min(cfg.local_window, max_len) if kind == "local" else max_len
    shape = (batch, Lc, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_layer(kind: str, p: Params, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor],
                 pos_tree: Mapping[str, torch.Tensor], step: int,
                 cfg: ModelConfig):
    """Returns (x, cache). pos_tree: {"global": (B, Lg), "local": (B, Ll)}."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "ssm":
        y, cache = ssm_mod.ssm_decode(p["ssm"], h, cache, cfg)
        return x + y, cache
    if kind == "recurrent":
        y, cache = rglru_mod.rglru_decode(p["rec"], h, cache, cfg)
    else:
        y, cache = attn_decode(p["attn"], h, cache, pos_tree[kind], step,
                               cfg, kind)
    x = x + y
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        y, _ = mlp_mod.moe_block(p["moe"], h, cfg)
    else:
        y = mlp_mod.mlp_block(p["mlp"], h, cfg)
    return x + y, cache


# ===========================================================================
# whole-model init
# ===========================================================================
def init_lm(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random params of ``cfg`` drawn from ``gen``, on its device."""
    dtype = dtype_of(cfg.param_dtype)
    Vp = pad_vocab(cfg.vocab_size)
    d = cfg.d_model
    params: Params = {
        "embed": dense_init(gen, (Vp, d), d, dtype),
        "final_norm": torch.zeros((d,), dtype=dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, Vp), d, dtype)
    params["layers"] = [init_layer(kind, cfg, gen, dtype)
                        for kind in cfg.layer_kinds]
    return params


def _leaf_names(tree: Mapping[str, Any], prefix: str = "") -> List[str]:
    names = []
    for k, v in tree.items():
        if isinstance(v, Mapping):
            names += _leaf_names(v, f"{prefix}{k}.")
        else:
            names.append(f"{prefix}{k}")
    return sorted(names)


def _map_leaves(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def _zip_leaves(fn, tree, like):
    """``fn(leaf, like_leaf)`` over two dicts of the same structure."""
    if isinstance(tree, Mapping):
        return {k: _zip_leaves(fn, v, like[k]) for k, v in tree.items()}
    return fn(tree, like)


def params_to(params: Params, device) -> Params:
    """A copy of ``params`` on ``device``."""
    return _map_leaves(lambda t: t.to(device, copy=True), params)


def unstack_params(cfg: ModelConfig, tree: Mapping[str, Any]) -> Params:
    """The reference's ``init_lm`` tree as this package's structure, leaves
    picked but not converted (numpy arrays stay numpy arrays).

    The reference stacks position ``i`` of the layer pattern over the
    ``n_groups`` pattern groups (``tree["pattern"][i]``, leading axis
    ``n_groups``) and keeps the remainder layers unstacked
    (``tree["rest"]``); this unstacks them into one entry per layer, in
    ``cfg.layer_kinds`` order. Any tree of that structure works (the adam
    moments of a checkpoint too). Raises if the tree does not hold exactly
    the parameters of ``cfg``.
    """
    n_groups, pattern, rest = pattern_split(cfg)
    top = {"embed", "final_norm", "pattern", "rest"}
    if not cfg.tie_embeddings:
        top.add("lm_head")
    if set(tree) != top:
        raise ValueError(f"unstack_params: top-level keys {sorted(tree)}"
                         f" do not match {sorted(top)}")
    if len(tree["pattern"]) != len(pattern) \
            or len(tree["rest"]) != len(rest):
        raise ValueError("unstack_params: the tree has "
                         f"{len(tree['pattern'])} pattern positions and "
                         f"{len(tree['rest'])} rest layers, {cfg.name} "
                         f"has {len(pattern)} and {len(rest)}")
    unstacked: List[Tuple[str, Mapping[str, Any]]] = []
    for g in range(n_groups):
        for i, kind in enumerate(pattern):
            def pick(a, g=g, i=i):
                if a.ndim == 0 or a.shape[0] != n_groups:
                    raise ValueError(
                        f"unstack_params: pattern[{i}] leaf of shape "
                        f"{tuple(a.shape)} is not stacked over {n_groups} "
                        "groups")
                return a[g]
            unstacked.append((kind, _map_leaves(pick, tree["pattern"][i])))
    unstacked += list(zip(rest, tree["rest"]))
    layers = []
    for n, (kind, layer) in enumerate(unstacked):
        want = _leaf_names(_layer_probe(cfg, kind))
        if _leaf_names(layer) != want:
            raise ValueError(f"unstack_params: layer {n} ({kind}) has "
                             f"leaves {_leaf_names(layer)}, expected {want}")
        layers.append(layer)
    out: Params = {k: tree[k] for k in top - {"pattern", "rest"}}
    out["layers"] = layers
    return out


def stack_params(cfg: ModelConfig, params: Params, stack) -> Params:
    """The inverse of ``unstack_params``: the per-layer list as the
    reference's ``pattern`` (position ``i`` of the pattern stacked over the
    groups by ``stack(list of leaves)``) and ``rest``; other leaves as
    they are."""
    n_groups, pattern, rest = pattern_split(cfg)
    if n_groups == 0:
        raise ValueError(f"stack_params: {cfg.name} has no whole pattern "
                         "group to stack")
    P = len(pattern)
    layers = params["layers"]
    out = {k: v for k, v in params.items() if k != "layers"}
    out["pattern"] = [_stack_leaves(stack, layers[i:n_groups * P:P])
                      for i in range(P)]
    out["rest"] = list(layers[n_groups * P:])
    return out


def _stack_leaves(stack, trees):
    if isinstance(trees[0], Mapping):
        return {k: _stack_leaves(stack, [t[k] for t in trees])
                for k in trees[0]}
    return stack(trees)


@functools.lru_cache(maxsize=64)
def _layer_probe(cfg: ModelConfig, kind: str) -> Params:
    """A tiny layer of ``kind`` with ``cfg``'s structure, in its param
    dtype: the leaf names and dtypes of the kind (from ``reduce_config``).
    Read only."""
    return init_layer(kind, reduce_config(cfg),
                      torch.Generator().manual_seed(0),
                      dtype_of(cfg.param_dtype))


def params_from_jax(cfg: ModelConfig, np_tree: Mapping[str, Any],
                    device) -> Params:
    """The reference's ``init_lm`` tree (numpy leaves) as this package's
    params on ``device``, each leaf in the reference's dtype: ``cfg``'s
    param dtype, but f32 for the MoE router, the SSM's ``dt_bias``,
    ``A_log`` and ``D`` and the RG-LRU's gates and ``lam``. Unstacked by
    ``unstack_params``, which raises if the tree does not hold exactly the
    parameters of ``cfg``.
    """
    dtype = dtype_of(cfg.param_dtype)
    tree = unstack_params(cfg, _map_leaves(np.asarray, np_tree))

    def conv(leaf, dt=dtype):
        return torch.tensor(np.asarray(leaf, np.float32),
                            device=device).to(dt)

    out: Params = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [
        _zip_leaves(lambda a, t: conv(a, t.dtype), layer,
                    _layer_probe(cfg, kind))
        for layer, kind in zip(tree["layers"], cfg.layer_kinds)]
    return out


# ===========================================================================
# forward (prefill / loss)
# ===========================================================================
def embed_tokens(params: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x.to(dtype_of(cfg.compute_dtype))


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def _apply_layers(kinds, layers, x, aux, cfg: ModelConfig):
    for p, kind in zip(layers, kinds):
        x, a = apply_layer(kind, p, x, cfg)
        aux = aux + a
    return x, aux


def forward_lm(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
               remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, Vp), aux_loss).

    ``remat`` recomputes each pattern group's activations in the backward
    (``checkpoint(use_reentrant=False)`` around the group, as the
    reference's ``jax.checkpoint`` around its scan body); the remainder
    layers are not wrapped."""
    n_groups, pattern, rest = pattern_split(cfg)
    P = len(pattern)
    x = embed_tokens(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = params["layers"]
    for g in range(n_groups):
        group = layers[g * P:(g + 1) * P]
        if remat:
            x, aux = checkpoint(_apply_layers, pattern, group, x, aux, cfg,
                                use_reentrant=False)
        else:
            x, aux = _apply_layers(pattern, group, x, aux, cfg)
    x, aux = _apply_layers(rest, layers[n_groups * P:], x, aux, cfg)
    return unembed(params, x, cfg), aux


def lm_loss(params: Params, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig, *, remat: bool = False) -> torch.Tensor:
    """batch: {"tokens": (B,S), "targets": (B,S)} -> scalar mean xent."""
    logits, aux = forward_lm(params, batch["tokens"], cfg, remat=remat)
    Vp = logits.shape[-1]
    mask = torch.arange(Vp, device=logits.device) < cfg.vocab_size
    logits = torch.where(mask, logits.float(), -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, batch["targets"].long()[..., None])[..., 0]
    return torch.mean(logz - tgt) + cfg.router_aux_weight * aux


# ===========================================================================
# decode (serve step)
# ===========================================================================
def init_cache_lm(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device) -> Dict[str, Any]:
    cache: Dict[str, Any] = {"step": 0}
    kinds = set(cfg.layer_kinds)
    if "global" in kinds:
        cache["global_pos"] = torch.full((batch, max_len), -1,
                                         dtype=torch.int32, device=device)
    if "local" in kinds:
        Ll = min(cfg.local_window, max_len)
        cache["local_pos"] = torch.full((batch, Ll), -1, dtype=torch.int32,
                                        device=device)
    cache["layers"] = [init_layer_cache(kind, cfg, batch, max_len, dtype,
                                        device)
                       for kind in cfg.layer_kinds]
    return cache


def _cache_pos_views(cache: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    views = {}
    if "global_pos" in cache:
        views["global"] = cache["global_pos"]
    if "local_pos" in cache:
        views["local"] = cache["local_pos"]
    return views


def decode_step_lm(params: Params, cache: Dict[str, Any],
                   tokens: torch.Tensor, cfg: ModelConfig):
    """One decode step. tokens (B, 1) -> (logits (B, 1, Vp), cache).

    The position rings are written first, so this step's K/V slot is valid
    when the layers attend: a global cache writes slot ``min(step, Lg-1)``
    (past its end it keeps overwriting the last slot, as the reference
    does), a local ring slot ``step mod Ll``.
    """
    step = int(cache["step"])
    if "global_pos" in cache:
        Lg = cache["global_pos"].shape[1]
        cache["global_pos"][:, min(step, Lg - 1)] = step
    if "local_pos" in cache:
        Ll = cache["local_pos"].shape[1]
        cache["local_pos"][:, step % Ll] = step
    pos_tree = _cache_pos_views(cache)
    x = embed_tokens(params, tokens, cfg)
    for n, (p, kind) in enumerate(zip(params["layers"], cfg.layer_kinds)):
        x, cache["layers"][n] = decode_layer(kind, p, x, cache["layers"][n],
                                             pos_tree, step, cfg)
    cache["step"] = step + 1
    return unembed(params, x, cfg), cache


def prefill_into_cache(params: Params, cache: Dict[str, Any],
                       tokens: torch.Tensor, cfg: ModelConfig):
    """Fill the cache by running ``decode_step_lm`` over the prompt, as the
    reference does. tokens (B, S) -> (cache, logits (B, S, Vp))."""
    logits = []
    for t in range(tokens.shape[1]):
        step_logits, cache = decode_step_lm(params, cache, tokens[:, t:t + 1],
                                            cfg)
        logits.append(step_logits[:, 0])
    return cache, torch.stack(logits, dim=1)
