"""The paper's DLRM workloads: Wide&Deep (Model-X), xDeepFM (Model-Y), DCN
(Model-Z), and DLRM-DCNv2.

Port of ``repro/models/dlrm.py``. Sparse categorical features -> one pooled
embedding store for all tables -> one fused embedding-bag call (plus one
for the wide part of Wide&Deep) -> dense interaction network -> CTR logit.

Parameters are a flat ``{name: tensor}`` state dict whose names are the
paths of the reference's parameter tree: ``tables``, ``wide``,
``wide_dense``, ``mlp.w0`` … ``mlp.w_out``, ``mlp.b_out``, ``cross.w0``,
``cross_b.b0``, ``cin.w0`` … ``cin.w_out``. Weight matrices keep the
reference's ``(in, out)`` layout. Under a ``PaddedLayout`` the pooled
stores are ``(n_ps, max_range, D)`` padded arrays, as in the reference.

DLRM-DCNv2 (the port's own) adds ``bot.w{i}``/``bot.b{i}`` (the bottom
MLP over the dense features) and, per cross layer ``l``, ``cross.v{l}``
``(d_in, rank)``, ``cross.w{l}`` ``(rank, d_in)`` and ``cross_b.b{l}``
``(d_in,)``; ``mlp.*`` is its over arch. Its cross network,
``x_{l+1} = x0 * ((x_l V_l) W_l + b_l) + x_l``, runs as one autograd
Function whose forward and backward each record the span
``train_step.cross``. xDeepFM's CIN is one Function too, under the span
``train_step.cin``: the kernels of ``kernels/cin.py`` around ``torch.mm``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.dlrm_models import DLRMConfig
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init
from repro_torch.sharding.policy import constrain

Params = Dict[str, torch.Tensor]


def init_dlrm(cfg: DLRMConfig, generator: torch.Generator,
              layout=None) -> Params:
    """Fresh DLRM params on the generator's device.

    ``layout`` pads the pooled stores ("tables" and "wide") physically after
    every draw, so flat and padded inits hold the same row values.
    """
    D = cfg.embed_dim
    dev = generator.device
    params: Params = {
        "tables": dense_init(generator, (cfg.total_embedding_rows, D), D)}
    d_in = cfg.interaction_dim
    prev = d_in
    for li, h in enumerate(cfg.mlp_dims):
        params[f"mlp.w{li}"] = dense_init(generator, (prev, h), prev)
        params[f"mlp.b{li}"] = torch.zeros((h,), device=dev)
        prev = h
    params["mlp.w_out"] = dense_init(generator, (prev, 1), prev)
    params["mlp.b_out"] = torch.zeros((1,), device=dev)
    if cfg.kind == "wide_deep":
        params["wide"] = torch.zeros((cfg.total_embedding_rows, 1), device=dev)
        params["wide_dense"] = torch.zeros((cfg.n_dense,), device=dev)
    if cfg.kind == "dcn":
        for li in range(cfg.cross_layers):
            params[f"cross.w{li}"] = dense_init(generator, (d_in,), d_in)
        for li in range(cfg.cross_layers):
            params[f"cross_b.b{li}"] = torch.zeros((d_in,), device=dev)
    if cfg.kind == "dcnv2":
        prev = cfg.n_dense
        for li, h in enumerate(cfg.bottom_mlp_dims):
            params[f"bot.w{li}"] = dense_init(generator, (prev, h), prev)
            params[f"bot.b{li}"] = torch.zeros((h,), device=dev)
            prev = h
        r = cfg.cross_low_rank
        for li in range(cfg.cross_layers):
            params[f"cross.v{li}"] = dense_init(generator, (d_in, r), d_in)
            params[f"cross.w{li}"] = dense_init(generator, (r, d_in), r)
            params[f"cross_b.b{li}"] = torch.zeros((d_in,), device=dev)
    if cfg.kind == "xdeepfm":
        prev_maps = cfg.n_tables
        for li, maps in enumerate(cfg.cin_layers):
            params[f"cin.w{li}"] = dense_init(
                generator, (prev_maps, cfg.n_tables, maps),
                prev_maps * cfg.n_tables)
            prev_maps = maps
        params["cin.w_out"] = dense_init(
            generator, (sum(cfg.cin_layers),), sum(cfg.cin_layers))
    if layout is not None:
        for key in sparse_param_keys(cfg):
            params[key] = layout.pad_rows(params[key])
    return params


def params_from_jax(cfg: DLRMConfig, np_tree: Mapping[str, Any],
                    device) -> Params:
    """The reference's ``init_dlrm`` tree (numpy leaves, flat or padded
    stores) as this package's flat f32 params on ``device``.

    Raises if the tree does not hold exactly the parameters of ``cfg``.
    """
    out: Params = {}
    for key, val in np_tree.items():
        if isinstance(val, Mapping):
            for sub, leaf in val.items():
                out[f"{key}.{sub}"] = torch.tensor(
                    np.asarray(leaf, np.float32), device=device)
        else:
            out[key] = torch.tensor(np.asarray(val, np.float32), device=device)
    # the names of a one-row-per-table init of the same config
    probe = dataclasses.replace(cfg, table_rows=(1,) * cfg.n_tables)
    expected = set(init_dlrm(probe, torch.Generator().manual_seed(0)))
    if set(out) != expected:
        raise ValueError(f"params_from_jax: names {sorted(out)} do not match "
                         f"the {cfg.kind} parameters {sorted(expected)}")
    return out


class PooledStore(NamedTuple):
    """A pooled (vocab-row) store: its param key, the key of its bags in
    ``dlrm_embeddings``' output and their combiner (None: the plan's)."""
    param: str
    bag: str
    combiner: Optional[str] = None

    def bag_plan(self, plan):
        return plan.with_combiner(self.combiner) if self.combiner else plan


# The one table of the pooled stores, in update order: every model has the
# deep tables, only wide_deep the wide store.
POOLED_STORES = (PooledStore("tables", "deep"),
                 PooledStore("wide", "wide", "sum"))
POOLED_KEYS = frozenset(s.param for s in POOLED_STORES)


def pooled_stores(cfg: DLRMConfig) -> Tuple[PooledStore, ...]:
    """``cfg``'s stores, which the sparse backward and row update handle."""
    return POOLED_STORES if cfg.kind == "wide_deep" else POOLED_STORES[:1]


def sparse_param_keys(cfg: DLRMConfig) -> tuple:
    return tuple(s.param for s in pooled_stores(cfg))


def pool_rows(store: torch.Tensor) -> torch.Tensor:
    """A pooled store, flat (R, D) or padded (n_ps, max_range, D), as the
    engine's (rows, D) view, which shares its storage."""
    return store.reshape(-1, store.shape[-1])


def dlrm_embeddings(params: Mapping[str, torch.Tensor], batch, cfg: DLRMConfig,
                    plan) -> Dict[str, torch.Tensor]:
    """Every pooled-store lookup of one forward: ``{"deep": (B, n_tables,
    D)}`` plus ``{"wide": (B, n_tables, 1)}`` for wide_deep."""
    return {s.bag: ops.fused_embedding_bag(pool_rows(params[s.param]),
                                           batch["sparse"],
                                           plan=s.bag_plan(plan))
            for s in pooled_stores(cfg)}


def _deep_mlp(params, x, cfg: DLRMConfig):
    h = x
    for li in range(len(cfg.mlp_dims)):
        h = torch.relu(h @ params[f"mlp.w{li}"] + params[f"mlp.b{li}"])
    return (h @ params["mlp.w_out"] + params["mlp.b_out"])[:, 0]


class _LowRankCross(torch.autograd.Function):
    """DCNv2's low-rank cross network: ``x_{l+1} = x0 * (x_l V_l W_l + b_l)
    + x_l`` for every layer, from ``x0`` (B, d_in); weights ``(in, out)``.

    One Function so that its forward and its backward each run under the
    span ``train_step.cross`` (the backward in autograd's device thread,
    inside the step's ``train_step.forward_backward``). Per layer the
    forward is two GEMMs (the second with the bias, ``addmm``) and one
    ``addcmul``; the backward three GEMMs, an ``addmm`` into the cotangent
    of ``x_l``, two elementwise products and a column sum. It saves each
    layer's ``x_l``, ``x_l V_l`` and ``x_l V_l W_l + b_l``.
    """

    @staticmethod
    def forward(ctx, x0, *weights):
        n = len(weights) // 3
        vs, ws, bs = weights[:n], weights[n:2 * n], weights[2 * n:]
        with torch.profiler.record_function("train_step.cross"):
            saved = []
            x = x0
            for v, w, b in zip(vs, ws, bs):
                u = x @ v
                y = torch.addmm(b, u, w)
                saved += [x, u, y]
                x = torch.addcmul(x, x0, y)
        ctx.save_for_backward(x0, *weights, *saved)
        ctx.n = n
        return x

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        x0, *rest = ctx.saved_tensors
        vs, ws = rest[:n], rest[n:2 * n]
        saved = rest[3 * n:]
        with torch.profiler.record_function("train_step.cross"):
            g_v, g_w, g_b = [None] * n, [None] * n, [None] * n
            g_x0 = torch.zeros_like(x0)
            for li in reversed(range(n)):
                x, u, y = saved[3 * li:3 * li + 3]
                g_y = g * x0
                g_x0.addcmul_(g, y)
                g_b[li] = g_y.sum(dim=0)
                g_w[li] = u.t() @ g_y
                g_u = g_y @ ws[li].t()
                g_v[li] = x.t() @ g_u
                g = torch.addmm(g, g_u, vs[li].t())
            g_x0 += g
        return (g_x0, *g_v, *g_w, *g_b)


def low_rank_cross(params, x0: torch.Tensor, cfg: DLRMConfig) -> torch.Tensor:
    """DCNv2's cross network over ``x0`` (B, d_in): ``_LowRankCross``."""
    n = range(cfg.cross_layers)
    return _LowRankCross.apply(
        x0, *(params[f"cross.v{li}"] for li in n),
        *(params[f"cross.w{li}"] for li in n),
        *(params[f"cross_b.b{li}"] for li in n))


class _CIN(torch.autograd.Function):
    """xDeepFM's compressed interaction network over ``x0`` (B, m, D), one
    weight (H, m, n) a layer: ``X^k = einsum("bhmd,hmn->bnd", X^{k-1} (x)
    x0, W^k)`` from ``X^0 = x0``; returns every layer's maps summed over D,
    concatenated, (B, sum n).

    Per layer the forward is ``ops.cin_product`` (the outer products as the
    (B*D, H*m) operand) and one ``torch.mm`` with W reshaped to (H*m, n),
    whose (B*D, n) output is the next layer's maps, (B, D, n) in memory and
    read through a permuted view. The backward, per layer from the last:
    the maps' cotangent (the summed maps' cotangent broadcast over D, plus
    the next layer's) as ``g2d`` (B*D, n); ``gz = g2d W^T``;
    ``ops.cin_contract`` into the cotangents of the maps and of ``x0``;
    ``gz`` freed, the product rebuilt by ``ops.cin_product`` for
    ``gW = z^T g2d``, then freed: a layer's (B*D, H*m) operand and its
    cotangent never live together. ``x0``'s cotangents are added in the
    order plain autograd adds them (each layer's from the last, then layer
    0's maps'), so on the card every gradient equals plain autograd's over
    the same layout bit for bit. It saves ``x0``, each later layer's input
    maps and the weights. Forward and backward each run under the span
    ``train_step.cin``.
    """

    @staticmethod
    def forward(ctx, x0, *weights):
        B, m, D = x0.shape
        with torch.profiler.record_function("train_step.cin"):
            xk, ys, feats = x0, [], []
            for w in weights:
                H, _, n = w.shape
                y = torch.mm(ops.cin_product(xk, x0), w.reshape(H * m, n))
                ys.append(y)
                feats.append(y.view(B, D, n).sum(dim=1))
                xk = y.view(B, D, n).permute(0, 2, 1)
            out = torch.cat(feats, dim=-1)
        ctx.save_for_backward(x0, *weights, *ys[:-1])
        ctx.n = len(weights)
        return out

    @staticmethod
    def backward(ctx, g):
        x0, *rest = ctx.saved_tensors
        weights, ys = rest[:ctx.n], rest[ctx.n:]
        B, m, D = x0.shape
        with torch.profiler.record_function("train_step.cin"):
            g_feats = g.split([w.shape[2] for w in weights], dim=-1)
            g_w = [None] * ctx.n
            g_x0, g_next = None, None
            for li in reversed(range(ctx.n)):
                w = weights[li]
                H, _, n = w.shape
                w2d = w.reshape(H * m, n)
                xk = x0 if li == 0 else ys[li - 1].view(B, D, H).permute(
                    0, 2, 1)
                g2d = g_feats[li][:, None, :].expand(B, D, n)
                g2d = (g2d.contiguous() if g_next is None else
                       g2d + g_next).view(B * D, n)
                g_xk, gx0 = ops.cin_contract(torch.mm(g2d, w2d.t()), xk, x0)
                g_w[li] = torch.mm(ops.cin_product(xk, x0).t(),
                                   g2d).view(H, m, n)
                g_x0 = gx0 if g_x0 is None else g_x0 + gx0
                g_next = g_xk.permute(0, 2, 1)
            g_x0 = g_x0 + g_xk
        return (g_x0, *g_w)


def cin(params, x0: torch.Tensor, cfg: DLRMConfig) -> torch.Tensor:
    """xDeepFM's CIN over ``x0`` (B, m, D): ``_CIN``, (B, sum(maps))."""
    return _CIN.apply(x0, *(params[f"cin.w{li}"]
                            for li in range(len(cfg.cin_layers))))


def dlrm_forward_from_embeddings(params: Mapping[str, torch.Tensor], batch,
                                 embs: Mapping[str, torch.Tensor],
                                 cfg: DLRMConfig) -> torch.Tensor:
    """The dense interaction network given the pooled-store lookups."""
    emb = constrain(embs["deep"], ("batch", None, None))     # (B, m, D)
    B = emb.shape[0]
    if cfg.kind == "dcnv2":
        h = batch["dense"]
        for li in range(len(cfg.bottom_mlp_dims)):
            h = torch.relu(torch.addmm(params[f"bot.b{li}"], h,
                                       params[f"bot.w{li}"]))
        x0 = torch.cat([h, emb.reshape(B, -1)], dim=-1)
        return _deep_mlp(params, low_rank_cross(params, x0, cfg), cfg)

    x0 = torch.cat([batch["dense"], emb.reshape(B, -1)], dim=-1)

    if cfg.kind == "wide_deep":
        deep = _deep_mlp(params, x0, cfg)
        wide = batch["dense"] @ params["wide_dense"] + \
            embs["wide"][..., 0].sum(dim=1)
        return deep + wide

    if cfg.kind == "dcn":
        x = x0
        for li in range(cfg.cross_layers):
            w = params[f"cross.w{li}"]
            b = params[f"cross_b.b{li}"]
            x = x0 * (x @ w)[:, None] + b + x
        return _deep_mlp(params, x, cfg)

    if cfg.kind == "xdeepfm":
        cin_out = cin(params, emb, cfg) @ params["cin.w_out"]
        return _deep_mlp(params, x0, cfg) + cin_out

    raise ValueError(cfg.kind)


def dlrm_forward(params, batch, cfg: DLRMConfig, plan) -> torch.Tensor:
    """batch: {dense (B, n_dense) f32, sparse (B, m, hot) int, or (B,
    sum(multi_hot)) for ragged bags} -> logit (B,)."""
    embs = dlrm_embeddings(params, batch, cfg, plan)
    return dlrm_forward_from_embeddings(params, batch, embs, cfg)


def _bce_with_logits(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    y = label.float()
    return torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def dlrm_loss_from_embeddings(params, batch, embs, cfg: DLRMConfig
                              ) -> torch.Tensor:
    """BCE-with-logits given precomputed pooled-store lookups."""
    return _bce_with_logits(
        dlrm_forward_from_embeddings(params, batch, embs, cfg), batch["label"])


def dlrm_loss(params, batch, cfg: DLRMConfig, plan) -> torch.Tensor:
    """Binary cross-entropy with logits on CTR labels."""
    return _bce_with_logits(dlrm_forward(params, batch, cfg, plan),
                            batch["label"])


def dlrm_auc(params, batch, cfg: DLRMConfig, plan) -> torch.Tensor:
    """Pairwise AUC estimate on one batch."""
    logit = dlrm_forward(params, batch, cfg, plan)
    y = batch["label"].float()
    pos = (y[:, None] > y[None, :]).float()
    gt = (logit[:, None] > logit[None, :]).float()
    eq = (logit[:, None] == logit[None, :]).float()
    n = torch.clamp(pos.sum(), min=1.0)
    return torch.sum(pos * (gt + 0.5 * eq)) / n
