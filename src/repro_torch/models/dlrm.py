"""The paper's DLRM workloads: Wide&Deep (Model-X), xDeepFM (Model-Y), DCN (Model-Z).

Port of ``repro/models/dlrm.py``. Sparse categorical features -> one pooled
embedding store for all tables -> one fused embedding-bag call (plus one
for the wide part of Wide&Deep) -> dense interaction network -> CTR logit.

Parameters are a flat ``{name: tensor}`` state dict whose names are the
paths of the reference's parameter tree: ``tables``, ``wide``,
``wide_dense``, ``mlp.w0`` … ``mlp.w_out``, ``mlp.b_out``, ``cross.w0``,
``cross_b.b0``, ``cin.w0`` … ``cin.w_out``. Weight matrices keep the
reference's ``(in, out)`` layout. Under a ``PaddedLayout`` the pooled
stores are ``(n_ps, max_range, D)`` padded arrays, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

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
    d_in = cfg.n_dense + cfg.n_tables * D
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
        params["tables"] = layout.pad_rows(params["tables"])
        if "wide" in params:
            params["wide"] = layout.pad_rows(params["wide"])
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


def _pool2d(store: torch.Tensor, layout) -> torch.Tensor:
    """Padded (n_ps, max_range, ...) store → the engine's flattened view
    (shares storage, so in-place row updates reach the store)."""
    if layout is None:
        return store
    return store.reshape((layout.padded_rows,) + tuple(store.shape[2:]))


def sparse_param_keys(cfg: DLRMConfig) -> tuple:
    """The pooled (vocab-row) parameters the fused sparse backward and the
    row-wise optimizer update handle; everything else is dense."""
    return ("tables", "wide") if cfg.kind == "wide_deep" else ("tables",)


def dlrm_embeddings(params: Mapping[str, torch.Tensor], batch, cfg: DLRMConfig,
                    plan) -> Dict[str, torch.Tensor]:
    """Every pooled-store lookup of one forward: ``{"deep": (B, n_tables,
    D)}`` plus ``{"wide": (B, n_tables, 1)}`` for wide_deep."""
    embs = {"deep": ops.fused_embedding_bag(
        _pool2d(params["tables"], plan.layout), batch["sparse"], plan=plan)}
    if cfg.kind == "wide_deep":
        embs["wide"] = ops.fused_embedding_bag(
            _pool2d(params["wide"], plan.layout), batch["sparse"],
            plan=plan.with_combiner("sum"))
    return embs


def _deep_mlp(params, x, cfg: DLRMConfig):
    h = x
    for li in range(len(cfg.mlp_dims)):
        h = torch.relu(h @ params[f"mlp.w{li}"] + params[f"mlp.b{li}"])
    return (h @ params["mlp.w_out"] + params["mlp.b_out"])[:, 0]


def dlrm_forward_from_embeddings(params: Mapping[str, torch.Tensor], batch,
                                 embs: Mapping[str, torch.Tensor],
                                 cfg: DLRMConfig) -> torch.Tensor:
    """The dense interaction network given the pooled-store lookups."""
    emb = constrain(embs["deep"], ("batch", None, None))     # (B, m, D)
    B = emb.shape[0]
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
        Xk = emb                                             # (B, H0=m, D)
        feats = []
        for li in range(len(cfg.cin_layers)):
            inter = torch.einsum("bhd,bmd->bhmd", Xk, emb)
            Xk = torch.einsum("bhmd,hmn->bnd", inter, params[f"cin.w{li}"])
            feats.append(Xk.sum(dim=-1))                     # (B, maps)
        cin_out = torch.cat(feats, dim=-1) @ params["cin.w_out"]
        return _deep_mlp(params, x0, cfg) + cin_out

    raise ValueError(cfg.kind)


def dlrm_forward(params, batch, cfg: DLRMConfig, plan) -> torch.Tensor:
    """batch: {dense (B, n_dense) f32, sparse (B, m, hot) int} -> logit (B,)."""
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
