"""The DLRM train state as the reference's tree of named leaves, and back.

The port's train state is ``{"params": {name: tensor}, "opt": optimizer
state, "step": int}`` with flat parameter names (``mlp.w0``, see
``models/dlrm.py``). The reference's is a nested tree whose leaves are
named by ``jax.tree_util.keystr`` paths. Checkpoints store that tree, so a
blob written by either package restores in the other:

* ``params["mlp.w0"]``         <-> ``['state']['params']['mlp']['w0']``
* ``opt["acc"]["tables"]``     <-> ``['state']['opt']['acc']['tables']``
* adam's ``opt["count"]``      <-> ``['state']['opt']['count']`` (int32, 0-d)
* ``step`` (a Python int)      <-> ``['state']['step']`` (int32, 0-d)

``to_tree`` is what ``FlashCheckpoint.save`` flattens (the checkpoint copies
every leaf to the host); ``from_tree`` copies a restored tree onto a device;
``like_tree`` is a restore template drawn from no generator (meta tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.dlrm_models import DLRMConfig
from repro_torch.core.flash_checkpoint import LeafSpec
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.train.optim import Optimizer


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"mlp.w0": x, "tables": y}`` -> ``{"mlp": {"w0": x}, "tables": y}``."""
    out: Dict[str, Any] = {}
    for name, leaf in flat.items():
        head, _, tail = name.partition(".")
        if tail:
            out.setdefault(head, {})[tail] = leaf
        else:
            out[head] = leaf
    return out


def _unnest(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of ``_nest``."""
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            for sub, leaf in val.items():
                out[f"{key}.{sub}"] = leaf
        else:
            out[key] = val
    return out


def to_tree(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's train state as the reference's tree (leaves not copied)."""
    opt = {name: _nest(sub) if isinstance(sub, Mapping) else sub
           for name, sub in state["opt"].items()}
    return {"params": _nest(state["params"]), "opt": opt,
            "step": np.asarray(state["step"], np.int32)}


def _tensor(leaf, device) -> torch.Tensor:
    """A fresh tensor on ``device`` (never the restored array's storage)."""
    return torch.tensor(np.asarray(leaf), device=device)


def from_tree(tree: Mapping[str, Any], device) -> Dict[str, Any]:
    """The reference's train-state tree (numpy leaves) as the port's train
    state on ``device``; every leaf is copied."""
    params = {k: _tensor(v, device) for k, v in _unnest(tree["params"]).items()}
    opt = {}
    for name, sub in tree["opt"].items():
        if isinstance(sub, Mapping):
            opt[name] = {k: _tensor(v, device)
                         for k, v in _unnest(sub).items()}
        else:
            opt[name] = _tensor(sub, device)
    return {"params": params, "opt": opt, "step": int(np.asarray(tree["step"]))}


def like_tree(cfg: DLRMConfig, optimizer: Optimizer,
              layout=None) -> Dict[str, Any]:
    """Restore template of ``make_dlrm_train_state(cfg, optimizer, ...,
    layout=layout)``: its tree with a ``LeafSpec`` per leaf, drawn from no
    generator and allocating nothing at full width.

    The optimizer initialises a probe (one row per table, on the CPU); each
    of its mirrors of a parameter takes that parameter's full shape. No
    operation runs on meta tensors: the first one in a process costs about
    a second of dispatch set-up, which a restart would wait for."""
    probe = dataclasses.replace(cfg, table_rows=(1,) * cfg.n_tables)
    names = dlrm_mod.init_dlrm(probe, torch.Generator().manual_seed(0))
    rows = ((cfg.total_embedding_rows,) if layout is None
            else (layout.n_ps, layout.max_range))
    pooled = dlrm_mod.sparse_param_keys(cfg)
    params = {k: torch.empty(rows + tuple(v.shape[1:]) if k in pooled
                             else tuple(v.shape), device="meta")
              for k, v in names.items()}

    def full(name, leaf):
        shape = params[name].shape if name in params else leaf.shape
        return torch.empty(tuple(shape), dtype=leaf.dtype, device="meta")

    opt = {key: {k: full(k, v) for k, v in sub.items()}
           if isinstance(sub, Mapping) else full(None, sub)
           for key, sub in optimizer.init(names).items()}
    tree = to_tree({"params": params, "opt": opt, "step": 0})

    def spec(x):
        if isinstance(x, Mapping):
            return {k: spec(v) for k, v in x.items()}
        dtype = x.dtype if isinstance(x, np.ndarray) else \
            torch.empty((), dtype=x.dtype).numpy().dtype
        return LeafSpec(tuple(x.shape), dtype)

    return spec(tree)
