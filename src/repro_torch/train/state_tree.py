"""Train states as the reference's trees of named leaves, and back.

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

The LM train state (``trainer.make_train_state``) keeps one entry per
layer (``params["layers"][l]``; ``params["enc"]``/``["dec"]`` for the
enc-dec), the reference stacks them. ``lm_to_tree`` stacks the layers, and
the adam moments that mirror them, into the reference's
``['params']['pattern'][i]`` (leading axis ``n_groups``) and
``['params']['rest'][j]`` (``enc``/``dec`` stacked over their layers),
copying those leaves to the host; ``lm_from_tree`` unstacks with the models'
own ``unstack_params`` (the one ``params_from_jax`` uses) and copies every
leaf onto a device; ``lm_like_tree`` is the restore template, built under a
fake-tensor mode so that it allocates nothing at full width. bfloat16
leaves travel as their raw bits (``flash_checkpoint.BF16_HOST``), as the
reference's ``np.savez`` writes them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.dlrm_models import DLRMConfig
from repro_torch.core.flash_checkpoint import BF16_HOST, LeafSpec, host_dtype
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.registry import ModelAPI
from repro_torch.train.optim import Optimizer, tree_map


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
    """A fresh tensor on ``device`` (never the restored array's storage);
    a 2-byte void or ml_dtypes bfloat16 array becomes bfloat16."""
    arr = np.asarray(leaf)
    if arr.dtype == BF16_HOST or arr.dtype.name == "bfloat16":
        bits = torch.tensor(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


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


# --- LM families ---------------------------------------------------------------
def _model_mod(cfg: ModelConfig):
    return encdec_mod if cfg.family == "encdec" else tf_mod


def _stack_on_host(leaves) -> torch.Tensor:
    return torch.stack([t.detach().to("cpu") for t in leaves])


def lm_to_tree(state: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's LM train state as the reference's tree: the layer lists
    of the params and of every optimizer mirror stacked on the host (new
    tensors); the other leaves as they are (not copied)."""
    mod = _model_mod(cfg)

    def stacked(tree):
        return mod.stack_params(cfg, tree, _stack_on_host)

    opt = {name: stacked(sub) if isinstance(sub, Mapping) else sub
           for name, sub in state["opt"].items()}
    return {"params": stacked(state["params"]), "opt": opt,
            "step": np.asarray(state["step"], np.int32)}


def lm_from_tree(tree: Mapping[str, Any], cfg: ModelConfig,
                 device) -> Dict[str, Any]:
    """The reference's LM train-state tree (numpy leaves) as the port's
    train state on ``device``; every leaf is copied, in its own dtype."""
    mod = _model_mod(cfg)

    def unstacked(sub):
        return tree_map(lambda a: _tensor(a, device),
                        mod.unstack_params(cfg, sub))

    opt = {name: unstacked(sub) if isinstance(sub, Mapping)
           else _tensor(sub, device) for name, sub in tree["opt"].items()}
    return {"params": unstacked(tree["params"]), "opt": opt,
            "step": int(np.asarray(tree["step"]))}


def lm_like_tree(api: ModelAPI, optimizer: Optimizer) -> Dict[str, Any]:
    """Restore template of ``make_train_state(api, optimizer, ...)``: its
    reference tree with a ``LeafSpec`` per leaf. Params and optimizer state
    are built under ``FakeTensorMode`` (shapes and dtypes, no storage)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = api.init(torch.Generator())
        tree = lm_to_tree({"params": params, "opt": optimizer.init(params),
                           "step": 0}, api.cfg)

    def spec(x):
        if isinstance(x, Mapping):
            return {k: spec(v) for k, v in x.items()}
        if isinstance(x, list):
            return [spec(v) for v in x]
        return LeafSpec(tuple(x.shape), host_dtype(x.dtype))

    return spec(tree)
