"""DLRM train-step construction (port of the DLRM half of
``repro/train/trainer.py``).

A train state is ``{"params": {name: tensor}, "opt": optimizer state,
"step": int}``. ``make_dlrm_train_step`` returns ``train_step(state, batch)
-> (state, metrics)``:

* the dense step differentiates the whole loss (the embedding bag's
  backward scatters deduped rows into a dense pool gradient) and applies
  ``optimizer.update`` to every parameter, returning new tensors;
* the fused sparse step (``plan.sparse_update``) differentiates only the
  dense network at the ``dlrm_embeddings`` seam, turns each pooled store's
  bag cotangent into deduped COO row grads, and updates exactly those rows
  with ``optimizer.update_rows``. The pooled stores and their moment pools
  are updated IN PLACE by K2/K3 (on the CPU by their plain versions): the
  returned state holds the same pool tensors as the one passed in.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.dlrm_models import DLRMConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.train import optim as optim_mod
from repro_torch.train.optim import Optimizer


def make_dlrm_train_state(cfg: DLRMConfig, optimizer: Optimizer,
                          generator: torch.Generator,
                          layout=None) -> Dict[str, Any]:
    """Fresh DLRM train state on the generator's device; ``layout`` builds
    the pooled stores (and their optimizer-state mirrors) padded."""
    params = dlrm_mod.init_dlrm(cfg, generator, layout=layout)
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def _grads(loss: torch.Tensor, leaves: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    names = list(leaves)
    return dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))


def with_step_hooks(step_fn: Callable, *, before: Optional[Callable] = None,
                    after: Optional[Callable] = None) -> Callable:
    """Wrap a train step with host-side hooks.

    ``before(state, batch)`` runs immediately before the step: it is the
    trainer-layer seam a fault injector
    (``repro_torch.core.faults.FaultInjector.before_step``) fires through.
    The fused step updates the pools in place, so ``before`` also runs
    before anything is mutated: a fault it raises leaves the state as it
    was. ``after(new_state, metrics)`` runs once the step returns.
    """
    def wrapped(state, batch):
        if before is not None:
            before(state, batch)
        new_state, metrics = step_fn(state, batch)
        if after is not None:
            after(new_state, metrics)
        return new_state, metrics

    return wrapped


def make_dlrm_train_step(cfg: DLRMConfig, optimizer: Optimizer,
                         grad_compress: bool = False, *, plan) -> Callable:
    """DLRM train step under one ``EmbeddingPlan``.

    ``plan.sparse_update`` selects the fused sparse step when the optimizer
    has an ``update_rows`` seam; otherwise the dense step runs.
    """
    if plan.sparse_update and optimizer.update_rows is not None:
        return _make_dlrm_sparse_step(cfg, optimizer, grad_compress, plan)

    def train_step(state, batch):
        leaves = {k: v.detach().requires_grad_()
                  for k, v in state["params"].items()}
        loss = dlrm_mod.dlrm_loss(leaves, batch, cfg, plan)
        grads = _grads(loss, leaves)
        if grad_compress:
            grads = optim_mod.compress_grads(grads)
        gnorm = optim_mod.global_norm(grads)
        updates, opt_state = optimizer.update(grads, state["opt"],
                                              state["params"])
        params = optim_mod.apply_updates(state["params"], updates)
        new_state = {"params": params, "opt": opt_state,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def _split_opt_state(opt_state, sparse_keys):
    """Split a dict-of-mirrors optimizer state at the pooled-store leaves.

    Mirrors of the params (dicts holding every sparse key) split into a
    dense remainder + one slice per pooled store; shared scalars (adam's
    ``count``) stay in the dense state AND ride along in every per-leaf
    slice, as ``Optimizer.update_rows`` expects.
    """
    dense_state, leaf_state = {}, {k: {} for k in sparse_keys}
    for name, sub in opt_state.items():
        if isinstance(sub, dict) and all(k in sub for k in sparse_keys):
            dense_state[name] = {k: v for k, v in sub.items()
                                 if k not in sparse_keys}
            for k in sparse_keys:
                leaf_state[k][name] = sub[k]
        else:
            dense_state[name] = sub
            for k in sparse_keys:
                leaf_state[k][name] = sub
    return dense_state, leaf_state


def _make_dlrm_sparse_step(cfg: DLRMConfig, optimizer: Optimizer,
                           grad_compress: bool, plan) -> Callable:
    """The fused sparse-update DLRM step (``plan.sparse_update=True``).

    (a) the embeddings are computed once without autograd and the loss is
    differentiated w.r.t. the dense params and the bag outputs only; (b)
    each store's bag cotangent becomes deduped COO row grads
    (``ops.sparse_row_grads``, a ``SparseRowGrad`` leaf); (c) the row-wise
    optimizer update touches exactly those rows, in place. Clipping happens
    once over the joint dense+sparse tree.
    """
    sparse_keys = dlrm_mod.sparse_param_keys(cfg)
    emb_of = {"tables": "deep", "wide": "wide"}
    plan_of = {"tables": plan, "wide": plan.with_combiner("sum")}

    def train_step(state, batch):
        params = state["params"]
        with torch.no_grad():
            embs = dlrm_mod.dlrm_embeddings(params, batch, cfg, plan)
        dense_params = {k: v for k, v in params.items()
                        if k not in sparse_keys}
        leaves = {k: v.detach().requires_grad_()
                  for k, v in dense_params.items()}
        emb_leaves = {k: e.requires_grad_() for k, e in embs.items()}
        loss = dlrm_mod.dlrm_loss_from_embeddings(leaves, batch, emb_leaves,
                                                  cfg)
        g_all = _grads(loss, {**leaves,
                              **{f"emb:{k}": e for k, e in emb_leaves.items()}})

        grads: Dict[str, Any] = {k: g_all[k] for k in leaves}
        for k in sparse_keys:
            pool = dlrm_mod._pool2d(params[k], plan.layout)
            rows, vals, _ = kernel_ops.sparse_row_grads(
                pool, batch["sparse"], g_all[f"emb:{emb_of[k]}"],
                plan=plan_of[k])
            grads[k] = optim_mod.SparseRowGrad(rows, vals)

        if grad_compress:
            grads = optim_mod.compress_grads(grads)
        gnorm = optim_mod.global_norm(grads)
        if optimizer.clip_norm is not None:
            grads, _ = optim_mod.clip_by_global_norm(grads,
                                                     optimizer.clip_norm)

        dense_state, leaf_state = _split_opt_state(state["opt"], sparse_keys)
        dense_only = {k: v for k, v in grads.items() if k not in sparse_keys}
        updates, new_dense_state = optimizer.update(
            dense_only, dense_state, dense_params)
        new_params = optim_mod.apply_updates(dense_params, updates)
        new_opt = dict(new_dense_state)
        for k in sparse_keys:
            store = params[k]
            pool = dlrm_mod._pool2d(store, plan.layout)
            leaf = {name: (dlrm_mod._pool2d(arr, plan.layout)
                           if getattr(arr, "shape", None) == store.shape
                           else arr)
                    for name, arr in leaf_state[k].items()}
            # K2/K3 update `pool` and the moment pools in place; the views
            # share storage with the stores, so `store` holds the result
            optimizer.update_rows(grads[k].rows, grads[k].vals, leaf, pool)
            new_params[k] = store
            for name in leaf:
                if name in new_opt and isinstance(new_opt[name], dict):
                    new_opt[name] = dict(new_opt[name])
                    new_opt[name][k] = leaf_state[k][name]
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step
