"""Train-step construction: the LM step and the DLRM steps (port of
``repro/train/trainer.py``).

A train state is ``{"params": params, "opt": optimizer state, "step":
int}``. ``make_train_step`` builds the step of any ``ModelAPI`` (the LM
families and the enc-dec), as the reference's: loss and gradients (pattern
groups recomputed in the backward with ``remat``), then the optimizer
phase every step shares: optional bf16 gradient compression, the global
norm, and ``optim.update_and_apply``, returning new tensors. Attention
trains through the chunked route (``models/transformer.full_attention``).
``make_eval_step`` is the loss without autograd, so attention takes K4.
``train_state_specs`` (logical-axis specs of a device mesh) has no
counterpart: one GPU has no mesh.

``make_dlrm_train_step`` returns ``train_step(state, batch) ->
(state, metrics)`` over the flat ``{name: tensor}`` DLRM params:

* the dense step differentiates the whole loss (the embedding bag's
  backward scatters deduped rows into a dense pool gradient) and updates
  every parameter (``optim.update_and_apply``), returning new tensors;
* the fused sparse step (``plan.sparse_update``) differentiates only the
  dense network at the ``dlrm_embeddings`` seam and turns each pooled
  store's bag cotangent into deduped COO row grads, a ``SparseRowGrad``
  leaf. The optimizer owns its state and the row update: its ``apply``
  updates the pooled stores and their moment pools IN PLACE by K2/K3 (on
  the CPU by their plain versions), so the returned state holds the same
  pool tensors as the one passed in.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.dlrm_models import DLRMConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models.registry import ModelAPI
from repro_torch.train import optim as optim_mod
from repro_torch.train.optim import Optimizer


# --- LM families -----------------------------------------------------------
def make_train_state(api: ModelAPI, optimizer: Optimizer,
                     generator: torch.Generator) -> Dict[str, Any]:
    """Fresh train state of ``api`` on the generator's device."""
    params = api.init(generator)
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def loss_and_grads(api: ModelAPI, params, batch, *, remat: bool = True):
    """``(loss, grads)`` of ``api.loss`` at ``params``; ``grads`` has the
    params' structure and dtypes. Every floating leaf must get a gradient
    (a leaf the loss does not reach raises)."""
    leaves = optim_mod.tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.profiler.record_function("train_step.forward_backward"):
        loss = api.loss(leaves, batch, remat=remat)
        grads = torch.autograd.grad(loss, list(optim_mod.tree_leaves(leaves)))
    return loss.detach(), optim_mod.tree_unflatten(leaves, grads)


def make_train_step(api: ModelAPI, optimizer: Optimizer, *,
                    remat: bool = True, grad_compress: bool = False,
                    donate: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)`` with
    metrics ``{"loss", "grad_norm"}`` (the norm before clipping).

    ``donate=True`` consumes ``state``, like ``jax.jit``'s
    ``donate_argnums``: the optimizer empties each leaf of the old params
    and moments as soon as its new one exists and the step clears the old
    state's dict, so the old and the new adam moments never coexist whole
    (at llama3.2-3b that is 26 GB less at the peak). The caller must not
    read the state it passed in."""
    def train_step(state, batch):
        loss, grads = loss_and_grads(api, state["params"], batch, remat=remat)
        return _optimizer_phase(optimizer, state, grads, loss, grad_compress,
                                donate=donate)

    return train_step


def make_eval_step(api: ModelAPI) -> Callable:
    """``eval_step(state, batch) -> loss`` under ``torch.no_grad()``: no
    recomputation, and full-sequence attention takes K4."""
    def eval_step(state, batch):
        with torch.no_grad():
            return api.loss(state["params"], batch, remat=False)

    return eval_step


def _optimizer_phase(optimizer: Optimizer, state, grads, loss,
                     grad_compress: bool, *, donate: bool = False):
    """The end of every train step, the span ``train_step.optimizer``:
    compression where ``grad_compress`` is set, the global norm once, the
    joint clip where the (flat DLRM) tree holds ``SparseRowGrad`` leaves
    and the optimizer has a clip, then ``update_and_apply``. Returns
    ``(new state, {"loss", "grad_norm"})``, the norm before clipping."""
    with torch.profiler.record_function("train_step.optimizer"):
        if grad_compress:
            grads = optim_mod.compress_grads(grads)
        gnorm = optim_mod.global_norm(grads)
        if optimizer.clip_norm is not None and any(
                isinstance(g, optim_mod.SparseRowGrad)
                for g in grads.values()):
            grads = optim_mod.clip_by_norm(grads, gnorm, optimizer.clip_norm)
        params, opt_state = optim_mod.update_and_apply(
            optimizer, grads, state["opt"], state["params"], donate=donate)
    step = state["step"] + 1
    if donate:
        state.clear()
    return ({"params": params, "opt": opt_state, "step": step},
            {"loss": loss.detach(), "grad_norm": gnorm})


# --- DLRM --------------------------------------------------------------------


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

    Under ``torch.profiler`` each step records ``record_function`` spans
    at its layer boundaries, in order and without overlap. The dense step
    has the LM step's two: ``train_step.forward_backward`` (the loss and
    its gradients) and ``train_step.optimizer`` (``_optimizer_phase``). The
    fused sparse step has four: ``train_step.embeddings`` (the bags, K1),
    ``train_step.forward_backward`` (the dense network's forward, the loss
    and the gradients of the dense params and the bag outputs),
    ``train_step.sparse_grads`` (the bag cotangents to deduped row grads)
    and ``train_step.optimizer`` (with the row updates, K2/K3). With no
    profiler active a span records nothing.
    """
    if plan.sparse_update and optimizer.update_rows is not None:
        return _make_dlrm_sparse_step(cfg, optimizer, grad_compress, plan)

    def train_step(state, batch):
        with torch.profiler.record_function("train_step.forward_backward"):
            leaves = {k: v.detach().requires_grad_()
                      for k, v in state["params"].items()}
            loss = dlrm_mod.dlrm_loss(leaves, batch, cfg, plan)
            grads = _grads(loss, leaves)
        return _optimizer_phase(optimizer, state, grads, loss, grad_compress)

    return train_step


def _make_dlrm_sparse_step(cfg: DLRMConfig, optimizer: Optimizer,
                           grad_compress: bool, plan) -> Callable:
    """The fused sparse-update DLRM step (``plan.sparse_update=True``).

    (a) the embeddings are computed once without autograd and the loss is
    differentiated w.r.t. the dense params and the bag outputs only; (b)
    each pooled store's bag cotangent becomes deduped COO row grads
    (``ops.sparse_row_grads``, a ``SparseRowGrad`` leaf); (c) the optimizer
    phase clips the joint dense+sparse tree once and the optimizer's
    ``apply`` updates the dense leaves and exactly those rows, in place.
    """
    stores = dlrm_mod.pooled_stores(cfg)

    def train_step(state, batch):
        params = state["params"]
        with torch.profiler.record_function("train_step.embeddings"), \
                torch.no_grad():
            embs = dlrm_mod.dlrm_embeddings(params, batch, cfg, plan)
        with torch.profiler.record_function("train_step.forward_backward"):
            leaves = {k: v.detach().requires_grad_()
                      for k, v in params.items()
                      if k not in dlrm_mod.POOLED_KEYS}
            emb_leaves = {k: e.requires_grad_() for k, e in embs.items()}
            loss = dlrm_mod.dlrm_loss_from_embeddings(leaves, batch,
                                                      emb_leaves, cfg)
            g_all = _grads(loss, {**leaves, **{
                f"emb:{k}": e for k, e in emb_leaves.items()}})

        with torch.profiler.record_function("train_step.sparse_grads"):
            grads: Dict[str, Any] = {k: g_all[k] for k in leaves}
            for s in stores:
                rows, vals, _ = kernel_ops.sparse_row_grads(
                    dlrm_mod.pool_rows(params[s.param]), batch["sparse"],
                    g_all[f"emb:{s.bag}"], plan=s.bag_plan(plan))
                grads[s.param] = optim_mod.SparseRowGrad(rows, vals)

        return _optimizer_phase(optimizer, state, grads, loss, grad_compress)

    return train_step
