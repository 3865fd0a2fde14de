"""Optimizers (adam/adamw/adagrad/sgd) as functions over dicts of tensors.

Port of ``repro/train/optim.py``. Not ``torch.optim`` classes: an
``Optimizer`` is ``(init, update, update_rows, clip_norm)`` over the flat
``{name: tensor}`` params of ``models.dlrm``, and keeps the reference's
exact expressions (adagrad's ``eps`` outside the ``sqrt``; adam's bias
correction from ``count``, with weight decay). Gradient trees are flat dicts
whose leaves are tensors or ``SparseRowGrad``s; leaves are visited in sorted
name order, which is the leaf order of the reference's nested tree.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.fused_embedding import scatter_rows


class Optimizer(NamedTuple):
    """(init, update) transform + the optional sparse row seam.

    ``update_rows(rows, row_grads, state, params)`` applies this optimizer's
    row-wise update to exactly the given rows of one pooled (R, D) parameter
    (entries ``>= R`` are padding), in place, and returns ``(params,
    new_leaf_state)`` with the per-leaf moment pools; shared scalars such as
    ``count`` are advanced by ``update``. ``clip_norm`` is this optimizer's
    default clip, applied once by the trainer over the joint tree.
    """
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)
    update_rows: Optional[Callable[[Any, Any, Any, Any], Tuple[Any, Any]]] = None
    clip_norm: Optional[float] = None


class SparseRowGrad(NamedTuple):
    """COO gradient leaf of a pooled (R, D) parameter: rows + values.

    ``rows`` (N,) int32 deduplicated store rows (entries equal to the pool's
    row count are padding with zero values); ``vals`` (N, D) f32 summed
    cotangents. Norms, clipping and compression skip the integer ``rows``.
    """
    rows: torch.Tensor
    vals: torch.Tensor

    def to_dense(self, num_rows: int) -> torch.Tensor:
        """Scatter-add back to the dense (R, D) gradient (reference oracle);
        sentinel rows are masked out explicitly."""
        return scatter_rows(self.rows, self.vals, num_rows)


def _inexact(x) -> bool:
    return torch.is_tensor(x) and x.is_floating_point()


def _leaves(tree) -> Iterator[Any]:
    """Leaves of a flat dict tree in sorted name order (the reference's
    ``jax.tree.leaves`` order); a ``SparseRowGrad`` yields rows, vals."""
    for name in sorted(tree):
        leaf = tree[name]
        if isinstance(leaf, SparseRowGrad):
            yield from leaf
        else:
            yield leaf


def _map_inexact(fn, tree):
    """Apply ``fn`` to every floating leaf, keeping integer leaves as they are."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, SparseRowGrad):
            out[name] = SparseRowGrad(leaf.rows, fn(leaf.vals))
        else:
            out[name] = fn(leaf) if _inexact(leaf) else leaf
    return out


def _zeros_like(params) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every floating leaf (integer leaves carry no gradient)."""
    leaves = [l for l in _leaves(tree) if _inexact(l)]
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _map_inexact(lambda g: g * scale.to(g.dtype), grads), norm


def compress_grads(grads, dtype=torch.bfloat16):
    """Cast-compress gradients (bf16 round trip; integer row ids untouched)."""
    return _map_inexact(lambda g: g.to(dtype).to(g.dtype), grads)


def adam(lr: float, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, clip_norm: Optional[float] = 1.0,
         master_weights: bool = False) -> Optimizer:
    """Adam with f32 moments; optional f32 master copy of the params.

    ``master_weights=True`` disables ``update_rows``, as in the reference.
    """
    def init(params):
        some = next(iter(params.values()))
        state = {"m": _zeros_like(params), "v": _zeros_like(params),
                 "count": torch.zeros((), dtype=torch.int32,
                                      device=some.device)}
        if master_weights:
            state["master"] = {k: p.float() for k, p in params.items()}
        return state

    def update(grads, state, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        count = state["count"] + 1
        tc = count.float()
        m = {k: b1 * state["m"][k] + (1 - b1) * g.float()
             for k, g in grads.items()}
        v = {k: b2 * state["v"][k] + (1 - b2) * torch.square(g.float())
             for k, g in grads.items()}
        mh = {k: x / (1 - b1 ** tc) for k, x in m.items()}
        vh = {k: x / (1 - b2 ** tc) for k, x in v.items()}
        new_state = {"m": m, "v": v, "count": count}
        if master_weights:
            new_master = {
                k: w - lr * (mh[k] / (torch.sqrt(vh[k]) + eps)
                             + weight_decay * w)
                for k, w in state["master"].items()}
            new_state["master"] = new_master
            updates = {k: new_master[k].to(p.dtype) - p
                       for k, p in params.items()}
        else:
            updates = {k: (-lr * (mh[k] / (torch.sqrt(vh[k]) + eps)
                                  + weight_decay * p.float())).to(p.dtype)
                       for k, p in params.items()}
        return updates, new_state

    def update_rows(rows, row_grads, state, params):
        # lazy (row-wise) adam: moments of untouched rows are NOT decayed;
        # the bias correction uses the count the dense-side update advances
        tc = (state["count"] + 1).float()
        new_params, new_m, new_v = kernel_ops.fused_row_update(
            params, rows, row_grads, state["m"], state["v"], kind="adam",
            lr=lr, b1=b1, b2=b2, eps=eps, count=tc,
            weight_decay=weight_decay)
        return new_params, {"m": new_m, "v": new_v}

    return Optimizer(init, update,
                     update_rows=None if master_weights else update_rows,
                     clip_norm=clip_norm)


def adamw(lr: float, *, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def adagrad(lr: float, *, eps: float = 1e-10,
            clip_norm: Optional[float] = None) -> Optimizer:
    """The classic DLRM optimizer (sparse-friendly per-coordinate scaling)."""
    def init(params):
        return {"acc": _zeros_like(params)}

    def update(grads, state, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        acc = {k: state["acc"][k] + torch.square(g.float())
               for k, g in grads.items()}
        updates = {k: (-lr * g.float() / (torch.sqrt(acc[k]) + eps)
                       ).to(params[k].dtype)
                   for k, g in grads.items()}
        return updates, {"acc": acc}

    def update_rows(rows, row_grads, state, params):
        # row-wise adagrad is bit-exact vs the dense path up to FMA ULPs:
        # untouched rows see g == 0, an exact no-op
        new_params, new_acc = kernel_ops.fused_row_update(
            params, rows, row_grads, state["acc"], kind="adagrad",
            lr=lr, eps=eps)
        return new_params, {"acc": new_acc}

    return Optimizer(init, update, update_rows=update_rows,
                     clip_norm=clip_norm)


def sgd(lr: float, *, momentum: float = 0.0,
        clip_norm: Optional[float] = None) -> Optimizer:
    def init(params):
        if momentum:
            return {"mom": _zeros_like(params)}
        return {}

    def update(grads, state, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        if momentum:
            mom = {k: momentum * state["mom"][k] + g.float()
                   for k, g in grads.items()}
            updates = {k: (-lr * mom[k]).to(params[k].dtype) for k in mom}
            return updates, {"mom": mom}
        updates = {k: (-lr * g).to(params[k].dtype) for k, g in grads.items()}
        return updates, state

    return Optimizer(init, update, clip_norm=clip_norm)


def apply_updates(params, updates):
    return {k: p + updates[k] for k, p in params.items()}


def make(name: str, lr: float, **kw) -> Optimizer:
    return {"adam": adam, "adamw": adamw, "adagrad": adagrad, "sgd": sgd}[name](lr, **kw)
