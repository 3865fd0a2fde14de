"""Optimizers (adam/adamw/adagrad/sgd) as functions over trees of tensors.

Port of ``repro/train/optim.py``. Not ``torch.optim`` classes: an
``Optimizer`` is ``(init, update, update_rows, clip_norm, apply)`` over a
tree of dicts and lists whose leaves are tensors: the flat ``{name:
tensor}`` params of ``models.dlrm`` or the nested params of the LMs
(``{"embed", "layers": [...], ...}``). It keeps the reference's exact
expressions (adagrad's ``eps`` outside the ``sqrt``; adam's bias
correction from ``count``, with weight decay). Leaves are visited in the
reference's ``jax.tree.leaves`` order: dict keys sorted, lists in order; a
``SparseRowGrad`` leaf yields rows, then vals.

The global norm and adagrad's dense update go through
``kernels/multi_tensor.py``: on CUDA leaves one multi-tensor kernel each
over the whole tree (the norm reads a ``SparseRowGrad``'s live rows only),
on CPU leaves the plain expressions, op by op.

Adam's ``apply`` updates and applies one leaf at a time: it clips that
leaf, computes its ``m``, ``v``, bias-corrected moments and update, adds
the update to the parameter and drops the temporaries before the next
leaf, so no whole tree of ``mh``/``vh``/updates exists at once (at
llama3.2-3b's 3.2 B parameters those are 26 GB each in f32). Each element
sees the reference's operations in the reference's order, so the result is
bit for bit that of ``update`` followed by ``apply_updates``.
"""
from __future__ import annotations

from typing import (Any, Callable, Iterator, Mapping, NamedTuple, Optional,
                    Tuple)

import torch

from repro_torch.kernels import multi_tensor
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.fused_embedding import scatter_rows


class Optimizer(NamedTuple):
    """(init, update) transform + the optional sparse row seam.

    The optimizer owns its state, one form over the whole params tree, and
    the row-wise update. ``apply(grads, state, params, donate=False)``
    returns ``(new_params, new_state)``: leaf by leaf (adam), or in one
    multi-tensor update (adagrad); ``update_and_apply`` falls back to
    ``update`` + ``apply_updates`` where it is None. Only ``apply`` takes a
    ``SparseRowGrad`` leaf: ``update_rows(rows, row_grads, state, params)``
    updates those rows of the pooled store (flat or padded) and of its
    moment pools, in place. ``clip_norm`` clips the dense leaves alone.
    """
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)
    update_rows: Optional[Callable[[Any, Any, Any, Any], Tuple[Any, Any]]] = None
    clip_norm: Optional[float] = None
    apply: Optional[Callable[..., Tuple[Any, Any]]] = None


class SparseRowGrad(NamedTuple):
    """COO gradient leaf of a pooled (R, D) parameter: rows + values.

    ``rows`` (N,) int32 deduplicated store rows, ascending: the distinct
    rows first, then the padding, entries equal to the pool's row count
    with zero values (the dedupe's order, which the global norm's kernel
    relies on to skip the padding); ``vals`` (N, D) f32 summed cotangents.
    Norms, clipping and compression skip the integer ``rows``; the
    optimizer's ``apply`` updates the rows.
    """
    rows: torch.Tensor
    vals: torch.Tensor

    def to_dense(self, num_rows: int) -> torch.Tensor:
        """Scatter-add back to the dense (R, D) gradient (reference oracle);
        sentinel rows are masked out explicitly."""
        return scatter_rows(self.rows, self.vals, num_rows)


# --- trees -------------------------------------------------------------------
def _inexact(x) -> bool:
    return torch.is_tensor(x) and x.is_floating_point()


def _is_named_tuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> Iterator[Any]:
    """Leaves in the reference's ``jax.tree.leaves`` order: dict keys
    sorted, lists and tuples in order (a ``SparseRowGrad`` yields rows,
    vals)."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves of rest)`` over trees of ``tree``'s structure;
    dicts keep ``tree``'s key order."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_named_tuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _paths(tree, prefix: Tuple = ()) -> Iterator[Tuple]:
    """Key paths of the leaves, in ``tree_leaves`` order."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix


def _get(tree, path: Tuple, pop: bool = False):
    """The leaf at ``path``; with ``pop`` its slot is set to None, so the
    tree no longer holds it."""
    for key in path[:-1]:
        tree = tree[key]
    leaf = tree[path[-1]]
    if pop:
        tree[path[-1]] = None
    return leaf


def _put(tree, path: Tuple, leaf) -> None:
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = leaf


def _skeleton(tree):
    """``tree``'s containers (as dicts and lists) with None leaves."""
    if isinstance(tree, Mapping):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def tree_unflatten(like, leaves):
    """A tree of ``like``'s containers holding ``leaves`` in
    ``tree_leaves`` order (the inverse of ``tree_leaves``)."""
    out = _skeleton(like)
    for path, leaf in zip(_paths(like), leaves):
        _put(out, path, leaf)
    return out


def _map_inexact(fn, tree):
    """Apply ``fn`` to every floating leaf, keeping integer leaves as they are."""
    return tree_map(lambda x: fn(x) if _inexact(x) else x, tree)


def _zeros_like(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _norm_leaves(tree) -> Iterator[Any]:
    """The floating leaves in ``tree_leaves`` order, each ``SparseRowGrad``
    as one leaf (its ``(rows, vals)``)."""
    if isinstance(tree, SparseRowGrad):
        yield tree
    elif isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _norm_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _norm_leaves(v)
    elif _inexact(tree):
        yield tree


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every floating leaf (integer leaves carry no gradient),
    ``multi_tensor.global_norm``: one kernel over the tree on CUDA."""
    return multi_tensor.global_norm(list(_norm_leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _dense_clip_scale(grads, max_norm: float) -> torch.Tensor:
    # the clip of the leaves updated densely: all but the SparseRowGrads
    return _clip_scale(multi_tensor.global_norm([g for g in _norm_leaves(
        grads) if not isinstance(g, SparseRowGrad)]), max_norm)


def _pool_rows(store: torch.Tensor) -> torch.Tensor:
    # flat (R, D) or padded (n_ps, max_range, D): a (rows, D) view
    return store.reshape(-1, store.shape[-1])


def clip_by_norm(grads, norm: torch.Tensor, max_norm: float):
    """``grads`` clipped to ``max_norm``, given their global norm ``norm``."""
    scale = _clip_scale(norm, max_norm)
    return _map_inexact(lambda g: g * scale.to(g.dtype), grads)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    return clip_by_norm(grads, norm, max_norm), norm


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
        some = next(tree_leaves(params))
        state = {"m": _zeros_like(params), "v": _zeros_like(params),
                 "count": torch.zeros((), dtype=torch.int32,
                                      device=some.device)}
        if master_weights:
            state["master"] = tree_map(lambda p: p.float(), params)
        return state

    def run(grads, state, params, *, apply: bool, donate: bool):
        """Leaf by leaf: (updates or new params, new state). ``donate``
        empties each leaf's slot in ``grads``, ``params`` and ``state`` once
        it is used, so that nothing but the caller's own references keeps
        the old tensors alive."""
        scale = None
        if clip_norm is not None:
            scale = _dense_clip_scale(grads, clip_norm)
        count = state["count"] + 1
        tc = count.float()
        bias1, bias2 = 1 - b1 ** tc, 1 - b2 ** tc
        out, m_out, v_out = (_skeleton(params), _skeleton(params),
                             _skeleton(params))
        master_out = _skeleton(params) if master_weights else None
        for path in list(_paths(params)):
            g = _get(grads, path, donate)
            p = _get(params, path, donate)
            if isinstance(g, SparseRowGrad):
                if master_weights or not apply:
                    raise ValueError("adam: only apply without master "
                                     "weights takes a SparseRowGrad leaf")
                m, v = (_get(state[k], path, donate) for k in ("m", "v"))
                update_rows(g.rows, g.vals,
                            {"m": m, "v": v, "count": state["count"]}, p)
                for tree, leaf in ((out, p), (m_out, m), (v_out, v)):
                    _put(tree, path, leaf)
                continue
            if scale is not None:
                g = g * scale.to(g.dtype)
            g32 = g.float()
            del g
            m = b1 * _get(state["m"], path, donate) + (1 - b1) * g32
            v = b2 * _get(state["v"], path, donate) + \
                (1 - b2) * torch.square(g32)
            del g32
            _put(m_out, path, m)
            _put(v_out, path, v)
            mh = m / bias1
            vh = v / bias2
            if master_weights:
                w = _get(state["master"], path, donate)
                new_master = w - lr * (mh / (torch.sqrt(vh) + eps)
                                       + weight_decay * w)
                del w
                _put(master_out, path, new_master)
                upd = new_master.to(p.dtype) - p
            else:
                upd = (-lr * (mh / (torch.sqrt(vh) + eps)
                              + weight_decay * p.float())).to(p.dtype)
            del mh, vh
            _put(out, path, p + upd if apply else upd)
            del p, upd
        new_state = {"m": m_out, "v": v_out, "count": count}
        if master_weights:
            new_state["master"] = master_out
        return out, new_state

    def update(grads, state, params):
        return run(grads, state, params, apply=False, donate=False)

    def apply(grads, state, params, donate: bool = False):
        return run(grads, state, params, apply=True, donate=donate)

    def update_rows(rows, row_grads, state, params):
        # lazy (row-wise) adam: moments of untouched rows are NOT decayed;
        # the bias correction uses the step's count, as the dense leaves do
        tc = (state["count"] + 1).float()
        new_params, new_m, new_v = kernel_ops.fused_row_update(
            _pool_rows(params), rows, row_grads, _pool_rows(state["m"]),
            _pool_rows(state["v"]), kind="adam", lr=lr, b1=b1, b2=b2,
            eps=eps, count=tc, weight_decay=weight_decay)
        return new_params, {"m": new_m, "v": new_v}

    return Optimizer(init, update,
                     update_rows=None if master_weights else update_rows,
                     clip_norm=clip_norm, apply=apply)


def adamw(lr: float, *, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def adagrad(lr: float, *, eps: float = 1e-10,
            clip_norm: Optional[float] = None) -> Optimizer:
    """The classic DLRM optimizer (sparse-friendly per-coordinate scaling)."""
    def init(params):
        return {"acc": _zeros_like(params)}

    def run(grads, state, params, apply: bool):
        """(updates or new params, new state): every dense leaf at once
        (``multi_tensor.dense_adagrad``), clipped by their global norm
        where ``clip_norm`` is set, then each ``SparseRowGrad`` leaf's
        rows in place (``update_rows``)."""
        scale = None
        if clip_norm is not None:
            scale = _dense_clip_scale(grads, clip_norm)
        gs, accs, ps, sparse = [], [], [], []

        def collect(p, g, a):
            if not isinstance(g, SparseRowGrad):
                gs.append(g)
                accs.append(a)
                ps.append(p)
            elif apply:
                sparse.append((g, a, p))
            else:
                raise ValueError("adagrad: only apply takes a SparseRowGrad")

        tree_map(collect, params, grads, state["acc"])
        outs, new_accs = multi_tensor.dense_adagrad(
            gs, accs, ps, lr=lr, eps=eps, scale=scale, apply=apply)
        for g, a, p in sparse:
            update_rows(g.rows, g.vals, {"acc": a}, p)
        out_it, acc_it = iter(outs), iter(new_accs)
        return (tree_map(lambda p, g: p if isinstance(g, SparseRowGrad)
                         else next(out_it), params, grads),
                {"acc": tree_map(lambda p, g, a: a if isinstance(
                    g, SparseRowGrad) else next(acc_it), params, grads,
                    state["acc"])})

    def update(grads, state, params):
        return run(grads, state, params, apply=False)

    def apply(grads, state, params, donate: bool = False):
        return run(grads, state, params, apply=True)

    def update_rows(rows, row_grads, state, params):
        # row-wise adagrad is bit-exact vs the dense path up to FMA ULPs:
        # untouched rows see g == 0, an exact no-op
        new_params, new_acc = kernel_ops.fused_row_update(
            _pool_rows(params), rows, row_grads, _pool_rows(state["acc"]),
            kind="adagrad", lr=lr, eps=eps)
        return new_params, {"acc": new_acc}

    return Optimizer(init, update, update_rows=update_rows,
                     clip_norm=clip_norm, apply=apply)


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
            mom = tree_map(lambda m, g: momentum * m + g.float(),
                           state["mom"], grads)
            updates = tree_map(lambda m, p: (-lr * m).to(p.dtype), mom,
                               params)
            return updates, {"mom": mom}
        updates = tree_map(lambda g, p: (-lr * g).to(p.dtype), grads, params)
        return updates, state

    return Optimizer(init, update, clip_norm=clip_norm)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


def update_and_apply(optimizer: Optimizer, grads, state, params, *,
                     donate: bool = False):
    """``(new_params, new_state)``: the optimizer's ``apply`` where it has
    one (adam, adagrad), else ``update`` + ``apply_updates``.
    ``donate`` lets ``apply`` empty the leaf slots of ``grads``, ``params``
    and ``state`` as it goes; the caller must not read them afterwards."""
    if optimizer.apply is not None:
        return optimizer.apply(grads, state, params, donate=donate)
    updates, new_state = optimizer.update(grads, state, params)
    return apply_updates(params, updates), new_state


def make(name: str, lr: float, **kw) -> Optimizer:
    return {"adam": adam, "adamw": adamw, "adagrad": adagrad, "sgd": sgd}[name](lr, **kw)
