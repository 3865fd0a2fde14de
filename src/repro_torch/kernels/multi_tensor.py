"""The optimizer layer's multi-tensor kernels: the squared global norm of a
gradient tree and the dense adagrad update, each one launch over every leaf.

Neither replaces a Pallas kernel: the reference computes both in XLA
(``global_norm`` and ``adagrad`` of ``repro/train/optim.py``). Their plain
versions here are the port's expressions for them, one leaf and one op at a
time; ``train/optim.py`` calls this module for both.

* ``grad_sq_norm(leaves)``: the sum over the leaves of
  ``torch.sum(torch.square(l.float()))``, a 0-dim f32 tensor on the leaves'
  device. A leaf is a floating tensor or a ``(rows, vals)`` pair, a
  ``SparseRowGrad``: deduped row ids ascending, the distinct rows first and
  the sentinel tail after them with zero values (``fused_embedding
  .dedupe_rows``' form). The kernel reads such a leaf up to the first entry
  of its last row id, never the padding, which adds +0 to the sum; the
  plain version reads ``vals`` whole. ``global_norm`` is its square root.
* ``dense_adagrad(grads, accs, params, ...)``: adagrad on dense leaves,
  optionally clipped by a scale on the device, returning fresh new params
  (or the updates) and accumulators; the tensors passed in are not written.

CUDA leaves launch the kernels of ``csrc/multi_tensor.cu``: the norm in two
launches at most per 64 leaves (the partial sums, then one finishing block
that also writes the square root), the update in one per 64 leaves. The
leaves' pointers and sizes travel in the launch's arguments. CPU and meta
leaves run the plain versions; any other device raises. On the card the
update equals its plain version bit for bit (the same ``_rn`` operations in
the same order); the norm adds its f32 squares in double, in a fixed order,
so it is within a rounding of the plain f32 sum and deterministic, not
equal to it.

Counts: ``cuda_lib.LAUNCHES["grad_sq_norm"]`` and ``["dense_adagrad"]`` add
one a call that launches; ``cuda_lib.LEAF_COUNTS["dense_leaves"]`` adds the
leaves of every ``dense_adagrad`` call, ``["dense_leaves_fused"]`` those its
kernel updated.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import cuda_lib

MAX_LEAVES = 64           # leaves of one launch (kMaxLeaves in the .cu)
BLOCKS_PER_SM = 4         # the norm's grid cap per SM (kBlocksPerSm)
_BF16 = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _vals(leaf) -> torch.Tensor:
    return leaf[1] if isinstance(leaf, tuple) else leaf


def _device(tensors: Sequence[torch.Tensor], what: str) -> torch.device:
    """The tensors' one device; raises on a mix or on a device that is
    neither CUDA nor a plain one."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: leaves on more than one device")
    if dev.type != "cuda" and dev.type not in cuda_lib.PLAIN_DEVICES:
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# the global norm
# ---------------------------------------------------------------------------
def grad_sq_norm_plain(leaves) -> torch.Tensor:
    """Plain version: the Python sum of each leaf's sum of squares."""
    return sum(torch.sum(torch.square(_vals(l).float())) for l in leaves)


def _norm_cuda(leaves, dev: torch.device) -> torch.Tensor:
    """(2,) f32 on ``dev``: the squared norm, then its square root."""
    words, keep = [], []          # keep: the tensors alive until the launch
    for leaf in leaves:
        vals = _vals(leaf)
        if vals.dtype not in _BF16:
            raise ValueError(f"grad_sq_norm: leaves must be float32 or "
                             f"bfloat16, got {vals.dtype}")
        vals = vals.contiguous()
        rows, D = 0, 1
        if isinstance(leaf, tuple):
            r = leaf[0]
            if vals.dim() != 2 or r.dim() != 1 or r.shape[0] != vals.shape[0]:
                raise ValueError("grad_sq_norm: a sparse leaf is (N,) row "
                                 "ids and (N, D) values")
            r = r.to(torch.int32).contiguous()
            keep.append(r)
            rows, D = r.data_ptr(), vals.shape[1]
        keep.append(vals)
        words += [vals.data_ptr(), rows, vals.numel(), D, _BF16[vals.dtype]]
    sms = _sm_count(dev.index)
    groups = -(-len(leaves) // MAX_LEAVES)
    partials = torch.empty(groups * sms * BLOCKS_PER_SM, dtype=torch.float64,
                           device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    status = cuda_lib.load().repro_grad_sq_norm(
        (ctypes.c_longlong * len(words))(*words), len(leaves),
        partials.data_ptr(), out.data_ptr(), sms, _stream(dev))
    cuda_lib.check(status, "grad_sq_norm")
    cuda_lib.LAUNCHES["grad_sq_norm"] += 1
    return out


def _norms(leaves, root: bool) -> torch.Tensor:
    leaves = list(leaves)
    if leaves:
        dev = _device([_vals(l) for l in leaves], "grad_sq_norm")
        if dev.type == "cuda":
            return _norm_cuda(leaves, dev)[int(root)]
    plain = grad_sq_norm_plain(leaves)
    return torch.sqrt(plain) if root else plain


def grad_sq_norm(leaves) -> torch.Tensor:
    """The squared L2 norm over ``leaves`` (floating tensors and ``(rows,
    vals)`` pairs), a 0-dim f32 tensor; on CUDA leaves, without a sync."""
    return _norms(leaves, root=False)


def global_norm(leaves) -> torch.Tensor:
    """``torch.sqrt(grad_sq_norm(leaves))``; on CUDA leaves the finishing
    block writes it, so it costs no launch of its own."""
    return _norms(leaves, root=True)


# ---------------------------------------------------------------------------
# the dense adagrad update
# ---------------------------------------------------------------------------
def adagrad_leaf_plain(g, acc, p, *, lr: float, eps: float,
                       scale: Optional[torch.Tensor] = None,
                       apply: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version for one leaf: ``(p + u or u, new acc)``, the op-by-op
    path of ``clip_by_global_norm``, ``optim.adagrad``'s update and
    ``apply_updates``."""
    if scale is not None:
        g = g * scale.to(g.dtype)
    a = acc + torch.square(g.float())
    u = (-lr * g.float() / (torch.sqrt(a) + eps)).to(p.dtype)
    return (p + u if apply else u), a


def _adagrad_cuda(grads, accs, params, lr, eps, scale, apply, dev):
    outs, new_accs, words, keep = [], [], [], []
    for g, a, p in zip(grads, accs, params):
        if g.dtype not in _BF16 or p.dtype not in _BF16 \
                or a.dtype != torch.float32:
            raise ValueError(
                f"dense_adagrad: gradients and params must be float32 or "
                f"bfloat16 and accumulators float32, got {g.dtype}, "
                f"{p.dtype}, {a.dtype}")
        if not (g.numel() == a.numel() == p.numel()):
            raise ValueError(f"dense_adagrad: a leaf of {p.numel()} params "
                             f"has {g.numel()} gradients and {a.numel()} "
                             "accumulators")
        g, a, p = g.contiguous(), a.contiguous(), p.contiguous()
        keep += [g, a, p]           # alive until the launch
        out = torch.empty_like(p, memory_format=torch.contiguous_format)
        a_out = torch.empty_like(a, memory_format=torch.contiguous_format)
        outs.append(out)
        new_accs.append(a_out)
        words += [g.data_ptr(), a.data_ptr(), p.data_ptr() if apply else 0,
                  a_out.data_ptr(), out.data_ptr(), p.numel(),
                  _BF16[g.dtype] | 2 * _BF16[p.dtype]]
    if scale is not None:
        if scale.device != dev or scale.dtype != torch.float32 \
                or scale.numel() != 1:
            raise ValueError("dense_adagrad: the clip scale must be one "
                             "float32 on the leaves' device")
        scale = scale.contiguous()
    status = cuda_lib.load().repro_dense_adagrad(
        (ctypes.c_longlong * len(words))(*words), len(params), -lr, eps,
        None if scale is None else scale.data_ptr(), int(apply),
        _sm_count(dev.index), _stream(dev))
    cuda_lib.check(status, "dense_adagrad")
    cuda_lib.LAUNCHES["dense_adagrad"] += 1
    cuda_lib.LEAF_COUNTS["dense_leaves_fused"] += len(params)
    return outs, new_accs


def dense_adagrad(grads: Sequence[torch.Tensor],
                  accs: Sequence[torch.Tensor],
                  params: Sequence[torch.Tensor], *, lr: float, eps: float,
                  scale: Optional[torch.Tensor] = None, apply: bool = True
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Adagrad on dense leaves: ``(new params, new accumulators)``, or
    ``(updates, new accumulators)`` without ``apply``, as lists in the
    leaves' order. ``scale`` (0-dim f32 on the leaves' device) multiplies
    each gradient first, as ``clip_by_global_norm`` does. Fresh tensors:
    the inputs are not written. On CUDA leaves one launch (per 64 leaves);
    gradients and params f32 or bf16, accumulators f32, else it raises."""
    grads, accs, params = list(grads), list(accs), list(params)
    if not len(grads) == len(accs) == len(params):
        raise ValueError(f"dense_adagrad: {len(grads)} gradients, "
                         f"{len(accs)} accumulators, {len(params)} params")
    cuda_lib.LEAF_COUNTS["dense_leaves"] += len(params)
    if not params:
        return [], []
    dev = _device([*grads, *accs, *params], "dense_adagrad")
    if dev.type == "cuda":
        return _adagrad_cuda(grads, accs, params, lr, eps, scale, apply, dev)
    pairs = [adagrad_leaf_plain(g, a, p, lr=lr, eps=eps, scale=scale,
                                apply=apply)
             for g, a, p in zip(grads, accs, params)]
    return [o for o, _ in pairs], [a for _, a in pairs]
