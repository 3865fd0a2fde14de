"""Fused row-wise optimizer updates: touched rows only, in place.

Port of ``repro/kernels/fused_update.py``. Consumes the deduped COO row
gradients of ``fused_embedding.sparse_row_grads`` (``rows`` (N,) store rows
with a sentinel tail ``>= R``, ``vals`` (N, D) f32 summed cotangents) and
applies row-wise adagrad (K2) or lazy row-wise adam (K3) to exactly those
rows of the parameter pool and its moment pools.

Unlike the JAX reference, which returns new arrays, both versions update
the pools in place: the full-width pools are 211 MB each, and a touched-rows
update should move only the touched rows.

* CUDA tensors launch K2/K3 (``csrc/fused_update.cu``).
* CPU tensors run the plain versions ``adagrad_rows_plain`` /
  ``adam_rows_plain``: the reference's gather → row-wise expression →
  scatter, with the sentinel rows masked out explicitly (JAX's scatter
  drops them; ``index_put_`` would raise on the CPU and device-assert on
  CUDA).

The kernels spell every operation with CUDA's ``_rn`` intrinsics, which nvcc
never contracts into FMAs, in the plain versions' order, so on the card the
two agree bit for bit; against the JAX reference (whose compiler may
contract) they agree within ULP bounds.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import cuda_lib


def _live(params: torch.Tensor, rows: torch.Tensor,
          vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows below ``R`` (as int64) and their values; the sentinel tail goes."""
    live = rows < params.shape[0]
    return rows[live].long(), vals[live]


def _check_rows(kernel: str, params: torch.Tensor, rows: torch.Tensor,
                vals: torch.Tensor, *pools: torch.Tensor) -> None:
    if not params.is_cuda or params.dtype != torch.float32 \
            or params.dim() != 2 or not params.is_contiguous():
        raise ValueError(f"{kernel}: params must be a contiguous (R, D) "
                         f"float32 CUDA tensor, got {params.dtype} "
                         f"{tuple(params.shape)} on {params.device}")
    for p in pools:
        if p.device != params.device or p.dtype != torch.float32 \
                or p.shape != params.shape or not p.is_contiguous():
            raise ValueError(f"{kernel}: moment pools must be contiguous "
                             "float32 tensors shaped like params on its "
                             "device")
    if rows.device != params.device or rows.dtype != torch.int32 \
            or rows.dim() != 1 or not rows.is_contiguous():
        raise ValueError(f"{kernel}: rows must be a contiguous (N,) int32 "
                         "tensor on the params' device")
    if vals.device != params.device or vals.dtype != torch.float32 \
            or tuple(vals.shape) != (rows.shape[0], params.shape[1]) \
            or not vals.is_contiguous():
        raise ValueError(f"{kernel}: vals must be a contiguous (N, D) "
                         "float32 tensor on the params' device")


# ---------------------------------------------------------------------------
# adagrad (K2)
# ---------------------------------------------------------------------------
def adagrad_rows_plain(params, acc, rows, vals, *, lr: float, eps: float):
    """Plain version of K2, in place."""
    r, g = _live(params, rows, vals)
    acc_rows = acc[r] + torch.square(g)
    upd = (-lr * g / (torch.sqrt(acc_rows) + eps)).to(params.dtype)
    params[r] = params[r] + upd
    acc[r] = acc_rows


def adagrad_rows_cuda(params, acc, rows, vals, *, lr: float, eps: float):
    """Launch K2 on CUDA tensors (raises on anything else).

    Replaces the TPU kernel ``_adagrad_kernel`` of
    ``repro/kernels/fused_update.py``. Bound by bytes: 5 x D x 4 B per live
    row, at most about 17 MB a call at full Wide&Deep width; one thread per
    (row, d) keeps every access a contiguous row segment, and unique rows
    need no atomics.
    """
    _check_rows("adagrad_row_update", params, rows, vals, acc)
    lib = cuda_lib.load()
    R, D = params.shape
    status = lib.repro_adagrad_rows_f32(
        params.data_ptr(), acc.data_ptr(), R, D, rows.data_ptr(),
        vals.data_ptr(), rows.shape[0], -lr, eps,
        torch.cuda.current_stream(params.device).cuda_stream)
    cuda_lib.check(status, "adagrad_row_update")
    cuda_lib.LAUNCHES["adagrad_row_update"] += 1


def adagrad_row_update(params: torch.Tensor, acc: torch.Tensor,
                       rows: torch.Tensor, vals: torch.Tensor, *,
                       lr: float, eps: float = 1e-10
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise adagrad on deduped COO row grads, in place. -> (params, acc).

    Args:
      params: (R, D) parameter pool (flat or padded view).
      acc:    (R, D) f32 accumulator pool in the same row space.
      rows:   (N,) int32 deduplicated store rows; entries ``>= R`` are
              padding.
      vals:   (N, D) summed row gradients (zero on padding entries).
      lr/eps: adagrad hyperparameters.

    K2 on CUDA tensors, the plain version on CPU tensors.
    """
    vals = vals.float()
    if params.is_cuda:
        adagrad_rows_cuda(params, acc, rows.to(torch.int32).contiguous(),
                          vals.contiguous(), lr=lr, eps=eps)
    elif params.device.type == "cpu":
        adagrad_rows_plain(params, acc, rows, vals, lr=lr, eps=eps)
    else:
        raise ValueError(f"adagrad_row_update: unsupported device "
                         f"{params.device}")
    return params, acc


# ---------------------------------------------------------------------------
# adam, lazy row-wise (K3)
# ---------------------------------------------------------------------------
def adam_rows_plain(params, m, v, rows, vals, bias, *, lr, b1, b2, eps, wd):
    """Plain version of K3, in place."""
    r, g = _live(params, rows, vals)
    m_rows = b1 * m[r] + (1 - b1) * g
    v_rows = b2 * v[r] + (1 - b2) * torch.square(g)
    mh = m_rows / bias[0]
    vh = v_rows / bias[1]
    p32 = params[r].float()
    upd = (-lr * (mh / (torch.sqrt(vh) + eps) + wd * p32)).to(params.dtype)
    params[r] = params[r] + upd
    m[r] = m_rows
    v[r] = v_rows


def adam_rows_cuda(params, m, v, rows, vals, bias, *, lr, b1, b2, eps, wd):
    """Launch K3 on CUDA tensors (raises on anything else).

    Replaces the TPU kernel ``_adam_kernel`` of
    ``repro/kernels/fused_update.py``. Bound by bytes: 7 x D x 4 B per live
    row, at most about 24 MB a call at full Wide&Deep width; the same
    one-thread-per-(row, d) layout as K2, with the bias pair read from
    device memory.
    """
    _check_rows("adam_row_update", params, rows, vals, m, v)
    if bias.device != params.device or bias.dtype != torch.float32 \
            or tuple(bias.shape) != (2,) or not bias.is_contiguous():
        raise ValueError("adam_row_update: bias must be a contiguous (2,) "
                         "float32 tensor on the params' device")
    lib = cuda_lib.load()
    R, D = params.shape
    status = lib.repro_adam_rows_f32(
        params.data_ptr(), m.data_ptr(), v.data_ptr(), R, D, rows.data_ptr(),
        vals.data_ptr(), bias.data_ptr(), rows.shape[0], -lr, b1, 1 - b1, b2,
        1 - b2, eps, wd, torch.cuda.current_stream(params.device).cuda_stream)
    cuda_lib.check(status, "adam_row_update")
    cuda_lib.LAUNCHES["adam_row_update"] += 1


def adam_bias(count, b1: float, b2: float, device) -> torch.Tensor:
    """The (2,) f32 bias-correction pair ``[1 - b1^t, 1 - b2^t]``."""
    tc = torch.as_tensor(count, dtype=torch.float32, device=device)
    return torch.stack([1 - b1 ** tc, 1 - b2 ** tc])


def adam_row_update(params: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    rows: torch.Tensor, vals: torch.Tensor, *, lr: float,
                    count, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8, weight_decay: float = 0.0):
    """Lazy row-wise adam on deduped COO row grads, in place. -> (params, m, v).

    Args:
      params: (R, D) parameter pool.
      m, v:   (R, D) f32 moment pools in the same row space.
      rows:   (N,) int32 deduplicated store rows; entries ``>= R`` are
              padding.
      vals:   (N, D) summed row gradients.
      count:  the step count after this step (the dense update's counter).

    Untouched rows' moments are not decayed and get no weight decay. The
    bias pair is computed once, in f32 on the params' device, and feeds both
    versions.
    """
    vals = vals.float()
    bias = adam_bias(count, b1, b2, params.device)
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, wd=weight_decay)
    if params.is_cuda:
        adam_rows_cuda(params, m, v, rows.to(torch.int32).contiguous(),
                       vals.contiguous(), bias, **kw)
    elif params.device.type == "cpu":
        adam_rows_plain(params, m, v, rows, vals, bias, **kw)
    else:
        raise ValueError(f"adam_row_update: unsupported device {params.device}")
    return params, m, v
