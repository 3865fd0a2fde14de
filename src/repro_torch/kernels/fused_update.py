"""Fused row-wise optimizer updates: touched rows only, in place.

Port of ``repro/kernels/fused_update.py``. Consumes the deduped COO row
gradients of ``fused_embedding.sparse_row_grads`` (``rows`` (N,) store rows,
where entries ``>= R`` are padding, ``vals`` (N, D) f32 summed cotangents)
and applies row-wise adagrad (K2) or lazy row-wise adam (K3) to exactly
those rows of the parameter pool and its moment pools.

Unlike the JAX reference, which returns new arrays, both versions update
the pools in place: the full-width pools are 211 MB each, and a touched-rows
update should move only the touched rows.

* CUDA tensors launch K2/K3 (``csrc/fused_update.cu``). ``update_route``
  picks the vector route (float4 pieces of a row: 4 lanes a row at D=16,
  a warp a row at D=128, a thread a row at any other width) or the scalar
  route from the width and the alignment of the arrays; ``update_plan``
  sizes the grid, one wave at most, from the entry count, the width and
  the SM count. A launch at D=128 adds one to
  ``cuda_lib.LAUNCHES["row_update_d128"]`` besides its kernel's count.
* Padding is any row outside ``[0, R)``. The dedupe pads with ``R``; a
  negative id is padding too (the reference's scatter would wrap it), so
  both versions skip it.
* CPU tensors run the plain versions ``adagrad_rows_plain`` /
  ``adam_rows_plain``: the reference's gather → row-wise expression →
  scatter, with the padding entries masked out explicitly (JAX's scatter
  drops those ``>= R``; ``index_put_`` would raise on the CPU and device-assert on
  CUDA).

The kernels spell every operation with CUDA's ``_rn`` intrinsics, which nvcc
never contracts into FMAs, in the plain versions' order, so on the card the
two agree bit for bit; against the JAX reference (whose compiler may
contract) they agree within ULP bounds.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import cuda_lib

# Launch geometry (PERF.md: 2 or 4 rows in flight per thread, and 4-entry
# groups at D=1, measured slower than one row or entry per thread).
THREADS = 256             # per block, every K2/K3 kernel (kThreads in the .cu)
THREADS_PER_SM = 2048     # an SM's resident threads: the grid's one-wave cap
VEC_LANES = 4             # D=16: 4 lanes of a warp own a row, one float4 each


def update_route(D: int, *arrays: torch.Tensor) -> str:
    """``"vector"`` when ``D % 4 == 0`` and every array (the pools and
    ``vals``) starts on 16 bytes: the kernels move float4 pieces of a row.
    Otherwise ``"scalar"`` (the wide D=1 pool always)."""
    if D % 4 == 0 and all(a.data_ptr() % 16 == 0 for a in arrays):
        return "vector"
    return "scalar"


def update_plan(N: int, D: int, sm_count: int, route: str = "vector") -> int:
    """Blocks of ``THREADS`` for the K2/K3 launch over ``N`` entries of a
    width-``D`` pool on a card of ``sm_count`` SMs.

    D=16 on the vector route: ``VEC_LANES`` threads per entry. Any other
    case: a thread per entry (at D=128 a warp takes 32 entries). The grid
    covers that work and holds no more than ``THREADS_PER_SM`` threads per
    SM: one wave, walked by a grid-stride loop. A function of the shape
    alone; 0 when there is nothing to do."""
    if N <= 0 or D <= 0:
        return 0
    work = N * VEC_LANES if route == "vector" and D == 16 else N
    return min(-(-work // THREADS), sm_count * (THREADS_PER_SM // THREADS))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_args(params: torch.Tensor, vals: torch.Tensor, N: int,
                 *pools: torch.Tensor) -> Tuple[int, int]:
    """(vec, blocks) for the C entry points."""
    D = params.shape[1]
    route = update_route(D, params, vals, *pools)
    return (int(route == "vector"),
            update_plan(N, D, _sm_count(params.device.index), route))


def _count_d128(D: int, vec: int) -> None:
    if vec and D == 128:
        cuda_lib.LAUNCHES["row_update_d128"] += 1


def _live(params: torch.Tensor, rows: torch.Tensor,
          vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows in ``[0, R)`` (as int64) and their values; the padding goes."""
    live = (rows >= 0) & (rows < params.shape[0])
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
    row plus 4 B per entry, 7.7 MB (2.30 us at 3.35 TB/s) for the ~23,400
    live rows of a full-width Wide&Deep batch. The grid comes from
    ``update_plan`` (at most one wave of the SMs' threads): at D=16 four
    threads per row, one float4 each (vector route); at D=1 one entry and
    one word per pool per thread (scalar route); a row's loads are all in
    flight at once; padding entries cost one row-id load. One launch per
    call with work; nothing is launched for N=0.
    """
    _check_rows("adagrad_row_update", params, rows, vals, acc)
    N = rows.shape[0]
    launch = _launch_args(params, vals, N, acc)
    if launch[1] == 0:
        return
    lib = cuda_lib.load()
    R, D = params.shape
    status = lib.repro_adagrad_rows_f32(
        params.data_ptr(), acc.data_ptr(), R, D, rows.data_ptr(),
        vals.data_ptr(), N, -lr, eps, *launch,
        torch.cuda.current_stream(params.device).cuda_stream)
    cuda_lib.check(status, "adagrad_row_update")
    cuda_lib.LAUNCHES["adagrad_row_update"] += 1
    _count_d128(D, launch[0])


def adagrad_row_update(params: torch.Tensor, acc: torch.Tensor,
                       rows: torch.Tensor, vals: torch.Tensor, *,
                       lr: float, eps: float = 1e-10
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise adagrad on deduped COO row grads, in place. -> (params, acc).

    Args:
      params: (R, D) parameter pool (flat or padded view).
      acc:    (R, D) f32 accumulator pool in the same row space.
      rows:   (N,) int32 deduplicated store rows; entries outside
              ``[0, R)`` are padding.
      vals:   (N, D) summed row gradients (zero on padding entries).
      lr/eps: adagrad hyperparameters.

    K2 on CUDA tensors, the plain version on CPU tensors. Adds the N
    entries to ``cuda_lib.ROW_COUNTS["row_update_entries"]``.
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
    cuda_lib.ROW_COUNTS["row_update_entries"] += rows.shape[0]
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
    row plus 4 B per entry, 10.7 MB (3.20 us at 3.35 TB/s) for the ~23,400
    live rows of a full-width Wide&Deep batch. The same routes and plan as
    K2, with the bias pair read from device memory once per thread.
    """
    _check_rows("adam_row_update", params, rows, vals, m, v)
    if bias.device != params.device or bias.dtype != torch.float32 \
            or tuple(bias.shape) != (2,) or not bias.is_contiguous():
        raise ValueError("adam_row_update: bias must be a contiguous (2,) "
                         "float32 tensor on the params' device")
    N = rows.shape[0]
    launch = _launch_args(params, vals, N, m, v)
    if launch[1] == 0:
        return
    lib = cuda_lib.load()
    R, D = params.shape
    status = lib.repro_adam_rows_f32(
        params.data_ptr(), m.data_ptr(), v.data_ptr(), R, D, rows.data_ptr(),
        vals.data_ptr(), bias.data_ptr(), N, -lr, b1, 1 - b1, b2, 1 - b2,
        eps, wd, *launch,
        torch.cuda.current_stream(params.device).cuda_stream)
    cuda_lib.check(status, "adam_row_update")
    cuda_lib.LAUNCHES["adam_row_update"] += 1
    _count_d128(D, launch[0])


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
      rows:   (N,) int32 deduplicated store rows; entries outside
              ``[0, R)`` are padding.
      vals:   (N, D) summed row gradients.
      count:  the step count after this step (the dense update's counter).

    Untouched rows' moments are not decayed and get no weight decay. The
    bias pair is computed once, in f32 on the params' device, and feeds both
    versions. Adds the N entries to
    ``cuda_lib.ROW_COUNTS["row_update_entries"]``.
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
    cuda_lib.ROW_COUNTS["row_update_entries"] += rows.shape[0]
    return params, m, v
