"""xDeepFM's CIN: the outer products of a layer and their contraction.

A CIN layer with input maps ``xk`` (B, H, D) and fields ``x0`` (B, m, D)
forms the outer products ``xk[b, h, d] * x0[b, j, d]`` and contracts them
with the layer's weight (H, m, n). Both functions here lay the products out
as the row-major (B*D, H*m) operand of that contraction's ``torch.mm``:

* ``cin_product(xk, x0)``: ``z[b*D + d, h*m + j] = xk[b, h, d] * x0[b, j,
  d]``, the (B*D, H*m) operand itself;
* ``cin_contract(gz, xk, x0)``: from ``gz``, z's (B*D, H*m) cotangent,
  ``(gxk, gx0)`` with ``gxk[b, h, d] = sum_j gz[b*D + d, h*m + j] *
  x0[b, j, d]`` and ``gx0[b, j, d] = sum_h gz[b*D + d, h*m + j] *
  xk[b, h, d]``. ``gxk`` is a (B, H, D) view of (B, D, H) memory, the
  layout of the previous layer's ``torch.mm`` output; ``gx0`` is contiguous.

Neither replaces a Pallas kernel: the reference computes the CIN with two
``jnp.einsum``s a layer in XLA. CUDA tensors launch the kernels of
``csrc/cin.cu``, which read ``xk`` and ``x0`` through their strides (a
layer's input maps are a permuted view of the previous ``torch.mm``
output) and take float32 alone; anything else they do not take raises.
CPU and meta tensors run the plain versions, the einsum expressions the
port ran before. On the card the product equals its plain version bit for
bit (one rounded multiply an element). The contraction rounds each product
and sums in the order of ATen's CUDA sum, so for 1 < m < 128 (and 16
outputs or more) it equals, bit for bit, the eager ``(g * x0[:,
None]).sum(2)`` and ``(g * xk[:, :, None]).sum(1)`` over ``g = gz.view(B,
D, H, m).permute(0, 2, 3, 1)``: what autograd ran over the product
before, and what ``portbench``'s plain reference runs. Its sums are within
a rounding of the plain einsums, not equal to them.

Counts: ``cuda_lib.LAUNCHES["cin_product"]`` and ``["cin_contract"]`` add
one a launch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import cuda_lib

MAX_SMEM_BYTES = 48 * 1024


def _shapes(xk: torch.Tensor, x0: torch.Tensor, what: str):
    """(B, H, m, D) of a layer's maps; raises on shapes that do not pair."""
    if xk.dim() != 3 or x0.dim() != 3 or xk.shape[0] != x0.shape[0] \
            or xk.shape[2] != x0.shape[2]:
        raise ValueError(f"{what}: xk (B, H, D) and x0 (B, m, D) must share "
                         f"B and D, got {tuple(xk.shape)} and "
                         f"{tuple(x0.shape)}")
    B, H, D = xk.shape
    return B, H, x0.shape[1], D


def _device(what: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors on more than one device")
    if dev.type != "cuda" and dev.type not in cuda_lib.PLAIN_DEVICES:
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def cin_product_plain(xk: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    B, H, m, D = _shapes(xk, x0, "cin_product")
    return torch.einsum("bhd,bmd->bdhm", xk, x0).reshape(B * D, H * m)


def cin_contract_plain(gz: torch.Tensor, xk: torch.Tensor, x0: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, H, m, D = _shapes(xk, x0, "cin_contract")
    g = gz.reshape(B, D, H, m)
    gxk = torch.einsum("bdhj,bjd->bdh", g, x0).permute(0, 2, 1)
    return gxk, torch.einsum("bdhj,bhd->bjd", g, xk)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
def smem_bytes(contract: bool, H: int, m: int, D: int) -> int:
    """A launch's shared memory: the staged maps, and for the contraction a
    row of ``gz`` and the sample's ``gx0`` (its least: the kernel takes
    more rows a pass where they fit)."""
    maps = (H + m) * D
    if not contract:
        return 4 * maps
    return 4 * (maps + H * m + m * D)


def _check(what: str, contract: bool, H, m, D, *tensors) -> None:
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{what}: the kernel takes float32 alone, got "
                         f"{[str(t.dtype) for t in tensors]}")
    need = smem_bytes(contract, H, m, D)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"{what}: H={H}, m={m}, D={D} need {need} bytes of "
                         f"shared memory, more than {MAX_SMEM_BYTES}")


def _maps(x: torch.Tensor) -> Tuple[int, int, int, int]:
    """A (B, R, D) tensor as the kernels' ``Maps``: pointer and strides."""
    return (x.data_ptr(), *x.stride())


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def cin_product_cuda(xk: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    B, H, m, D = _shapes(xk, x0, "cin_product")
    _check("cin_product", False, H, m, D, xk, x0)
    z = torch.empty((B * D, H * m), dtype=torch.float32, device=xk.device)
    vec = (D * H * m) % 4 == 0 and z.data_ptr() % 16 == 0
    status = cuda_lib.load().repro_cin_product_f32(
        *_maps(xk), *_maps(x0), B, H, m, D, z.data_ptr(), int(vec),
        _stream(xk.device))
    cuda_lib.check(status, "cin_product")
    cuda_lib.LAUNCHES["cin_product"] += 1
    return z


def cin_contract_cuda(gz: torch.Tensor, xk: torch.Tensor, x0: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, H, m, D = _shapes(xk, x0, "cin_contract")
    if gz.shape != (B * D, H * m) or not gz.is_contiguous():
        raise ValueError(f"cin_contract: gz must be a contiguous "
                         f"({B * D}, {H * m}) tensor, got "
                         f"{tuple(gz.shape)} strides {gz.stride()}")
    _check("cin_contract", True, H, m, D, gz, xk, x0)
    dev = gz.device
    gxk = torch.empty((B, D, H), dtype=torch.float32, device=dev)
    gx0 = torch.empty((B, m, D), dtype=torch.float32, device=dev)
    vec = (H * m) % 4 == 0 and gz.data_ptr() % 16 == 0
    status = cuda_lib.load().repro_cin_contract_f32(
        gz.data_ptr(), *_maps(xk), *_maps(x0), B, H, m, D, gxk.data_ptr(),
        gx0.data_ptr(), int(vec), _stream(dev))
    cuda_lib.check(status, "cin_contract")
    cuda_lib.LAUNCHES["cin_contract"] += 1
    return gxk.permute(0, 2, 1), gx0


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def cin_product(xk: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """The (B*D, H*m) outer products of ``xk`` (B, H, D) and ``x0``
    (B, m, D), laid out for ``torch.mm`` with the (H*m, n) weight."""
    if _device("cin_product", xk, x0).type == "cuda":
        return cin_product_cuda(xk, x0)
    return cin_product_plain(xk, x0)


def cin_contract(gz: torch.Tensor, xk: torch.Tensor, x0: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(gxk, gx0)``, the cotangents of ``xk`` and ``x0`` from ``gz``, the
    (B*D, H*m) cotangent of ``cin_product(xk, x0)``."""
    if _device("cin_contract", gz, xk, x0).type == "cuda":
        return cin_contract_cuda(gz, xk, x0)
    return cin_contract_plain(gz, xk, x0)
