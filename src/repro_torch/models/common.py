"""Shared init helper (port of ``dense_init`` of ``repro/models/common.py``)."""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, shape, in_axis_size: int,
               dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 1/sqrt(in_axis_size)) init drawn from ``generator``, on the
    generator's device. The reference's distribution; not its bits (JAX and
    torch generators differ), so parity tests load the reference's params
    through ``models.dlrm.params_from_jax``."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * scale).to(dtype)
