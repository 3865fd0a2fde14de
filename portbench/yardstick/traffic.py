"""The traffic generator: Criteo-like DLRM batches made on the device.

A vectorised copy of the formulas of ``repro_torch/data/synthetic.py``
(``criteo_batch``, ``zipf_indices``): dense features N(0, 1), per-table
bounded-Zipf row ids ``P(id = i) ∝ (i + 1)^-alpha`` (``alpha = 0`` is
uniform), and a label drawn from a logistic of a dense projection plus the
parity of the first buckets. The program's version walks samples one by one
in numpy; this one draws a whole batch in a few calls of a ``torch.Generator``
on the batch's device, so a pool of batches costs a fraction of a second.

Every number comes from ``seed``: the same seed gives the same pool on the
same device.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

Batch = Dict[str, torch.Tensor]

# generator streams of one seed: the weights draw from one, the data from the
# other, so a traffic file that changes the pool leaves the weights alone
WEIGHTS_STREAM, DATA_STREAM = 0, 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The ``torch.Generator`` of ``(seed, stream)`` on ``device``."""
    return torch.Generator(device=device).manual_seed(
        (2 * int(seed) + stream) % (1 << 63))


def zipf_from_uniform(u: torch.Tensor, rows: torch.Tensor,
                      alpha: float) -> torch.Tensor:
    """Bounded-Zipf row ids in ``[0, rows)`` from uniforms ``u`` in [0, 1).

    ``zipf_indices``'s inverse-CDF formula in float64: ``x`` is continuous
    in ``[1, rows]``, floored, capped at ``rows`` and shifted to start at 0.
    ``alpha <= 0`` gives the uniform ids ``floor(u * rows)``.
    """
    u = u.double()
    rows = rows.double()
    if alpha <= 0.0:
        return torch.minimum(torch.floor(u * rows), rows - 1).long()
    if abs(alpha - 1.0) < 1e-9:
        x = torch.exp(u * torch.log(rows))
    else:
        x = ((rows ** (1.0 - alpha) - 1.0) * u + 1.0) ** (1.0 / (1.0 - alpha))
    return torch.minimum(x.long(), rows.long()) - 1


def criteo_batch(table_rows: Sequence[int], n_dense: int, batch: int,
                 lookups: int, alpha: float, gen: torch.Generator) -> Batch:
    """One batch ``{dense (B, n_dense) f32, sparse (B, T, H) int32 local
    ids, label (B,) f32}`` on the generator's device."""
    dev = gen.device
    T = len(table_rows)
    dense = torch.randn((batch, n_dense), generator=gen, device=dev)
    u = torch.rand((batch, T, lookups), generator=gen, device=dev,
                   dtype=torch.float64)
    rows = torch.tensor(list(table_rows), device=dev)[None, :, None]
    sparse = zipf_from_uniform(u, rows, alpha)
    w_dense = torch.linspace(-1.0, 1.0, n_dense, device=dev)
    logit = dense @ w_dense
    logit = logit + 0.5 * ((sparse[:, 0, 0] % 2).float() - 0.5) * 2
    logit = logit + 0.25 * ((sparse[:, 1 % T, 0] % 4 == 0).float() - 0.25) * 4
    p = 1.0 / (1.0 + torch.exp(-logit))
    draw = torch.rand((batch,), generator=gen, device=dev)
    return {"dense": dense, "sparse": sparse.to(torch.int32),
            "label": (draw < p).float()}


def make_pool(config: dict, traffic: dict, seed: int, device) -> List[Batch]:
    """The traffic file's pool of batches for ``config``, from ``seed``."""
    gen = generator(seed, DATA_STREAM, device)
    return [criteo_batch(config["table_rows"], config["n_dense"],
                         traffic["batch"], traffic["lookups_per_table"],
                         float(traffic["zipf_alpha"]), gen)
            for _ in range(traffic["pool_batches"])]


def offsets(table_rows: Sequence[int]) -> List[int]:
    """Exclusive row offsets of each table in the pooled store."""
    out, acc = [], 0
    for r in table_rows:
        out.append(acc)
        acc += int(r)
    return out


def flat_rows(sparse: torch.Tensor, table_rows: Sequence[int]) -> torch.Tensor:
    """(B, T, H) per-table ids -> (B*T*H,) int64 rows of the pooled store."""
    offs = torch.tensor(offsets(table_rows), device=sparse.device)
    return (sparse.long() + offs[None, :, None]).reshape(-1)


def distinct_rows(batch: Batch, table_rows: Sequence[int]) -> int:
    """Distinct pooled rows one batch looks up (a host sync)."""
    return int(torch.unique(flat_rows(batch["sparse"], table_rows)).numel())
