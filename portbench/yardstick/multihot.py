"""The multi-hot traffic generator: ragged DLRM batches made on the device.

``traffic.py``'s formulas with a lookup count per table: each table ``t``
of the config has ``lookups_per_table[t]`` bounded-Zipf ids a sample
(``traffic.zipf_from_uniform``), laid out sample-major, table after table:
``sparse`` is (B, sum(lookups)) int32, bag ``(b, t)`` at columns
``[starts[t], starts[t + 1])``. Dense features are N(0, 1), and the label
is drawn from a logistic of a dense projection plus the parity of the
first ids of tables 0 and 1, as ``traffic.criteo_batch`` draws it.

Every number comes from ``seed``: the same seed gives the same pool on the
same device.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench.yardstick import traffic as gen

Batch = Dict[str, torch.Tensor]


def starts(lookups: Sequence[int]) -> List[int]:
    """The ``T + 1`` column starts of the tables' bags in a sample."""
    out = [0]
    for h in lookups:
        out.append(out[-1] + int(h))
    return out


def columns(values: Sequence[int], lookups: Sequence[int]) -> List[int]:
    """Per-table ``values`` repeated for each of the table's columns."""
    return [int(v) for v, h in zip(values, lookups) for _ in range(int(h))]


def multihot_batch(table_rows: Sequence[int], n_dense: int, batch: int,
                   lookups: Sequence[int], alpha: float,
                   g: torch.Generator) -> Batch:
    """One batch ``{dense (B, n_dense) f32, sparse (B, sum(lookups)) int32
    per-table-local ids, label (B,) f32}`` on the generator's device."""
    dev = g.device
    dense = torch.randn((batch, n_dense), generator=g, device=dev)
    width = sum(int(h) for h in lookups)
    u = torch.rand((batch, width), generator=g, device=dev,
                   dtype=torch.float64)
    rows = torch.tensor(columns(table_rows, lookups), device=dev)[None, :]
    sparse = gen.zipf_from_uniform(u, rows, alpha)
    first = starts(lookups)
    w_dense = torch.linspace(-1.0, 1.0, n_dense, device=dev)
    logit = dense @ w_dense
    logit = logit + 0.5 * ((sparse[:, first[0]] % 2).float() - 0.5) * 2
    logit = logit + 0.25 * (
        (sparse[:, first[1 % len(lookups)]] % 4 == 0).float() - 0.25) * 4
    p = 1.0 / (1.0 + torch.exp(-logit))
    draw = torch.rand((batch,), generator=g, device=dev)
    return {"dense": dense, "sparse": sparse.to(torch.int32),
            "label": (draw < p).float()}


def make_pool(config: dict, traffic: dict, seed: int, device) -> List[Batch]:
    """The traffic file's pool of batches for ``config``, from ``seed``."""
    g = gen.generator(seed, gen.DATA_STREAM, device)
    return [multihot_batch(config["table_rows"], config["n_dense"],
                           traffic["batch"], traffic["lookups_per_table"],
                           float(traffic["zipf_alpha"]), g)
            for _ in range(traffic["pool_batches"])]


def flat_rows(sparse: torch.Tensor, table_rows: Sequence[int],
              lookups: Sequence[int]) -> torch.Tensor:
    """(B, sum(lookups)) per-table ids -> (B*sum,) int64 pooled rows."""
    offs = torch.tensor(columns(gen.offsets(table_rows), lookups),
                        device=sparse.device)
    return (sparse.long() + offs[None, :]).reshape(-1)


def distinct_rows(batch: Batch, table_rows: Sequence[int],
                  lookups: Sequence[int]) -> int:
    """Distinct pooled rows one batch looks up (a host sync)."""
    return int(torch.unique(flat_rows(batch["sparse"], table_rows,
                                      lookups)).numel())
