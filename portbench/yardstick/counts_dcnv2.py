"""Operations and bytes of the DLRM-DCNv2 train step, from the shapes
alone, counted as ``counts.py`` counts them.

FLOPs (``train_flops_per_sample``): the matrix products, forward x 3, a
multiply-add 2: the bottom MLP (13-512-256-128), each cross layer's two
low-rank products (``x_l V_l``: d_in x rank, then ``. W_l``: rank x
d_in), and the over MLP (d_in-1024-1024-512-256-1), d_in = 27 x 128 =
3,456. At the published widths that is 16,030,464 multiply-adds a sample
forward, 10,616,832 of them (66 %) in the cross network. The cross
network's elementwise products, the lookups, the dedupe and the row
update count none.

Bytes, each input byte read once and each output byte written once:

- ``k1_bytes``: K1 on ragged bags: each distinct row looked up, read once
  at width ``D``; the (B, sum(lookups)) int32 lookups; the (B, T, D) f32
  bags written;
- K2's bytes are ``counts.k2_bytes``, whose count does not depend on the
  bags.
"""
from __future__ import annotations

F32 = 4
I32 = 4


def interaction_dim(config: dict) -> int:
    """Width of x0: the bottom MLP's output beside the 26 bags."""
    return config["bottom_mlp_dims"][-1] + config["n_tables"] * \
        config["embed_dim"]


def forward_macs_per_sample(config: dict) -> int:
    """Multiply-adds of one sample's forward through the dense network."""
    macs, prev = 0, config["n_dense"]
    for h in config["bottom_mlp_dims"]:
        macs += prev * h
        prev = h
    d_in = interaction_dim(config)
    macs += config["cross_layers"] * 2 * d_in * config["cross_low_rank"]
    prev = d_in
    for h in list(config["mlp_dims"]) + [1]:
        macs += prev * h
        prev = h
    return macs


def cross_macs_per_sample(config: dict) -> int:
    """The cross network's share of ``forward_macs_per_sample``."""
    return config["cross_layers"] * 2 * interaction_dim(config) * \
        config["cross_low_rank"]


def train_flops_per_sample(config: dict) -> int:
    """Model FLOPs of one trained sample: forward x 3."""
    return 3 * 2 * forward_macs_per_sample(config)


def k1_bytes(distinct: int, batch: int, lookups, n_tables: int,
             dim: int) -> int:
    """Bytes one K1 call on ragged bags needs at width ``dim``."""
    return distinct * dim * F32 + batch * sum(lookups) * I32 \
        + batch * n_tables * dim * F32

