"""Operations and bytes of the DLRM train step, from the shapes alone.

FLOPs (``train_flops_per_sample``): the model's arithmetic, forward x 3
(the backward computes the gradients of the activations and of the weights,
each as much as the forward). A multiply-add with a weight counts 2; the
CIN's outer products count 1 a product. The lookups, the dedupe and the
row update count none: they move bytes.

Bytes (``k1_bytes``, ``k2_bytes``): what the kernel's inputs need, each
input byte read once and each output byte written once, whatever the kernel
reads again.

- K1 (one fused embedding-bag call over every table): each distinct row
  looked up, read once at width ``D``; the (B, T, H) int32 lookups; the
  (B, T, D) f32 bags written.
- K2 (adagrad on the deduped rows of one pooled store): for each distinct
  row, its parameter, accumulator and gradient read and its parameter and
  accumulator written, at width ``D``, and its int32 row id read.
"""
from __future__ import annotations

F32 = 4
I32 = 4


def mlp_macs(config: dict) -> int:
    """Multiply-adds of the deep MLP, one sample."""
    prev = config["n_dense"] + config["n_tables"] * config["embed_dim"]
    macs = 0
    for h in list(config["mlp_dims"]) + [1]:
        macs += prev * h
        prev = h
    return macs


def forward_flops_per_sample(config: dict) -> int:
    """FLOPs of one sample's forward through the dense network."""
    flops = 2 * mlp_macs(config)
    if config["kind"] == "wide_deep":
        flops += 2 * config["n_dense"]                       # the wide dense dot
    elif config["kind"] == "xdeepfm":
        m, D = config["n_tables"], config["embed_dim"]
        prev = m
        for maps in config["cin_layers"]:
            flops += prev * m * D                            # outer products
            flops += 2 * prev * m * maps * D                 # contraction
            prev = maps
        flops += 2 * sum(config["cin_layers"])               # w_out
    else:
        raise ValueError(config["kind"])
    return flops


def train_flops_per_sample(config: dict) -> int:
    """Model FLOPs of one trained sample: forward x 3."""
    return 3 * forward_flops_per_sample(config)


def k1_bytes(distinct: int, batch: int, n_tables: int, lookups: int,
             dim: int) -> int:
    """Bytes one K1 call needs at width ``dim``."""
    return distinct * dim * F32 + batch * n_tables * lookups * I32 \
        + batch * n_tables * dim * F32


def k2_bytes(distinct: int, dim: int) -> int:
    """Bytes one K2 (adagrad) call needs at width ``dim``."""
    return distinct * (5 * dim * F32 + I32)


def sparse_stores(config: dict) -> list:
    """Widths of the pooled stores one step looks up and updates: the deep
    tables, and Wide&Deep's wide table."""
    dims = [config["embed_dim"]]
    if config["kind"] == "wide_deep":
        dims.append(1)
    return dims
