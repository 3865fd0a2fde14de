"""Plain PyTorch reference of DLRM-DCNv2 for the CPU tests: f32, TF32 off,
importing no JAX and nothing of the port.

Written from the model's equations (MLPerf Training's
``recommendation_v2/torchrec_dlrm``; Wang et al., DCN V2, arXiv
2008.13535), not from the program:

- the 26 (here ``T``) tables' bags: table ``t`` has ``sizes[t]`` lookups a
  sample, sample-major in ``sparse`` (B, sum(sizes)), each bag the sum of
  its rows;
- the bottom MLP over the dense features, ReLU on every layer;
- ``x0 = [bottom(dense), bag_0, ..., bag_{T-1}]``;
- the low-rank cross network, ``x_{l+1} = x0 * (W_l (V_l x_l) + b_l) +
  x_l``;
- the over MLP, ReLU on every layer but the last, one logit;
- the mean binary cross-entropy with logits (``torch.nn.functional``).

Departures, each the port's convention: the tables are one pooled
``(R, D)`` store addressed by per-table row offsets; weight matrices are
``(in, out)``, so ``x @ v`` is ``V x``; the optimizer is element-wise
adagrad on every parameter (MLPerf's reference takes row-wise adagrad for
the tables); the gradient of the store is dense, and an element whose
gradient is 0 does not move, as in the program's row-wise update.

Parameters are ``{name: tensor}`` under the program's names: ``tables``,
``bot.w{i}``, ``bot.b{i}``, ``cross.v{l}``, ``cross.w{l}``,
``cross_b.b{l}``, ``mlp.w{i}``, ``mlp.b{i}``, ``mlp.w_out``, ``mlp.b_out``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def bags(table: torch.Tensor, sparse: torch.Tensor,
         table_rows: Sequence[int], sizes: Sequence[int]) -> torch.Tensor:
    """(B, T, D) summed bags of the (B, sum(sizes)) per-table-local ids."""
    out: List[torch.Tensor] = []
    col, row0 = 0, 0
    for rows, h in zip(table_rows, sizes):
        ids = sparse[:, col:col + h].long() + row0
        out.append(table[ids].sum(dim=1))
        col += h
        row0 += int(rows)
    return torch.stack(out, dim=1)


def logits(params: Params, batch: Dict[str, torch.Tensor], *,
           table_rows: Sequence[int], sizes: Sequence[int],
           n_bottom: int, n_cross: int, n_over: int) -> torch.Tensor:
    """(B,) click logits of one batch."""
    h = batch["dense"]
    for i in range(n_bottom):
        h = torch.relu(h @ params[f"bot.w{i}"] + params[f"bot.b{i}"])
    emb = bags(params["tables"], batch["sparse"], table_rows, sizes)
    x0 = torch.cat([h, emb.reshape(emb.shape[0], -1)], dim=1)
    x = x0
    for li in range(n_cross):
        low = x @ params[f"cross.v{li}"]
        x = x0 * (low @ params[f"cross.w{li}"] + params[f"cross_b.b{li}"]) + x
    for i in range(n_over):
        x = torch.relu(x @ params[f"mlp.w{i}"] + params[f"mlp.b{i}"])
    return (x @ params["mlp.w_out"] + params["mlp.b_out"])[:, 0]


def loss(params: Params, batch, **model) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against the labels."""
    return F.binary_cross_entropy_with_logits(logits(params, batch, **model),
                                              batch["label"].float())


def adagrad_steps(params: Params, batches, *, lr: float, eps: float,
                  **model) -> tuple:
    """Element-wise adagrad from ``params`` (left as they are), one step a
    batch: ``(params after the last step, [loss of each step])``."""
    cur = {k: v.detach().clone() for k, v in params.items()}
    acc = {k: torch.zeros_like(v) for k, v in cur.items()}
    names = sorted(cur)
    losses = []
    for batch in batches:
        leaves = {k: cur[k].clone().requires_grad_() for k in names}
        value = loss(leaves, batch, **model)
        grads = torch.autograd.grad(value, [leaves[k] for k in names])
        losses.append(float(value.detach()))
        with torch.no_grad():
            for k, g in zip(names, grads):
                acc[k] = acc[k] + g * g
                cur[k] = cur[k] - lr * g / (torch.sqrt(acc[k]) + eps)
    return cur, losses
