"""Plain PyTorch reference of the DLRM-DCNv2 train step, sized to sit
beside a 15 GB table on one card.

Written from the model's equations (MLPerf Training's
``recommendation_v2/torchrec_dlrm``; Wang et al., DCN V2, arXiv
2008.13535), not from the program:

- the bags: table ``t`` has ``multi_hot[t]`` lookups a sample,
  sample-major in ``sparse`` (B, sum(multi_hot)), each bag the sum of its
  rows;
- the bottom MLP over the dense features, ReLU on every layer;
- ``x0 = [bottom(dense), bag_0, ..., bag_25]`` (B, 3456);
- the low-rank cross network, ``x_{l+1} = x0 * (W_l (V_l x_l) + b_l) +
  x_l``;
- the over MLP, ReLU on every layer but the last, one logit;
- the mean binary cross-entropy with logits.

The store is one flat ``(R, D)`` table addressed by per-table row
offsets. Each step gathers the batch's distinct rows into a leaf, takes
the gradient of that leaf by ``torch.autograd`` (not a dense (R, D)
gradient) and updates those rows of the table **in place**, in row blocks,
with element-wise adagrad whose accumulator is kept for the rows touched
so far. Under adagrad this equals the dense update: a row whose gradient
is zero does not move, and its accumulator stays zero. Every other
parameter is updated whole.

Departures, each the port's convention: weight matrices are ``(in,
out)``, so ``x @ v`` is ``V x``; the optimizer is element-wise adagrad
(the MLPerf reference takes row-wise adagrad for the tables) at the
traffic file's lr and eps; weights are seeded normal draws
(``make_weights``), not the reference's initialisation.

Order of operations: each bag is summed one lookup after another, each
layer's bias is added in its product (``addmm``), and a cross layer's
``x0 * y + x_l`` is one ``addcmul``, the forms the program takes, so that
in float32 the first step's forward agrees with the program's and so do
its ReLUs' masks. A ReLU whose input sits within a rounding of zero flips
on a one-ulp difference, and one flipped unit moves the gradient of a
batch of 8,192 by ~1e-4 of its norm: with the forward in other orders
(bags by ``sum``, bias and product apart) such flips made the program's
first-gradient gap reach 2.3e-4 on one seed of 24 and overlap the TF32
control's (``PERF.md`` §2). The backward is autograd's throughout.

Precision: ``"f32"`` computes every product in float32 with TF32 off;
``"tf32"`` is the control: every matrix product takes its inputs rounded
to TF32's 10-bit mantissa and accumulates in float32, on a CUDA device by
the card's own TF32 path, elsewhere emulated (``reference/dlrm.py``'s
``Precision``, repeated here so that the reference imports only torch).

Parameters are ``{name: tensor}`` under the program's names: ``tables``,
``bot.w{i}``, ``bot.b{i}``, ``cross.v{l}``, ``cross.w{l}``,
``cross_b.b{l}``, ``mlp.w{i}``, ``mlp.b{i}``, ``mlp.w_out``,
``mlp.b_out``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch

Params = Dict[str, torch.Tensor]
ROW_BLOCK = 1 << 18          # rows updated at a time


# --- matrix products (reference/dlrm.py's) -----------------------------------
def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from 0)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """``a @ b`` with TF32-rounded inputs, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _round_tf32(a) @ _round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round_tf32(g)
        return g @ _round_tf32(b).transpose(-1, -2), \
            _round_tf32(a).transpose(-1, -2) @ g


class Precision:
    """The matrix product of one precision; ``with p.scope():`` around a
    whole forward and backward."""

    def __init__(self, name: str, device):
        if name not in ("f32", "tf32"):
            raise ValueError(f"precision {name!r}: f32 or tf32")
        self.name = name
        self.device = torch.device(device)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32" and self.device.type != "cuda":
            return _TF32Matmul.apply(a, b)
        return a @ b

    def addmm(self, c: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
        """``c + a @ b``, the bias added in the product."""
        if self.name == "tf32" and self.device.type != "cuda":
            return c + _TF32Matmul.apply(a, b)
        return torch.addmm(c, a, b)

    @contextlib.contextmanager
    def scope(self):
        flags = torch.backends.cuda.matmul
        before = flags.allow_tf32
        flags.allow_tf32 = self.name == "tf32" and self.device.type == "cuda"
        try:
            yield
        finally:
            flags.allow_tf32 = before


def param_shapes(config: dict) -> Dict[str, tuple]:
    """``{name: (shape, init scale)}`` of every parameter; scale 0 is a
    zero-initialised bias."""
    D, T = config["embed_dim"], config["n_tables"]
    R = sum(config["table_rows"])
    out = {"tables": ((R, D), 1 / math.sqrt(D))}
    prev = config["n_dense"]
    for i, h in enumerate(config["bottom_mlp_dims"]):
        out[f"bot.w{i}"] = ((prev, h), 1 / math.sqrt(prev))
        out[f"bot.b{i}"] = ((h,), 0.0)
        prev = h
    d_in = prev + T * D
    r = config["cross_low_rank"]
    for li in range(config["cross_layers"]):
        out[f"cross.v{li}"] = ((d_in, r), 1 / math.sqrt(d_in))
        out[f"cross.w{li}"] = ((r, d_in), 1 / math.sqrt(r))
        out[f"cross_b.b{li}"] = ((d_in,), 0.0)
    prev = d_in
    for i, h in enumerate(config["mlp_dims"]):
        out[f"mlp.w{i}"] = ((prev, h), 1 / math.sqrt(prev))
        out[f"mlp.b{i}"] = ((h,), 0.0)
        prev = h
    out["mlp.w_out"] = ((prev, 1), 1 / math.sqrt(prev))
    out["mlp.b_out"] = ((1,), 0.0)
    return out


def make_weights(config: dict, gen: torch.Generator) -> Params:
    """Every parameter, f32 on the generator's device, in two draws: the
    tables, then one for all dense weights."""
    dev = gen.device
    shapes = param_shapes(config)
    shape, s = shapes["tables"]
    params: Params = {
        "tables": torch.randn(shape, generator=gen, device=dev).mul_(s)}
    rest = [k for k in shapes if k != "tables"]
    flat = torch.randn((sum(math.prod(shapes[k][0]) for k in rest),),
                       generator=gen, device=dev)
    at = 0
    for k in rest:
        shape, s = shapes[k]
        size = math.prod(shape)
        params[k] = flat[at:at + size].reshape(shape).mul(s)
        at += size
    return params


def _column_offsets(config: dict, device) -> torch.Tensor:
    offs, acc = [], 0
    for rows, h in zip(config["table_rows"], config["multi_hot"]):
        offs += [acc] * int(h)
        acc += int(rows)
    return torch.tensor(offs, device=device)


def logits(dense: Params, rows: torch.Tensor, inverse: torch.Tensor,
           batch: Dict[str, torch.Tensor], config: dict,
           p: Precision) -> torch.Tensor:
    """(B,) click logits; ``rows`` (U, D) are the batch's distinct rows and
    ``inverse`` (B, sum(multi_hot)) each lookup's place among them."""
    h = batch["dense"]
    for i in range(len(config["bottom_mlp_dims"])):
        h = torch.relu(p.addmm(dense[f"bot.b{i}"], h, dense[f"bot.w{i}"]))
    got = rows[inverse]                                   # (B, L, D)
    bags, col = [], 0
    for k in config["multi_hot"]:
        bag = got[:, col]
        for j in range(col + 1, col + int(k)):
            bag = bag + got[:, j]
        bags.append(bag)
        col += int(k)
    x0 = torch.cat([h] + bags, dim=1)                      # (B, 3456)
    x = x0
    for li in range(config["cross_layers"]):
        low = p.mm(x, dense[f"cross.v{li}"])
        y = p.addmm(dense[f"cross_b.b{li}"], low, dense[f"cross.w{li}"])
        x = torch.addcmul(x, x0, y)
    for i in range(len(config["mlp_dims"])):
        x = torch.relu(p.mm(x, dense[f"mlp.w{i}"]) + dense[f"mlp.b{i}"])
    return (p.mm(x, dense["mlp.w_out"]) + dense["mlp.b_out"])[:, 0]


def _bce(z: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    y = label.float()
    return torch.mean(torch.clamp(z, min=0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


class _TouchedRows:
    """The rows of the table touched so far (sorted), their values before
    the first step and their adagrad accumulators."""

    def __init__(self, table: torch.Tensor):
        self.table = table
        self.rows = torch.zeros(0, dtype=torch.long, device=table.device)
        self.orig = table.new_zeros((0, table.shape[1]))
        self.acc = table.new_zeros((0, table.shape[1]))

    def add(self, rows: torch.Tensor) -> torch.Tensor:
        """Take in the sorted distinct ``rows``; their places in
        ``self.rows``."""
        new = rows[~torch.isin(rows, self.rows)]
        merged, perm = torch.sort(torch.cat([self.rows, new]))
        self.orig = torch.cat([self.orig, self.table[new]])[perm]
        self.acc = torch.cat([self.acc, torch.zeros_like(
            self.table[new])])[perm]
        self.rows = merged
        return torch.searchsorted(self.rows, rows)

    def update(self, rows: torch.Tensor, at: torch.Tensor, g: torch.Tensor,
               lr: float, eps: float) -> None:
        """Adagrad on ``rows`` (places ``at``) with gradient ``g``, in
        place, a block of rows at a time."""
        for i in range(0, rows.shape[0], ROW_BLOCK):
            r, a, gi = (x[i:i + ROW_BLOCK] for x in (rows, at, g))
            acc = self.acc[a] + torch.square(gi)
            self.table[r] = self.table[r] + (
                -lr * gi / (torch.sqrt(acc) + eps))
            self.acc[a] = acc

    def change_norm(self) -> float:
        return _norm(self.table[self.rows] - self.orig)


def train(params: Params, batches, config: dict, *, lr: float, eps: float,
          precision: str = "f32") -> dict:
    """Adagrad steps from ``params``, one per batch. ``params["tables"]``
    is updated in place; the other parameters are left as they are.

    Returns ``{"losses": [...], "grad_norm": {leaf: |g_1|}, "change_norm":
    {leaf: |p_n - p_0|}}``: the loss of each step, every leaf's gradient
    norm at the first step and every leaf's change over all of them, as
    Python floats (norms in float64).
    """
    table = params["tables"]
    dev = table.device
    p = Precision(precision, dev)
    names = sorted(k for k in params if k != "tables")
    cur = {k: params[k].clone() for k in names}
    acc = {k: torch.zeros_like(v) for k, v in cur.items()}
    touched = _TouchedRows(table)
    offs = _column_offsets(config, dev)
    losses: List[float] = []
    grad_norm: Dict[str, float] = {}
    with p.scope():
        for step, batch in enumerate(batches):
            flat = batch["sparse"].long() + offs[None, :]
            rows, inverse = torch.unique(flat, return_inverse=True)
            leaf = table[rows].requires_grad_()
            dense = {k: cur[k].detach().requires_grad_() for k in names}
            value = _bce(logits(dense, leaf, inverse, batch, config, p),
                         batch["label"])
            grads = torch.autograd.grad(value,
                                        [leaf] + [dense[k] for k in names])
            losses.append(float(value.detach()))
            with torch.no_grad():
                if step == 0:
                    grad_norm["tables"] = _norm(grads[0])
                for k, g in zip(names, grads[1:]):
                    if step == 0:
                        grad_norm[k] = _norm(g)
                    acc[k] = acc[k] + torch.square(g)
                    cur[k] = cur[k] + (-lr * g / (torch.sqrt(acc[k]) + eps))
                touched.update(rows, touched.add(rows), grads[0], lr, eps)
            del grads, leaf, dense
    change = {k: _norm(cur[k] - params[k]) for k in names}
    change["tables"] = touched.change_norm()
    return {"losses": losses, "grad_norm": grad_norm, "change_norm": change}
