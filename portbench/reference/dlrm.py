"""Plain PyTorch reference of the DLRM train step: Wide&Deep and xDeepFM.

Written from the models' equations, not from the program: the pooled store
is one flat ``(R, D)`` table read by plain indexing, the dense network is
explicit matrix products, the gradient is ``torch.autograd`` over every
parameter (the tables' gradient is dense) and adagrad updates every element
(an element whose gradient is 0 does not move, as in a row-wise update).

Precision: ``"f32"`` computes every product in float32 with TF32 off.
``"tf32"`` is the control: every matrix product takes its inputs rounded to
TF32's 10-bit mantissa and accumulates in float32. On a CUDA device it runs
the card's own TF32 path; elsewhere the rounding is emulated.

Parameters are ``{name: tensor}`` under the program's names (``tables``,
``wide``, ``wide_dense``, ``mlp.w0`` ... ``mlp.b_out``, ``cin.w0`` ...
``cin.w_out``), weight matrices ``(in, out)``. ``make_weights`` draws them;
the benchmark hands the same draw to the program and to this reference.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch

Params = Dict[str, torch.Tensor]


def _offsets(table_rows: Sequence[int]) -> List[int]:
    out, acc = [], 0
    for r in table_rows:
        out.append(acc)
        acc += int(r)
    return out


def param_shapes(config: dict, lookups: int) -> Dict[str, tuple]:
    """``{name: (shape, init scale)}`` of every parameter; scale 0 is a
    zero-initialised bias."""
    D, T = config["embed_dim"], config["n_tables"]
    R = sum(config["table_rows"])
    d_in = config["n_dense"] + T * D
    out = {"tables": ((R, D), 1 / math.sqrt(D))}
    if config["kind"] == "wide_deep":
        out["wide"] = ((R, 1), 1 / math.sqrt(T * lookups))
        out["wide_dense"] = ((config["n_dense"],),
                             1 / math.sqrt(config["n_dense"]))
    prev = d_in
    for i, h in enumerate(config["mlp_dims"]):
        out[f"mlp.w{i}"] = ((prev, h), 1 / math.sqrt(prev))
        out[f"mlp.b{i}"] = ((h,), 0.0)
        prev = h
    out["mlp.w_out"] = ((prev, 1), 1 / math.sqrt(prev))
    out["mlp.b_out"] = ((1,), 0.0)
    if config["kind"] == "xdeepfm":
        prev_maps = T
        for i, maps in enumerate(config["cin_layers"]):
            out[f"cin.w{i}"] = ((prev_maps, T, maps),
                                1 / math.sqrt(prev_maps * T))
            prev_maps = maps
        total = sum(config["cin_layers"])
        out["cin.w_out"] = ((total,), 1 / math.sqrt(total))
    return out


def make_weights(config: dict, lookups: int, gen: torch.Generator) -> Params:
    """Every parameter, f32 on the generator's device, in three draws: the
    tables, the wide table, and one for all dense weights."""
    dev = gen.device
    shapes = param_shapes(config, lookups)
    params: Params = {}
    for big in ("tables", "wide"):
        if big in shapes:
            shape, s = shapes[big]
            params[big] = torch.randn(shape, generator=gen, device=dev).mul_(s)
    rest = [k for k in shapes if k not in params]
    n = sum(math.prod(shapes[k][0]) for k in rest)
    flat = torch.randn((n,), generator=gen, device=dev)
    at = 0
    for k in rest:
        shape, s = shapes[k]
        size = math.prod(shape)
        params[k] = flat[at:at + size].reshape(shape).mul(s)
        at += size
    return params


# --- matrix products -------------------------------------------------------
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

    @contextlib.contextmanager
    def scope(self):
        flags = torch.backends.cuda.matmul
        before = flags.allow_tf32
        flags.allow_tf32 = self.name == "tf32" and self.device.type == "cuda"
        try:
            yield
        finally:
            flags.allow_tf32 = before


# --- the model ---------------------------------------------------------------
def _pooled(table: torch.Tensor, rows: torch.Tensor, B: int, T: int, H: int,
            pooling: str) -> torch.Tensor:
    """(B, T, D) bags of the flat rows ``rows`` (B*T*H,)."""
    got = table[rows].reshape(B, T, H, table.shape[1])
    if pooling == "sum":
        return got.sum(dim=2)
    if pooling == "mean":
        return got.mean(dim=2)
    if pooling == "max":
        return got.amax(dim=2)
    raise ValueError(pooling)


def _mlp(params: Params, x: torch.Tensor, n_layers: int,
         p: Precision) -> torch.Tensor:
    for i in range(n_layers):
        x = torch.relu(p.mm(x, params[f"mlp.w{i}"]) + params[f"mlp.b{i}"])
    return (p.mm(x, params["mlp.w_out"]) + params["mlp.b_out"])[:, 0]


def _cin(params: Params, x0: torch.Tensor, n_layers: int,
         p: Precision) -> torch.Tensor:
    """xDeepFM's compressed interaction network: layer k forms the outer
    products of X^{k-1} (B, H, D) and X^0 (B, m, D) along each embedding
    coordinate and contracts them with W^k (H, m, n) into X^k (B, n, D);
    the output is the sum over D of every layer's maps, times ``w_out``."""
    B, m, D = x0.shape
    xk = x0
    feats = []
    for i in range(n_layers):
        w = params[f"cin.w{i}"]
        H, n = w.shape[0], w.shape[2]
        z = xk[:, :, None, :] * x0[:, None, :, :]              # (B, H, m, D)
        z = z.permute(0, 3, 1, 2).reshape(B * D, H * m)
        xk = p.mm(z, w.reshape(H * m, n)).reshape(B, D, n).permute(0, 2, 1)
        feats.append(xk.sum(dim=-1))                            # (B, n)
    return p.mm(torch.cat(feats, dim=-1), params["cin.w_out"][:, None])[:, 0]


def logits(params: Params, batch: Dict[str, torch.Tensor], config: dict,
           p: Precision) -> torch.Tensor:
    """(B,) click logits of one batch."""
    B, T, H = batch["sparse"].shape
    offs = torch.tensor(_offsets(config["table_rows"]),
                        device=batch["sparse"].device)
    rows = (batch["sparse"].long() + offs[None, :, None]).reshape(-1)
    emb = _pooled(params["tables"], rows, B, T, H, config["pooling"])
    x0 = torch.cat([batch["dense"], emb.reshape(B, -1)], dim=-1)
    out = _mlp(params, x0, len(config["mlp_dims"]), p)
    if config["kind"] == "wide_deep":
        wide = _pooled(params["wide"], rows, B, T, H, "sum")
        out = out + p.mm(batch["dense"], params["wide_dense"][:, None])[:, 0] \
            + wide[..., 0].sum(dim=1)
    elif config["kind"] == "xdeepfm":
        out = out + _cin(params, emb, len(config["cin_layers"]), p)
    else:
        raise ValueError(config["kind"])
    return out


def loss(params: Params, batch, config: dict, p: Precision) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against the labels."""
    z = logits(params, batch, config, p)
    y = batch["label"].float()
    return torch.mean(torch.clamp(z, min=0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def train(params: Params, batches, config: dict, *, lr: float, eps: float,
          precision: str = "f32") -> dict:
    """Adagrad steps from ``params`` (left as they are), one per batch.

    Returns ``{"losses": [...], "grad_norm": {leaf: |g_1|}, "change_norm":
    {leaf: |p_n - p_0|}}``: the loss of each step, every leaf's gradient
    norm at the first step and every leaf's change over all of them, as
    Python floats (norms in float64).
    """
    dev = next(iter(params.values())).device
    p = Precision(precision, dev)
    cur = {k: v.clone() for k, v in params.items()}
    acc = {k: torch.zeros_like(v) for k, v in params.items()}
    names = sorted(cur)
    losses, grad_norm = [], {}
    with p.scope():
        for step, batch in enumerate(batches):
            leaves = {k: cur[k].detach().requires_grad_() for k in names}
            value = loss(leaves, batch, config, p)
            grads = torch.autograd.grad(value, [leaves[k] for k in names])
            losses.append(float(value.detach()))
            with torch.no_grad():
                for k, g in zip(names, grads):
                    if step == 0:
                        grad_norm[k] = float(torch.linalg.vector_norm(
                            g.double()))
                    acc[k] = acc[k] + torch.square(g)
                    cur[k] = cur[k] + (-lr * g / (torch.sqrt(acc[k]) + eps))
                del grads, leaves
    change = {k: float(torch.linalg.vector_norm((cur[k] - params[k]).double()))
              for k in names}
    return {"losses": losses, "grad_norm": grad_norm, "change_norm": change}
