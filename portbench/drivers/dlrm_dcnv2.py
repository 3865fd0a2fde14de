"""Driver: the port's fused sparse DLRM-DCNv2 train step, back to back.

The program under test is ``repro_torch.train.trainer.make_dlrm_train_step``
on the config's ``dcnv2`` model, as ``repro_torch.launch.train --arch
dlrm_dcnv2 --fused-update --padded-shards`` builds it: adagrad at the
traffic file's learning rate, a padded PS layout of ``n_ps`` uniform
ranges, ragged multi-hot bags of the traffic file's sizes, ``hot_rows``
cached rows and ``sparse_update=True``. Its weights are the benchmark's
(``reference.dlrm_dcnv2.make_weights``, drawn on the device from the
seed), padded by the program's layout.

The program's config is built, and checked against the program's
parameters, before any weight is drawn: a program without the model fails
within seconds. Memory is reckoned for an 80 GB card: the 14.94 GB table
is drawn, padded (the flat draw freed before adagrad's accumulator, 14.94
GB more, is made), and the checked steps snapshot only the rows their
batches touch (with the dense parameters), not the whole store.

Set-up then runs the checked steps (the first ``checked_steps`` batches of
the pool), reading the program's loss of each, the first gradient from
the accumulator after one step (it starts at zero) and each leaf's change
after all of them; then a few more warm-up steps. The window
(``dlrm_train._window``) runs the same step over the pool, cycling, with
no host sync of its own. Once it has closed and the state is freed, the
reference repeats the checked steps from the same weights and batches.

With ``trace`` the window is followed by ``profiled_steps`` steps under the
profiler; its trace is reduced by ``yardstick/trace.py`` and, into
``spans``, by ``yardstick/spans.py``, for the per-layer readings.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict

import torch

from portbench.drivers import dlrm_train
from portbench.reference import dlrm_dcnv2 as reference
from portbench.yardstick import (check, counts, counts_dcnv2, multihot, spans,
                                 trace)
from portbench.yardstick import traffic as gen

STORE = "tables"


def tables_of(config: dict, traffic: dict) -> tuple:
    """``(config, traffic)`` with the bag sizes of the config's
    ``n_tables`` tables alone: a config cut to its first tables (as the
    benchmark's CPU tests cut every cell) keeps those tables' sizes."""
    T = config["n_tables"]
    if len(config["table_rows"]) != T or len(config["multi_hot"]) < T:
        raise ValueError(f"{T} tables need {T} row counts and bag sizes")
    return (dict(config, multi_hot=list(config["multi_hot"][:T])),
            dict(traffic, lookups_per_table=list(
                traffic["lookups_per_table"][:T])))


def program_config(config: dict, traffic: dict):
    """The program's ``DLRMConfig`` of the cell; raises if the program has
    no such model or its parameters are not the reference's."""
    from repro_torch.configs.dlrm_models import DLRMConfig
    from repro_torch.models import dlrm as dlrm_mod
    if list(traffic["lookups_per_table"]) != list(config["multi_hot"]):
        raise ValueError("the traffic's lookups per table are not the "
                         "config's multi_hot sizes")
    cfg = DLRMConfig(
        name=config["name"], kind=config["kind"], n_dense=config["n_dense"],
        n_tables=config["n_tables"], table_rows=tuple(config["table_rows"]),
        embed_dim=config["embed_dim"], mlp_dims=tuple(config["mlp_dims"]),
        bottom_mlp_dims=tuple(config["bottom_mlp_dims"]),
        cross_layers=config["cross_layers"],
        cross_low_rank=config["cross_low_rank"],
        batch_size=traffic["batch"], pooling=config["pooling"],
        multi_hot=tuple(traffic["lookups_per_table"]),
        zipf_alpha=float(traffic["zipf_alpha"]),
        hot_rows_k=int(traffic["hot_rows"]))
    probe = dataclasses.replace(cfg, table_rows=(1,) * cfg.n_tables)
    got = {k: tuple(v.shape) for k, v in dlrm_mod.init_dlrm(
        probe, torch.Generator().manual_seed(0)).items() if k != STORE}
    want = {k: shape for k, (shape, _) in reference.param_shapes(
        config).items() if k != STORE}
    if got != want:
        raise ValueError(f"the program's parameters {got} are not the "
                         f"reference's {want}")
    return cfg


def build(cfg, traffic: dict, weights: Dict[str, torch.Tensor],
          optimizer: str = "adagrad"):
    """``(state, step, layout)`` of the program on ``weights``' device,
    training with ``optimizer`` (the cell's: adagrad) at the traffic's lr
    and eps. Takes the tables out of ``weights`` (the flat draw is freed
    once padded)."""
    from repro_torch.sharding.policy import (padded_layout_for_ranges,
                                             uniform_vocab_ranges)
    from repro_torch.train import optim

    layout = padded_layout_for_ranges(uniform_vocab_ranges(
        cfg.total_embedding_rows, int(traffic["n_ps"])))
    flat = weights.pop(STORE)
    params = {STORE: layout.pad_rows(flat)}
    del flat
    params.update({k: v.clone() for k, v in weights.items()})
    opt = optim.make(optimizer, float(traffic["lr"]),
                     eps=float(traffic["eps"]))
    state = {"params": params, "opt": opt.init(params), "step": 0}
    plan = cfg.embedding_plan(layout=layout, sparse_update=True)
    return state, dlrm_train.program_step(cfg, opt, plan), layout


def padded_rows(batches, config: dict, traffic: dict, layout
                ) -> torch.Tensor:
    """The distinct rows of the flattened padded store that ``batches``
    look up."""
    flat = torch.unique(torch.cat([multihot.flat_rows(
        b["sparse"], config["table_rows"], traffic["lookups_per_table"])
        for b in batches]))
    starts = torch.tensor(layout.shard_starts, device=flat.device)
    shard = torch.searchsorted(starts, flat, right=True) - 1
    return shard * layout.max_range + flat - starts[shard]


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def checked_steps(state, step, batches, rows: torch.Tensor) -> tuple:
    """Run the program's checked steps from a fresh state (adagrad's
    accumulators zero); ``(state, readings)`` in ``reference.train``'s
    form. Of the store only ``rows``, the padded rows the batches touch,
    are read: no other row moves."""
    store = state["params"][STORE]
    flat = store.reshape(-1, store.shape[-1])
    p0 = {k: v.clone() for k, v in state["params"].items() if k != STORE}
    p0[STORE] = flat[rows]
    losses, grad = [], {}
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        losses.append(m["loss"])
        if i == 0:
            # the accumulator starts at zero and ends the step at g * g
            acc = state["opt"]["acc"]
            grad = {k: float(torch.sqrt(torch.sum(acc[k].double())))
                    for k in acc if k != STORE}
            a = acc[STORE].reshape(-1, store.shape[-1])
            grad[STORE] = float(torch.sqrt(torch.sum(a[rows].double())))
    change = {k: _norm(state["params"][k] - p0[k]) for k in p0
              if k != STORE}
    change[STORE] = _norm(flat[rows] - p0[STORE])
    return state, {"losses": [float(x) for x in losses], "grad_norm": grad,
                   "change_norm": change}


def profile(fn: Callable[[], None]) -> dict:
    """``trace.profile(fn)`` with the program's spans: the trace reduced by
    ``trace.reduce``, plus ``spans``, by ``spans.reduce``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = trace.reduce(events)
    if out:
        out["spans"] = spans.reduce(events)
    return out


def run(ctx) -> dict:
    """One run of a cell; ``ctx`` as ``dlrm_train.run`` takes it."""
    config, traffic = tables_of(ctx.config, ctx.traffic)
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    lookups = traffic["lookups_per_table"]
    B = traffic["batch"]
    n_checked = int(traffic["checked_steps"])

    # --- set-up ------------------------------------------------------------
    cfg = program_config(config, traffic)
    weights = reference.make_weights(
        config, gen.generator(ctx.seed, gen.WEIGHTS_STREAM, dev))
    state, step, layout = build(cfg, traffic, weights)
    del weights
    pool = multihot.make_pool(config, traffic, ctx.seed, dev)
    if len(pool) <= n_checked:
        raise ValueError("pool_batches must exceed checked_steps")
    rows = padded_rows(pool[:n_checked], config, traffic, layout)
    state, prog = checked_steps(state, step, pool[:n_checked], rows)
    del rows
    at = n_checked
    for _ in range(int(traffic["warmup_steps"])):
        state, _ = step(state, pool[at % len(pool)])
        at += 1
    distinct = None
    if ctx.trace:
        distinct = [multihot.distinct_rows(b, config["table_rows"], lookups)
                    for b in pool]
    sync()
    setup_s = time.perf_counter() - ctx.t_start
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # --- the window ----------------------------------------------------------
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    w = dlrm_train._window(state, step, pool, at, ctx.seconds, sync, host_time=ctx.trace)
    state = w.pop("state")
    at += w["steps"]
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    losses = list(w["losses"])

    readings: dict = {"peaks": ctx.peaks}
    breakdown = None
    if ctx.trace:
        flops = counts_dcnv2.train_flops_per_sample(config) * B
        readings.update({
            "untraced_steps": w["steps"], "untraced_wall_s": w["wall_s"],
            "host_step_s": w["host_s"],
            "train_flops": flops * w["steps"],
            "peak_flop_per_s": None if ctx.peaks is None
            else ctx.peaks["f32_flop_per_s"]})
        n_prof = int(traffic["profiled_steps"])
        first = at
        box = {"state": state}

        def profiled():
            for i in range(n_prof):
                with torch.profiler.record_function(trace.STEP):
                    box["state"], m = step(box["state"],
                                           pool[(first + i) % len(pool)])
                losses.append(m["loss"])

        reduced = profile(profiled) if cuda else {}
        state = box.pop("state")
        used = [distinct[(first + i) % len(pool)] for i in range(n_prof)]
        D = config["embed_dim"]
        readings.update({
            "trace": reduced, "profiled_steps": n_prof,
            "k1_d128_bytes": sum(counts_dcnv2.k1_bytes(
                d, B, lookups, config["n_tables"], D) for d in used),
            "k2_d128_bytes": sum(counts.k2_bytes(d, D) for d in used)})
        if reduced:
            breakdown = {"device_ops": trace.top(reduced["kernels"]),
                         "idle_gaps": trace.top(reduced["gaps"])}
    loss_t = torch.stack(losses)
    failed = int((~torch.isfinite(loss_t)).sum())

    # --- the reference, once the program's state is freed -------------------
    del state, step, loss_t, losses
    checked = pool[:n_checked]
    del pool
    if cuda:
        torch.cuda.empty_cache()
    weights = reference.make_weights(
        config, gen.generator(ctx.seed, gen.WEIGHTS_STREAM, dev))
    ref = reference.train(weights, checked, config, lr=float(traffic["lr"]),
                          eps=float(traffic["eps"]), precision="f32")
    correct, checks = check.verdict(check.readings(prog, ref), ctx.limits)

    attempted = w["steps"] + (int(traffic["profiled_steps"]) if ctx.trace
                              else 0)
    return {
        "correct": correct and failed == 0,
        "attempted": attempted, "failed": failed, "checks": checks,
        "end_to_end": {"train_samples_per_s": w["steps"] * B / w["wall_s"],
                       "peak_mem_gib": window_peak / 2 ** 30,
                       "setup_s": setup_s},
        "readings": readings, "breakdown": breakdown,
        "memory_peak_bytes": max(setup_peak, window_peak)}
