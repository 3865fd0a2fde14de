"""Driver: the port's fused sparse DLRM train step, back to back.

The program under test is ``repro_torch.train.trainer.make_dlrm_train_step``
as ``repro_torch.launch.train`` builds it for ``--full --fused-update
--padded-shards``: adagrad at the traffic file's learning rate, a padded
PS layout of ``n_ps`` uniform ranges, and the config's embedding
plan with ``hot_rows`` cached rows and ``sparse_update=True``. Its weights
are the benchmark's (``reference.dlrm.make_weights``, drawn on the device
from the seed), padded by the program's layout.

Set-up builds that one train state and step and drives them through the
checked steps (the first ``checked_steps`` batches of the pool), reading
the program's loss of each, the first gradient from the optimizer's state
after one step and each leaf's change after all of them; then a few more
warm-up steps. The window runs the same step on the same state over the
pool, cycling, with no host sync of its own: losses stay on the device and
are read after the window. Once it has closed and the state is freed, the
reference repeats the checked steps from the same weights and batches.

With ``trace`` the window is followed by ``profiled_steps`` steps under the
profiler; the per-layer readings come from both.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict

import torch

from portbench.reference import dlrm as reference
from portbench.yardstick import check, counts, trace
from portbench.yardstick import traffic as gen


def program_step(cfg, optimizer, plan) -> Callable:
    """The step under test (a seam the harness's fault tests break)."""
    from repro_torch.train import trainer
    return trainer.make_dlrm_train_step(cfg, optimizer, plan=plan)


def _program_config(config: dict, traffic: dict):
    from repro_torch.configs.dlrm_models import DLRMConfig
    cfg = DLRMConfig(
        name=config["name"], kind=config["kind"], n_dense=config["n_dense"],
        n_tables=config["n_tables"], table_rows=tuple(config["table_rows"]),
        embed_dim=config["embed_dim"], mlp_dims=tuple(config["mlp_dims"]),
        batch_size=traffic["batch"], pooling=config["pooling"],
        multi_hot=traffic["lookups_per_table"],
        zipf_alpha=float(traffic["zipf_alpha"]),
        hot_rows_k=int(traffic["hot_rows"]))
    if "cin_layers" in config:
        cfg = dataclasses.replace(cfg, cin_layers=tuple(config["cin_layers"]))
    return cfg


def build(config: dict, traffic: dict, weights: Dict[str, torch.Tensor]):
    """``(state, step)`` of the program on ``weights``' device, the stores
    padded by a layout of ``n_ps`` uniform ranges. Raises if ``weights``
    do not hold exactly the program's parameters."""
    from repro_torch.models import dlrm as dlrm_mod
    from repro_torch.sharding.policy import (padded_layout_for_ranges,
                                             uniform_vocab_ranges)
    from repro_torch.train import optim

    cfg = _program_config(config, traffic)
    probe = dataclasses.replace(cfg, table_rows=(1,) * cfg.n_tables)
    names = set(dlrm_mod.init_dlrm(probe, torch.Generator().manual_seed(0)))
    if names != set(weights):
        raise ValueError(f"weights {sorted(weights)} are not the program's "
                         f"parameters {sorted(names)}")
    layout = padded_layout_for_ranges(uniform_vocab_ranges(
        cfg.total_embedding_rows, int(traffic["n_ps"])))
    stores = dlrm_mod.sparse_param_keys(cfg)
    params = {k: layout.pad_rows(v) if k in stores else v.clone()
              for k, v in weights.items()}
    opt = optim.make("adagrad", float(traffic["lr"]),
                     eps=float(traffic["eps"]))
    state = {"params": params, "opt": opt.init(params), "step": 0}
    plan = cfg.embedding_plan(layout=layout, sparse_update=True)
    return state, program_step(cfg, opt, plan)


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def checked_steps(state, step, batches) -> tuple:
    """Run the program's checked steps; ``(state, readings)`` with the
    readings of ``reference.train``'s form."""
    p0 = {k: v.clone() for k, v in state["params"].items()}
    a0 = {k: v.clone() for k, v in state["opt"]["acc"].items()}
    losses, grad = [], {}
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        losses.append(m["loss"])
        if i == 0:
            # adagrad's accumulator starts the step at a0 and ends it at
            # a0 + g * g: the gradient the optimizer got
            acc = state["opt"]["acc"]
            grad = {k: float(torch.sqrt(torch.sum(
                acc[k].double() - a0[k].double()))) for k in acc}
            del a0
    change = {k: _norm(state["params"][k] - p0[k]) for k in p0}
    return state, {"losses": [float(x) for x in losses], "grad_norm": grad,
                   "change_norm": change}


def _window(state, step, pool, start: int, seconds: float, sync,
            host_time: bool = False) -> dict:
    """Steps back to back over the pool from ``start`` until ``seconds``
    have passed, then a device sync."""
    losses = []
    host_s = 0.0
    n = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        batch = pool[(start + n) % len(pool)]
        if host_time:
            h0 = time.perf_counter()
            state, m = step(state, batch)
            host_s += time.perf_counter() - h0
        else:
            state, m = step(state, batch)
        losses.append(m["loss"])
        n += 1
        if time.perf_counter() >= deadline:
            break
    sync()
    wall = time.perf_counter() - t0
    return {"state": state, "steps": n, "wall_s": wall, "host_s": host_s,
            "losses": losses}


def run(ctx) -> dict:
    """One run of a cell; ``ctx`` carries ``config``, ``traffic``,
    ``limits``, ``seed``, ``seconds``, ``trace``, ``device``, ``t_start``
    (the process's start on ``time.perf_counter``) and ``peaks``."""
    config, traffic, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    lookups = traffic["lookups_per_table"]
    B = traffic["batch"]
    n_checked = int(traffic["checked_steps"])

    # --- set-up ------------------------------------------------------------
    weights = reference.make_weights(
        config, lookups, gen.generator(ctx.seed, gen.WEIGHTS_STREAM, dev))
    state, step = build(config, traffic, weights)
    del weights
    pool = gen.make_pool(config, traffic, ctx.seed, dev)
    if len(pool) <= n_checked:
        raise ValueError("pool_batches must exceed checked_steps")
    state, prog = checked_steps(state, step, pool[:n_checked])
    at = n_checked
    for _ in range(int(traffic["warmup_steps"])):
        state, _ = step(state, pool[at % len(pool)])
        at += 1
    distinct = None
    if ctx.trace:
        distinct = [gen.distinct_rows(b, config["table_rows"]) for b in pool]
    sync()
    setup_s = time.perf_counter() - ctx.t_start
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # --- the window ----------------------------------------------------------
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    w = _window(state, step, pool, at, ctx.seconds, sync, host_time=ctx.trace)
    state = w.pop("state")
    at += w["steps"]
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    losses = list(w["losses"])

    readings: dict = {"peaks": ctx.peaks}
    breakdown = None
    if ctx.trace:
        flops = counts.train_flops_per_sample(config) * B
        readings.update({
            "untraced_steps": w["steps"], "untraced_wall_s": w["wall_s"],
            "host_step_s": w["host_s"], "train_flops": flops * w["steps"],
            "peak_flop_per_s": _peak_flops(config, ctx.peaks)})
        n_prof = int(traffic["profiled_steps"])
        first = at
        box = {"state": state}

        def profiled():
            for i in range(n_prof):
                with torch.profiler.record_function(trace.STEP):
                    box["state"], m = step(box["state"],
                                           pool[(first + i) % len(pool)])
                losses.append(m["loss"])

        reduced = trace.profile(profiled) if cuda else {}
        state = box.pop("state")
        used = [distinct[(first + i) % len(pool)] for i in range(n_prof)]
        dims = counts.sparse_stores(config)
        readings.update({
            "trace": reduced, "profiled_steps": n_prof,
            "k1_bytes": sum(counts.k1_bytes(d, B, config["n_tables"],
                                            lookups, dim)
                            for d in used for dim in dims),
            "k2_bytes": sum(counts.k2_bytes(d, dim)
                            for d in used for dim in dims)})
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
        config, lookups, gen.generator(ctx.seed, gen.WEIGHTS_STREAM, dev))
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


def _peak_flops(config: dict, peaks: dict):
    """The card's peak for the config's arithmetic: float32 outside the
    tensor cores when TF32 is off."""
    if config.get("dtype", "float32") != "float32" or config.get("tf32"):
        raise ValueError("only float32 with TF32 off has a peak here")
    return None if peaks is None else peaks["f32_flop_per_s"]
