"""Port parity: the auto-scaler, the scaler registry and the three-stage
``ClusterBrain`` (``repro_torch.core.{autoscaler,plugin,brain}``), and the
lifecycle example ``examples/elastic_dlrm_train_torch.py``.

Every scenario runs once against each package and is compared exactly
(``==`` on plain data: dataclasses as dicts, arrays as lists): NSGA-II
candidates, greedy plans, reclaim and refinement grids, the NSGA-II cache
cadence, degradation penalties, OOM resizes and config-DB records. The
cases are those of ``tests/test_brain.py``, ``tests/test_autoscaler.py``
and ``tests/test_serve_brain.py::test_brain_three_stage_lifecycle``.

The lifecycle example trains a small Wide&Deep on the CPU through the
reference example's events; its brain decisions are held against the
reference ``ClusterBrain`` fed the same calls by the same loop without the
training. The throughput passed to ``brain.complete`` is wall-clock: the
reference is fed the value the port measured, so the config-DB record is
compared whole. The expectations ``chip_smoke.py`` holds the card run to
(full config, ``--steps 160``) are checked here against the reference.
"""
import dataclasses
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import plain  # noqa: E402  (sets torch threads)
from repro.core import autoscaler as jas  # noqa: E402
from repro.core import brain as jbr  # noqa: E402
from repro.core import perf_model as jpm  # noqa: E402
from repro.core import sharding_service as jss  # noqa: E402
from repro.core import warm_start as jws  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.configs.dlrm_models import DLRMConfig  # noqa: E402
from repro_torch.core import autoscaler as tas  # noqa: E402
from repro_torch.core import brain as tbr  # noqa: E402
from repro_torch.core import perf_model as tpm  # noqa: E402
from repro_torch.core import plugin as tplugin  # noqa: E402
from repro_torch.core import sharding_service as tss  # noqa: E402
from repro_torch.core import warm_start as tws  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = types.SimpleNamespace(name="port", a=tas, b=tbr, pm=tpm, ws=tws,
                             ss=tss)
REF = types.SimpleNamespace(name="ref", a=jas, b=jbr, pm=jpm, ws=jws, ss=jss)

STAT = dict(batch_size=512, model_size=3.2e8, bandwidth=1e9, emb_dim=16)
ALPHA = [3.48e-3, 2.36e-3, 0.68e-3, 2.45e-5]
BETA = 2.45e-3


def both(scenario, *args):
    """The scenario's result in the port and in the reference, as plain
    data, asserted equal."""
    got, want = plain(scenario(PORT, *args)), plain(scenario(REF, *args))
    assert got == want
    return got


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- fixtures
def _stat(P):
    return P.pm.JobStatics(**STAT)


def _model(P, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    obs = []
    for _ in range(48):
        r = P.pm.JobResources(w=int(rng.integers(1, 24)),
                              p=int(rng.integers(1, 12)),
                              cpu_w=float(rng.integers(1, 32)),
                              cpu_p=float(rng.integers(1, 32)))
        obs.append((r, _stat(P), P.pm.synthesize_t_iter(
            r, _stat(P), ALPHA, BETA, noise=noise, rng=rng)))
    return P.pm.PerfModel().fit(obs)


def _job(P, jid="j0", current=None, remaining=5e6, model=None):
    return P.a.JobState(
        job_id=jid, statics=_stat(P),
        current=P.pm.JobResources(**(current or dict(w=4, p=2, cpu_w=8,
                                                      cpu_p=8))),
        model=model or _model(P), remaining_samples=remaining)


def _meta(P, kind="wide_deep", user="u0"):
    return P.ws.JobMeta(kind, dense_params=1e6, emb_rows=5e6, emb_dim=16,
                        batch_size=512, dataset_samples=1e7, user=user)


# ----------------------------------------------------------- autoscaler
CURRENTS = [dict(w=2, p=1, cpu_w=4, cpu_p=4), dict(w=4, p=2, cpu_w=8, cpu_p=8),
            dict(w=8, p=4, cpu_w=32.0, cpu_p=16.0)]


def _candidates(P, current, seed, trust, noise, pop, gens):
    job = _job(P, current=current, model=_model(P, noise=noise))
    return P.a.generate_candidates(job, seed=seed, trust_factor=trust,
                                   pop_size=pop, generations=gens)


@pytest.mark.parametrize("current,seed,trust,noise,pop,gens", [
    (0, 0, 2.0, 0.0, 12, 6), (1, 7, 1.5, 0.02, 16, 8), (2, 3, 4.0, 0.0, 12, 6),
    (1, 0, 0.0, 0.0, 40, 25)])
def test_candidates_as_in_the_reference(current, seed, trust, noise, pop,
                                        gens):
    cands = both(_candidates, CURRENTS[current], seed, trust, noise, pop,
                 gens)
    assert cands
    if trust == 2.0:    # tests/test_brain.py's trust region: whole bounds
        for c in cands:
            for k in ("w", "p", "cpu_w", "cpu_p"):
                v = CURRENTS[current][k]
                assert v / trust <= c["resources"][k] <= v * trust


def _helpers(P):
    job = _job(P)
    fat = P.pm.JobResources(w=4, p=2, cpu_w=32.0, cpu_p=32.0)
    r = P.pm.JobResources(w=2, p=1, cpu_w=4, cpu_p=4)
    return {
        "seeds": [P.a.job_seed(j) for j in ("j0", "dlrm-100m", "x" * 40)],
        "cost": [P.a.resource_cost(r, P.a.Prices()),
                 P.a.resource_cost(fat, P.a.Prices(cpu=1.0, mem_gb=0.0))],
        "overhead": P.a.ScalingOverheads().overhead_seconds(r, fat),
        "wg": [P.a.weight_wg(job, thp) for thp in (10.0, 1000.0, 1e6)],
        "idle": [P.a.predicted_idle_frac(job, job.current),
                 P.a.predicted_idle_frac(job, fat)],
        "bounds": P.a.BOUNDS, "max_cpu": P.a.MAX_JOB_CPU,
    }


def test_helpers_as_in_the_reference():
    out = both(_helpers)
    assert 0.0 <= out["idle"][0] <= out["idle"][1] <= 1.0


def _greedy(P, cap_cpu, degraded):
    model = _model(P)
    jobs = [_job(P, f"j{i}", current=CURRENTS[i % 2], model=model,
                 remaining=5e6 * (i + 1)) for i in range(3)]
    cands = {j.job_id: P.a.generate_candidates(j, seed=i, pop_size=12,
                                               generations=6)
             for i, j in enumerate(jobs)}
    if degraded:
        jobs[1].degradation = 10.0
    used = sum(j.current.total_cpu() for j in jobs)
    cap = P.a.ClusterCapacity(used + cap_cpu, 16384.0)
    return P.a.weighted_greedy_select(jobs, cands, cap)


@pytest.mark.parametrize("cap_cpu", [0.0, 40.0, 1e4])
@pytest.mark.parametrize("degraded", [False, True])
def test_greedy_as_in_the_reference(cap_cpu, degraded):
    both(_greedy, cap_cpu, degraded)


def _dlrover_rm_scaler(P):
    unfitted = P.a.JobState("cold", _stat(P), P.pm.JobResources(
        w=2, p=1, cpu_w=4, cpu_p=4), P.pm.PerfModel(), remaining_samples=1e6)
    jobs = [_job(P, "warm", current=CURRENTS[0]), unfitted]
    return P.a.dlrover_rm_scaler(jobs, P.a.ClusterCapacity(2048.0, 16384.0))


def test_dlrover_rm_scaler_as_in_the_reference():
    assert "cold" not in both(_dlrover_rm_scaler)


# ------------------------------------------------------- scaler registry
@pytest.fixture
def port_scaler():
    """A scaler in the port's registry for one test, removed after it."""
    name = "noop_port_test"

    @tplugin.register_scaler(name)
    def noop(jobs, capacity):
        return {j.job_id: j.current for j in jobs}

    yield name
    tas._REGISTRY.pop(name)


def test_registry_is_the_ports_own(port_scaler):
    assert port_scaler in tplugin.list_scalers()
    assert port_scaler not in jas.list_scalers()
    assert "dlrover_rm" in tplugin.list_scalers()
    assert tplugin.get_scaler(port_scaler)(
        [], tas.ClusterCapacity(1, 1)) == {}
    brain = tbr.ClusterBrain(tas.ClusterCapacity(2048, 16384),
                             scaler=port_scaler)
    m = _master(PORT)
    brain.admit(m)
    assert brain.optimize() == {"j0": m.resources}
    with pytest.raises(KeyError):
        tplugin.get_scaler("no_such_scaler")


def test_registry_fixture_left_nothing_behind():
    assert "noop_port_test" not in tas.list_scalers()
    assert tas.get_scaler("dlrover_rm") is tas.dlrover_rm_scaler


# ---------------------------------------------------------- brain stage 1
def _refine(P, plan):
    model = _model(P)
    r = P.pm.JobResources(**plan)
    refined = P.b.refine_allocation(r, _stat(P), model)
    return refined, P.b.refine_allocation(r, _stat(P), model, min_gain=1.0)


@pytest.mark.parametrize("plan", [dict(w=2, p=1, cpu_w=2, cpu_p=2),
                                  dict(w=16, p=8, cpu_w=32, cpu_p=32)])
def test_refine_allocation_as_in_the_reference(plan):
    both(_refine, plan)


def _allocate_then_history(P):
    brain = P.b.ClusterBrain(P.a.ClusterCapacity(2048.0, 16384.0))
    default = P.pm.JobResources(w=4, p=2, cpu_w=8, cpu_p=8)
    cold = brain.allocate(_meta(P), _stat(P), default=default)
    rng = np.random.default_rng(0)
    obs = []
    for _ in range(16):
        r = P.pm.JobResources(w=int(rng.integers(1, 16)),
                              p=int(rng.integers(1, 8)),
                              cpu_w=float(rng.integers(2, 16)),
                              cpu_p=float(rng.integers(2, 16)))
        obs.append((r, _stat(P), P.pm.synthesize_t_iter(r, _stat(P), ALPHA,
                                                        BETA)))
    brain.record_history(_meta(P), _stat(P), obs,
                         final_config=P.pm.JobResources(w=8, p=2, cpu_w=16,
                                                        cpu_p=8),
                         throughput=1e4)
    warm = brain.allocate(_meta(P), _stat(P), default=P.pm.JobResources(
        w=1, p=1, cpu_w=1, cpu_p=1))
    other = brain.allocate(_meta(P, kind="dcn", user="u7"), _stat(P))
    return (cold, warm, other, brain.kind_models,
            brain.config_db.records)


def test_allocate_and_history_as_in_the_reference():
    cold, warm, *_ = both(_allocate_then_history)
    assert cold == dict(w=4, p=2, cpu_w=8, cpu_p=8, mem_w=8.0, mem_p=16.0)
    assert warm != dict(w=1, p=1, cpu_w=1, cpu_p=1, mem_w=8.0, mem_p=16.0)


# ---------------------------------------------------------- brain stage 2
def _adjust_rounds(P, reoptimize_every, current):
    brain = P.b.ClusterBrain(P.a.ClusterCapacity(2048.0, 16384.0),
                             reoptimize_every=reoptimize_every,
                             reclaim_cooldown=3, nsga_pop=12,
                             nsga_generations=6)
    jobs = [_job(P, "a", current=current), _job(P, "b", remaining=1e5)]
    out = []
    for _ in range(4):
        plans = brain.adjust(jobs)
        out.append((plans, dict(brain._optimized_at),
                    dict(brain._last_plan_round)))
    return out


@pytest.mark.parametrize("every", [1, 2])
@pytest.mark.parametrize("current", [1, 2])
def test_adjust_rounds_as_in_the_reference(every, current):
    rounds = both(_adjust_rounds, every, CURRENTS[current])
    if every == 2:
        assert [r[1]["a"] for r in rounds] == [1, 1, 3, 3]


def _reclaim(P, fat, slack, min_cut):
    return P.b.reclaim_allocation(P.pm.JobResources(**fat), _stat(P),
                                  _model(P), slack=slack, min_cut=min_cut)


@pytest.mark.parametrize("fat", [dict(w=4, p=4, cpu_w=8.0, cpu_p=32.0),
                                 dict(w=2, p=1, cpu_w=4.0, cpu_p=4.0)])
@pytest.mark.parametrize("slack,min_cut", [(0.03, 0.15), (0.1, 0.3)])
def test_reclaim_as_in_the_reference(fat, slack, min_cut):
    both(_reclaim, fat, slack, min_cut)


# ---------------------------------------------------------- brain stage 3
def _degradation(P):
    brain = P.b.ClusterBrain(P.a.ClusterCapacity(2048.0, 16384.0),
                             degradation_halflife_s=600.0)
    out = [brain.report_degradation("j0", "failure", now=0.0)]
    out += [brain.degradation_penalty("j0", now=t) for t in (600.0, 1200.0)]
    for kind, t in (("oom", 600.0), ("straggler", 900.0), ("hot_ps", 950.0),
                    ("unknown", 1000.0)):
        out.append(brain.report_degradation("j0", kind, now=t))
    out.append(brain.degradation_penalty("j1", now=5.0))
    job = _job(P, "j0")
    plans = brain.adjust([job, _job(P, "j1")], now=1200.0)
    return out, job.degradation, plans, P.b.DEGRADATION_WEIGHTS


def test_degradation_as_in_the_reference():
    vals = both(_degradation)[0]
    assert vals[1] == pytest.approx(vals[0] / 2)


def _complete_clears(P):
    brain = P.b.ClusterBrain(P.a.ClusterCapacity(2048.0, 16384.0))
    brain.adjust([_job(P, "gone")])
    brain.report_degradation("gone", "failure", now=0.0)
    brain.complete("gone", throughput=0.0)
    return (dict(brain._optimized_at), dict(brain._cached),
            dict(brain._last_plan_round), brain.degradation_penalty("gone"))


def test_complete_clears_all_ledgers_as_in_the_reference():
    assert both(_complete_clears) == [{}, {}, {}, 0.0]


# -------------------------------------- the three-stage lifecycle (serve)
def _master(P, jid="j0"):
    stat = _stat(P)
    return P.b.JobMaster(
        job_id=jid, meta=P.ws.JobMeta("dcn", 1e6, 1e7, 16, 512, 1e7),
        statics=stat, resources=P.pm.JobResources(w=2, p=1, cpu_w=4, cpu_p=4),
        total_samples=1e6, sharding=P.ss.ShardingService(1000, 100),
        profiler=P.b.Profiler(statics=stat))


def _three_stage(P):
    brain = P.b.ClusterBrain(P.a.ClusterCapacity(2048, 16384))
    m = _master(P)
    applied = []
    m.apply_plan = applied.append
    plan = brain.admit(m)
    rng = np.random.default_rng(0)
    for i in range(12):
        r = dataclasses.replace(m.resources, w=1 + i % 6, p=1 + i % 3)
        t = P.pm.synthesize_t_iter(r, m.statics, ALPHA, BETA, noise=0.02,
                                   rng=rng)
        m.profiler.record_iteration(r, t)
    plans = brain.optimize()
    fitted = (m.model.alpha, m.model.beta_sum)
    for i in range(8):
        m.profiler.record_memory(i * 1e5, 4e9 + i * 2e9)
    scaled = brain.check_oom(now=30.0)
    penalty = brain.degradation_penalty("j0", now=30.0)
    resources = m.resources
    brain.complete("j0", throughput=1000.0)
    m2 = _master(P, "j1")
    plan2 = brain.admit(m2)
    return (plan, plans, fitted, scaled, penalty, resources, applied,
            brain.config_db.records, brain.kind_models, plan2)


def test_brain_three_stage_lifecycle_as_in_the_reference():
    out = both(_three_stage)
    scaled, resources, records = out[3], out[5], out[7]
    assert scaled and resources["mem_p"] >= 16.0
    assert len(records) == 1


# ---------------------------------------------------- the lifecycle example
SMALL = DLRMConfig(name="wide_deep_small", kind="wide_deep",
                   table_rows=tuple(200 * (1 + i % 5) for i in range(26)),
                   embed_dim=16, mlp_dims=(32, 16), batch_size=32)
SMALL_STEPS = 151


def _reference_control_plane(cfg, steps, throughput=None):
    """The reference example's loop (``examples/elastic_dlrm_train.py``)
    with the reference's brain, sharding service and loader, and no
    training: every brain and sharding call it makes, in its order."""
    brain = jbr.ClusterBrain(jas.ClusterCapacity(2048, 16384))
    statics = jpm.JobStatics(batch_size=cfg.batch_size,
                             model_size=cfg.param_count() * 4.0,
                             bandwidth=1e9, emb_dim=cfg.embed_dim)
    total = steps * cfg.batch_size
    meta = jws.JobMeta(cfg.kind, dense_params=1e6,
                       emb_rows=cfg.total_embedding_rows,
                       emb_dim=cfg.embed_dim, batch_size=cfg.batch_size,
                       dataset_samples=total)
    master = jbr.JobMaster(
        job_id="dlrm-100m", meta=meta, statics=statics,
        resources=jpm.JobResources(w=2, p=1, cpu_w=4, cpu_p=4),
        total_samples=total,
        sharding=jss.ShardingService(total, shard_size=cfg.batch_size * 8,
                                     min_shard=cfg.batch_size),
        profiler=jbr.Profiler(statics=statics))
    stage1 = brain.admit(master)
    svc, clock = master.sharding, [0.0]

    def tick():
        clock[0] += 1.0
        return clock[0]

    loader = jpipe.ShardDataLoader(svc, "workerA", lambda idx: idx,
                                   cfg.batch_size, clock=tick)
    n, stage2, stage3 = 0, {}, {}
    while loader.next_batch() is not None:
        n += 1
        master.profiler.record_iteration(
            master.resources,
            float(np.random.default_rng(n).lognormal(-2, .05)))
        master.samples_done = n * cfg.batch_size
        master.profiler.record_memory(master.samples_done,
                                      4e9 + master.samples_done * 1e3)
        if n == 60:
            svc.report_failure("workerA", tick())
            loader = jpipe.ShardDataLoader(svc, "workerB", lambda idx: idx,
                                           cfg.batch_size, clock=tick)
        if n == 120:
            svc._view("workerB", tick()).is_straggler = True
        if n == 150:
            stage2 = brain.optimize()
            stage3 = brain.check_oom()
    resources = master.resources
    if throughput is not None:
        brain.complete("dlrm-100m", throughput=throughput)
    return {"steps": n, "coverage": list(svc.coverage(0)),
            "stage1": plain(stage1), "stage2": plain(stage2),
            "stage3": plain(stage3), "resources": plain(resources),
            "observations": plain(master.profiler.observations),
            "oom": [master.profiler.oom._samples, master.profiler.oom._mem],
            "records": plain(brain.config_db.records),
            "kind_models": plain(brain.kind_models)}


@pytest.fixture(scope="module")
def example():
    return _load("elastic_dlrm_train_torch",
                 ROOT / "examples" / "elastic_dlrm_train_torch.py")


def test_lifecycle_decides_as_the_reference(example, tmp_path):
    """The small job trained on the CPU: losses finite and falling, AUC in
    (0.5, 1], and every brain decision, the profiler's record and the
    exactly-once coverage as the reference's control plane gives them."""
    lines = []
    lc = example.run_lifecycle(SMALL, steps=SMALL_STEPS, device="cpu",
                               ckpt_dir=str(tmp_path), log=lines.append)
    want = _reference_control_plane(SMALL, SMALL_STEPS,
                                     throughput=lc.throughput)
    m = lc.master
    got = {"steps": len(lc.losses), "coverage": list(lc.coverage),
           "stage1": plain(lc.stage1_plan), "stage2": plain(lc.stage2_plans),
           "stage3": plain(lc.stage3_scaled), "resources": plain(m.resources),
           "observations": plain(m.profiler.observations),
           "oom": [m.profiler.oom._samples, m.profiler.oom._mem],
           "records": plain(lc.brain.config_db.records),
           "kind_models": plain(lc.brain.kind_models)}
    assert got == want
    assert got["coverage"][0] is True and got["coverage"][2] == 0
    assert "dlrm-100m" in got["stage2"] and len(got["records"]) == 1
    assert all(np.isfinite(lc.losses))
    assert np.mean(lc.losses[-10:]) < lc.losses[0]
    assert 0.5 < lc.auc <= 1.0
    assert len(lc.step_seconds) == len(lc.losses)
    assert lc.peak_mem_bytes is None
    assert any(line.startswith("stage-2 auto-scale plan: ") for line in lines)
    assert lines[-1] == "job recorded to config DB for future warm starts"


def test_lifecycle_refuses_cuda_without_a_card(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        example.main(["--steps", "1"])


def test_lifecycle_config_is_the_reference_example(example):
    ref = _load("elastic_dlrm_train_ref",
                ROOT / "examples" / "elastic_dlrm_train.py")
    rc, tc = ref.build_cfg(), example.build_cfg()
    assert dataclasses.asdict(rc) == dataclasses.asdict(tc)
    assert tc.param_count() == rc.param_count()
    assert tc.total_embedding_rows == 18_240_000


def test_chip_smoke_expects_what_the_reference_gives(example):
    """chip_smoke phase 14 holds the card's full-config run to constants:
    they are what the reference's control plane gives for that run."""
    smoke = _load("chip_smoke_consts", ROOT / "chip_smoke.py")
    want = _reference_control_plane(example.build_cfg(),
                                    smoke.LIFECYCLE_STEPS)
    assert smoke.LIFECYCLE_WANT == {
        k: want[k] for k in ("steps", "coverage", "stage1", "stage2",
                             "stage3")}
