"""Port parity: the self-healing supervisor over the real DLRM train loop.

The counterparts of ``tests/test_supervisor_internals.py`` (the EWMA
straggler detector, backoff and restart budget, the OOM degradation
ladder) and of ``tests/test_supervisor_chaos.py`` (every fault scenario,
the event log, kill anywhere / resume anywhere) run against
``repro_torch.train.supervisor`` on the CPU. Within the port recovery is
BIT-EXACT: batches are a pure function of the global step, so after any
detect -> restore -> replay cycle the loss trajectory EQUALS the no-fault
run's (``==`` on float losses).

Against the reference: both packages start from the same step-0 blob (the
reference's fresh init, which the port restores: the two share the
checkpoint schema), run the same chaos plan, and must give the same
sequence of event kinds, steps and actions (exact), with losses within
LOSS_ATOL (the two packages' f32 forwards differ by a few ULP).

``test_supervisor_chaos.py::test_report_feeds_sim_timings`` has its
counterpart here: the report's measured timings feed the port's
``repro_torch.sim.cluster.CloudSim``.
"""
import dataclasses
import functools
import json
import shutil
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401  (sets torch threads)
from repro.configs import dlrm_models as jcfg  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import flash_checkpoint as jfc  # noqa: E402
from repro.train import supervisor as jsup  # noqa: E402
from repro_torch.configs.dlrm_models import reduced_dlrm  # noqa: E402
from repro_torch.configs.registry import get_dlrm  # noqa: E402
from repro_torch.core.faults import (FaultInjector, PSShardLoss,  # noqa: E402
                                     TransientOOM, parse_chaos_spec)
from repro_torch.core.flash_checkpoint import FlashCheckpoint  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.train.supervisor import (  # noqa: E402
    DLRMJob, RestartBudgetExceeded, Supervisor, SupervisorConfig,
)

CFG = reduced_dlrm(get_dlrm("wide_deep"))
JCFG = jcfg.reduced_dlrm(jcfg.WIDE_DEEP)
T = 16                                          # steps per supervised run
LOSS_ATOL = 2e-5


# =========================================================== internals
class StubJob:
    """Duck-typed DLRMJob stand-in: restore/degrade without torch or state."""

    def __init__(self):
        self.injector = None
        self.global_step = 0
        self.restore_calls = 0

    def restore(self, *, onto_n_ps=None):
        self.restore_calls += 1
        return self.global_step

    def degrade(self):
        return "stub_degrade"


def make_sup(**cfg):
    return Supervisor(StubJob(), SupervisorConfig(**cfg))


def test_ewma_warmup_suppresses_straggler_detection():
    sup = make_sup(ewma_warmup_steps=5, straggler_factor=3.0)
    for i, dt in enumerate([0.01, 1.0, 0.01, 0.01, 0.01]):
        sup._observe_step_time(i, dt)
    assert not [e for e in sup.events if e.kind == "straggler_detected"]


def test_ewma_detects_after_warmup_and_clips_the_fold():
    sup = make_sup(ewma_warmup_steps=3, straggler_factor=3.0,
                   ewma_alpha=0.25)
    for i in range(4):
        sup._observe_step_time(i, 0.01)
    baseline = sup._ewma
    assert baseline == pytest.approx(0.01)
    sup._observe_step_time(4, 1.0)          # 100x the EWMA: flagged
    ev = [e for e in sup.events if e.kind == "straggler_detected"]
    assert len(ev) == 1 and ev[0].step == 4
    assert ev[0].detail["factor"] == pytest.approx(100.0, rel=0.05)
    assert sup._ewma <= baseline * (1 + 0.25 * (3.0 - 1)) * 1.001
    sup._observe_step_time(5, 1.0)
    assert len([e for e in sup.events
                if e.kind == "straggler_detected"]) == 2


def test_first_sample_seeds_the_ewma():
    sup = make_sup(ewma_warmup_steps=5)
    sup._observe_step_time(0, 0.5)
    assert sup._ewma == pytest.approx(0.5)


def test_backoff_grows_exponentially_to_the_cap():
    sup = make_sup(backoff_base_s=0.01, backoff_cap_s=0.04,
                   backoff_jitter=0.0)
    delays = []
    for failures in (1, 2, 3, 4, 5):
        sup._consecutive_failures = failures
        delays.append(sup._backoff())
    assert delays == pytest.approx([0.01, 0.02, 0.04, 0.04, 0.04])


def test_backoff_jitter_is_bounded_and_deterministic():
    a = make_sup(backoff_base_s=0.01, backoff_jitter=0.25, seed=7)
    b = make_sup(backoff_base_s=0.01, backoff_jitter=0.25, seed=7)
    a._consecutive_failures = b._consecutive_failures = 1
    da, db = a._backoff(), b._backoff()
    assert da == db
    assert 0.0075 <= da <= 0.0125


def test_restart_budget_exhaustion_raises_with_event():
    sup = make_sup(max_restarts=3, backoff_base_s=0.0, backoff_jitter=0.0)
    for _ in range(3):
        sup._recover("ps_loss", 10)
    assert sup.job.restore_calls == 3
    with pytest.raises(RestartBudgetExceeded, match="budget of 3"):
        sup._recover("ps_loss", 10)
    ev = [e for e in sup.events if e.kind == "restart_budget_exceeded"]
    assert len(ev) == 1
    assert ev[0].detail["budget"] == 3
    assert sup.job.restore_calls == 3


def test_recover_resets_nothing_but_counts_consecutive_failures():
    sup = make_sup(max_restarts=5, backoff_base_s=0.0, backoff_jitter=0.0)
    sup._recover("hang", 4)
    sup._recover("hang", 5)
    assert sup.restarts == 2
    assert sup._consecutive_failures == 2
    recovered = [e for e in sup.events if e.kind == "recovered"]
    assert [e.detail["action"] for e in recovered] == ["restore", "restore"]


def test_degrade_ladder_ordering_no_processes(tmp_path):
    """First OOM drops the hot-row cache; repeats halve the batch down to
    the floor of 8, in that order, rebuilding the step each time."""
    cfg = dataclasses.replace(CFG, hot_rows_k=64)
    assert cfg.batch_size >= 32
    job = DLRMJob(cfg, FlashCheckpoint(str(tmp_path), async_persist=False),
                  device="cpu")
    b0 = job.cfg.batch_size
    actions = [job.degrade() for _ in range(4)]
    assert actions[0] == "drop_hot_cache"
    assert job.cfg.hot_rows_k == 0
    expect = []
    b = b0
    for _ in range(3):
        b = max(b // 2, 8)
        expect.append(f"shrink_batch_to_{b}")
    assert actions[1:] == expect
    assert job.cfg.batch_size == b
    assert job.degrade_level == 4
    assert job.global_step == 0


def test_degrade_floor_never_goes_below_8(tmp_path):
    job = DLRMJob(CFG, FlashCheckpoint(str(tmp_path), async_persist=False),
                  device="cpu")
    for _ in range(10):
        job.degrade()
    assert job.cfg.batch_size == 8


def test_backoff_draws_as_in_the_reference():
    """The same seed gives the same jittered delays in both packages."""
    t = make_sup(backoff_base_s=0.01, backoff_jitter=0.25, seed=3)
    j = jsup.Supervisor(StubJob(), jsup.SupervisorConfig(
        backoff_base_s=0.01, backoff_jitter=0.25, seed=3))
    for failures in (1, 2, 3, 4, 5, 6, 7):
        t._consecutive_failures = j._consecutive_failures = failures
        assert t._backoff() == j._backoff()


# =========================================================== chaos scenarios
def _supervised(chaos, *, padded=True, deadline=None, max_restarts=5,
                hot_rows_k=0, total_steps=T, seed_dir=None):
    """One supervised port run in a fresh checkpoint directory (a copy of
    ``seed_dir`` when given: the run then resumes from its blob)."""
    cfg = dataclasses.replace(CFG, hot_rows_k=hot_rows_k)
    inj = FaultInjector(parse_chaos_spec(chaos), seed=0)
    with tempfile.TemporaryDirectory() as d:
        if seed_dir is not None:
            shutil.copytree(seed_dir, d, dirs_exist_ok=True)
        ckpt = FlashCheckpoint(d, keep=3, async_persist=False,
                               fault_hook=inj.on_persist)
        inj.bind_checkpoint(ckpt)
        job = DLRMJob(cfg, ckpt, ckpt_every=4, n_ps=4, padded=padded,
                      injector=inj, device="cpu")
        sup = Supervisor(job, SupervisorConfig(
            step_deadline_s=deadline, max_restarts=max_restarts,
            backoff_base_s=0.01, backoff_cap_s=0.05))
        report = sup.run(total_steps)
    return job, sup, report


@functools.lru_cache(maxsize=None)
def _baseline_losses():
    """Loss trajectory of the clean port run (flat == padded, below)."""
    job, _, _ = _supervised("")
    return dict(job.losses)


def _assert_bit_exact(job):
    base = _baseline_losses()
    assert sorted(job.losses) == sorted(base)
    for step, loss in sorted(job.losses.items()):
        assert loss == base[step], (
            f"step {step}: recovered {loss!r} != clean {base[step]!r}")


def test_clean_flat_equals_clean_padded():
    job, _, rep = _supervised("", padded=False)
    assert rep.restarts == 0 and rep.goodput_fraction == 1.0
    _assert_bit_exact(job)


def test_ps_loss_elastic_shrink_bit_exact():
    job, _, rep = _supervised("ps_loss@6")
    assert rep.completed and rep.final_step == T
    assert job.n_ps == 3 and job.layout.n_ps == 3
    assert any(e.kind == "fault_detected" and e.detail["fault"] == "ps_loss"
               for e in rep.events)
    assert any(e.kind == "recovered" and
               e.detail["action"] == "elastic_shrink" and
               e.detail["surviving_n_ps"] == 3 for e in rep.events)
    _assert_bit_exact(job)


def test_double_ps_loss_shrinks_twice():
    job, _, rep = _supervised("ps_loss@5,ps_loss@10")
    assert job.n_ps == 2 and rep.restarts == 2
    _assert_bit_exact(job)


def test_hang_watchdog_detection_bit_exact():
    job, _, rep = _supervised("hang@9", deadline=1.0)   # default stall: 30 s
    assert rep.completed and rep.final_step == T
    det = [e for e in rep.events if e.kind == "fault_detected"]
    assert det and det[0].detail["fault"] == "hang"
    rec = [e for e in rep.events if e.kind == "recovered"]
    assert rec and rec[0].detail["cause"] == "hang"
    assert rec[0].detail["recovery_latency_s"] > 0
    _assert_bit_exact(job)


def test_corrupt_latest_ckpt_falls_back_and_recovers():
    # corrupt the step-8 blob (dropping the memory tier), then crash at 10:
    # recovery falls back past the damaged blob to step 4 and replays
    job, _, rep = _supervised("ckpt_corrupt@8,ps_loss@10")
    assert rep.completed
    assert any(e["kind"] == "corrupt_blob_fallback" for e in job.ckpt.events)
    rec = [e for e in rep.events if e.kind == "recovered"]
    assert rec[0].step == 4 and rec[0].detail["steps_lost"] == 6
    _assert_bit_exact(job)


def test_truncated_ckpt_falls_back_and_recovers():
    job, _, rep = _supervised("ckpt_truncate@8,ps_loss@10")
    assert rep.completed
    assert any(e["kind"] == "corrupt_blob_fallback" for e in job.ckpt.events)
    _assert_bit_exact(job)


def test_straggler_delay_detected_not_restarted():
    """A 0.5 s delay against a step of a few ms is flagged at its step and
    never restored (slow is not dead). A host hiccup may flag another step
    too, so the detection is asserted at step 10, not as the only one."""
    job, _, rep = _supervised("straggler@10:0.5")
    assert rep.restarts == 0 and rep.completed
    stragglers = [e for e in rep.events if e.kind == "straggler_detected"]
    assert 10 in [e.step for e in stragglers]
    _assert_bit_exact(job)


def test_oom_walks_degradation_ladder():
    job, _, rep = _supervised("oom@5,oom@9", hot_rows_k=24)
    actions = [e.detail.get("action") for e in rep.events
               if e.kind == "recovered"]
    assert actions == ["drop_hot_cache",
                       f"shrink_batch_to_{CFG.batch_size // 2}"]
    assert rep.completed and rep.steps_lost == 0
    assert job.cfg.hot_rows_k == 0
    assert job.cfg.batch_size == CFG.batch_size // 2
    # the cache is numerically inert: up to the batch shrink at step 9 the
    # trajectory is the clean one
    base = _baseline_losses()
    assert [job.losses[s] for s in range(9)] == [base[s] for s in range(9)]


def test_restart_budget_exceeded_raises():
    with pytest.raises(RestartBudgetExceeded):
        _supervised("ps_loss@2,ps_loss@4,ps_loss@6", max_restarts=2)


def test_event_log_is_structured_jsonl(tmp_path):
    _, sup, rep = _supervised("ps_loss@6")
    path = tmp_path / "events.jsonl"
    sup.write_event_log(str(path), rep)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines[-1]["kind"] == "summary"
    assert lines[-1]["completed"] is True
    assert lines[-1]["restarts"] == 1
    assert 0 < lines[-1]["goodput_fraction"] <= 1
    assert lines[-1]["recovery_latency_mean_s"] > 0
    body = lines[:-1]
    assert {e["kind"] for e in body} >= {"fault_detected", "recovered"}
    assert all({"t", "kind", "step", "detail"} <= set(e) for e in body)
    assert rep.measured_timings().flash_ckpt_load_s > 0


def test_report_feeds_sim_timings():
    from repro_torch.core.migration import MigrationTimings
    from repro_torch.sim.cluster import CloudSim
    _, _, rep = _supervised("ps_loss@6")
    timings = rep.measured_timings()
    assert isinstance(timings, MigrationTimings)
    assert timings.flash_ckpt_load_s > 0
    sim = CloudSim("dlrover_rm", timings=timings, failure_seed=7)
    assert sim.timings is timings and sim.failure_seed == 7


@pytest.mark.parametrize("kill_at,padded,n_ps2", [
    (2, True, 1), (5, False, 3), (7, True, 4), (11, True, 2)])
def test_kill_anywhere_resume_anywhere_bit_exact(tmp_path, kill_at, padded,
                                                 n_ps2):
    """Kill at an arbitrary step; a fresh job over the same persist dir
    resumes (flat or padded, onto any surviving PS count) and reproduces
    the uninterrupted loss trajectory exactly."""
    base = _baseline_losses()
    d = str(tmp_path)
    ck1 = FlashCheckpoint(d, keep=3, async_persist=False)
    job1 = DLRMJob(CFG, ck1, ckpt_every=3, n_ps=3, padded=padded,
                   device="cpu")
    job1.start(resume=False)
    for _ in range(kill_at):
        job1.run_step()
    del job1, ck1                               # the process dies here
    ck2 = FlashCheckpoint(d, keep=3, async_persist=False)
    job2 = DLRMJob(CFG, ck2, ckpt_every=3, n_ps=3, padded=padded,
                   device="cpu")
    step0 = job2.restore(onto_n_ps=n_ps2 if padded else None)
    assert step0 == (kill_at // 3) * 3
    if padded:
        assert job2.layout.n_ps == n_ps2
    while job2.global_step < T:
        job2.run_step()
    for step, loss in sorted(job2.losses.items()):
        assert loss == base[step]


# =========================================== torch specifics of the port
def test_faults_fire_before_the_in_place_update(tmp_path):
    """A fault raised by the step's ``before`` hook leaves the pools as
    they were: the fused step updates them in place, after the hook."""
    cfg = dataclasses.replace(CFG, hot_rows_k=24)
    inj = FaultInjector(parse_chaos_spec("ps_loss@1,oom@1"))
    job = DLRMJob(cfg, FlashCheckpoint(str(tmp_path), async_persist=False),
                  sparse_update=True, padded=True, injector=inj,
                  device="cpu")
    job.start(resume=False)
    job.run_step()
    before = {k: v.clone() for k, v in job.state["params"].items()}
    acc = {k: v.clone() for k, v in job.state["opt"]["acc"].items()}
    for err in (PSShardLoss, TransientOOM):
        with pytest.raises(err):
            job.run_step()
        assert job.global_step == 1
        for k, v in job.state["params"].items():
            assert torch.equal(v, before[k]), k
        for k, v in job.state["opt"]["acc"].items():
            assert torch.equal(v, acc[k]), k


def test_warm_up_and_restore_leave_the_live_state_alone(tmp_path):
    """Building the step warms it up on a copy (the live pools do not
    move), and a restore puts new tensors into the job, never the live
    pools an abandoned attempt may have written."""
    job = DLRMJob(CFG, FlashCheckpoint(str(tmp_path), async_persist=False),
                  sparse_update=True, padded=True, ckpt_every=2,
                  device="cpu")
    job.start(resume=False)
    job.run_step()
    job.run_step()                              # blob at step 2
    pools = {k: job.state["params"][k] for k in ("tables", "wide")}
    snap = {k: v.clone() for k, v in pools.items()}
    job.degrade()                               # rebuild + warm-up
    for k in pools:
        assert torch.equal(pools[k], snap[k])
    job.run_step()                              # moves the pools in place
    job.restore()
    for k in pools:
        restored = job.state["params"][k]
        assert restored.data_ptr() != pools[k].data_ptr()
        assert torch.equal(restored, snap[k])


def test_with_step_hooks_order():
    calls = []

    def step(state, batch):
        calls.append("step")
        return state + 1, {"loss": 0.0}

    fn = trainer.with_step_hooks(
        step, before=lambda s, b: calls.append(("before", s, b)),
        after=lambda s, m: calls.append(("after", s)))
    assert fn(1, "b")[0] == 2
    assert calls == [("before", 1, "b"), "step", ("after", 2)]


def test_job_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        DLRMJob(CFG, FlashCheckpoint(str(tmp_path)))


# ============================================== against the reference
def _seed_dir(root, hot_rows_k=0):
    """The reference's fresh init, as the stamped step-0 blob both
    packages resume from."""
    d = str(root / "seed")
    cfg = dataclasses.replace(JCFG, hot_rows_k=hot_rows_k)
    job = jsup.DLRMJob(cfg, jfc.FlashCheckpoint(d, async_persist=False),
                       ckpt_every=4, n_ps=4, padded=True)
    job.start(resume=False)
    return d


def _reference_run(chaos, seed_dir, *, hot_rows_k=0):
    cfg = dataclasses.replace(JCFG, hot_rows_k=hot_rows_k)
    inj = jfaults.FaultInjector(jfaults.parse_chaos_spec(chaos), seed=0)
    with tempfile.TemporaryDirectory() as d:
        shutil.copytree(seed_dir, d, dirs_exist_ok=True)
        ckpt = jfc.FlashCheckpoint(d, keep=3, async_persist=False,
                                   fault_hook=inj.on_persist)
        inj.bind_checkpoint(ckpt)
        job = jsup.DLRMJob(cfg, ckpt, ckpt_every=4, n_ps=4, padded=True,
                           injector=inj)
        sup = jsup.Supervisor(job, jsup.SupervisorConfig(
            backoff_base_s=0.01, backoff_cap_s=0.05))
        report = sup.run(T)
    return job, report


def _events(report):
    """Event kinds, steps and actions; times and straggler flags (host
    timing) left out."""
    keep = ("fault", "n_lost", "cause", "action", "surviving_n_ps",
            "steps_lost")
    return [(e.kind, e.step, {k: e.detail[k] for k in keep
                              if k in e.detail})
            for e in report.events if e.kind != "straggler_detected"]


@pytest.mark.parametrize("chaos,hot_rows_k", [
    ("", 0),
    ("ps_loss@5,ckpt_corrupt@8,ps_loss@10,oom@12", 24),
])
def test_chaos_run_matches_the_reference(tmp_path, chaos, hot_rows_k):
    seed = _seed_dir(tmp_path, hot_rows_k)
    jjob, jrep = _reference_run(chaos, seed, hot_rows_k=hot_rows_k)
    tjob, _, trep = _supervised(chaos, hot_rows_k=hot_rows_k, seed_dir=seed)
    assert _events(trep) == _events(jrep)
    assert (trep.restarts, trep.steps_lost, trep.step_attempts,
            trep.productive_steps, trep.final_step) == \
        (jrep.restarts, jrep.steps_lost, jrep.step_attempts,
         jrep.productive_steps, jrep.final_step)
    assert [e["kind"] for e in tjob.ckpt.events] == \
        [e["kind"] for e in jjob.ckpt.events]
    assert sorted(tjob.losses) == sorted(jjob.losses) == list(range(T))
    np.testing.assert_allclose([tjob.losses[s] for s in range(T)],
                               [jjob.losses[s] for s in range(T)],
                               rtol=0, atol=LOSS_ATOL)
    assert (tjob.n_ps, tjob.cfg.hot_rows_k) == (jjob.n_ps, jjob.cfg.hot_rows_k)
    if chaos:
        # within the port the recovered trajectory IS the clean one
        clean, _, _ = _supervised("", hot_rows_k=hot_rows_k, seed_dir=seed)
        assert tjob.losses == clean.losses
