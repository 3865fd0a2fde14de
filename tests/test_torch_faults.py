"""Port parity: deterministic fault injection (``repro_torch.core.faults``).

The counterparts of ``tests/test_faults.py`` run against the port, and the
two packages are held to each other exactly: a spec string parses into the
same plan, ``random_plan`` draws the same plan for a seed, ``corrupt_blob``
leaves byte-identical files for the same seed, ``ProcessFaultInjector.fires``
agrees over a grid of specs x steps x incarnations, and the in-process
injector fires the same faults at the same steps.
"""
import os
import signal
import tempfile
import threading
import time

import pytest

from repro.core import faults as jfaults
from repro_torch.core.faults import (
    AttemptAbandoned, FaultInjector, FaultPlan, FaultSpec, ProcessFaultInjector,
    PSShardLoss, TransientOOM, corrupt_blob, parse_chaos_spec, random_plan,
)
from repro_torch.core import faults as tfaults


# ---------------------------------------------------------------- spec grammar
def test_parse_round_trip():
    spec = "ps_loss@10,hang@20:0.5,straggler@30x5:0.07"
    plan = parse_chaos_spec(spec)
    assert str(plan) == spec
    assert parse_chaos_spec(str(plan)) == plan


def test_parse_defaults_and_windows():
    plan = parse_chaos_spec("straggler@30x5")
    (s,) = plan.specs
    assert s.param == 0.05                      # kind default filled in
    assert plan.at_step(29) == []
    assert plan.at_step(30) == [s]
    assert plan.at_step(34) == [s]
    assert plan.at_step(35) == []


def test_parse_empty_and_errors():
    assert parse_chaos_spec("") == FaultPlan()
    assert parse_chaos_spec("  ") == FaultPlan()
    with pytest.raises(ValueError, match="kind@step"):
        parse_chaos_spec("ps_loss")
    with pytest.raises(ValueError, match="unknown fault kind"):
        parse_chaos_spec("explode@5")
    with pytest.raises(ValueError, match="bad fault window"):
        FaultSpec("hang", step=-1)
    with pytest.raises(ValueError, match="bad fault window"):
        FaultSpec("hang", step=0, count=0)


def test_random_plan_deterministic():
    a, b = random_plan(4, 100, seed=7), random_plan(4, 100, seed=7)
    assert a == b
    assert random_plan(4, 100, seed=8) != a
    assert all(1 <= s.step < 100 for s in a.specs)


# ------------------------------------------------------------ firing semantics
def test_crash_faults_fire_once():
    inj = FaultInjector(parse_chaos_spec("ps_loss@3:2,oom@5"))
    inj.before_step(2)                          # nothing scheduled
    with pytest.raises(PSShardLoss) as e:
        inj.before_step(3)
    assert e.value.n_lost == 2
    inj.before_step(3)                          # spent: replay doesn't re-fire
    with pytest.raises(TransientOOM):
        inj.before_step(5)
    inj.before_step(5)
    assert [k for _, k in inj.fired] == ["ps_loss", "oom"]


def test_hang_is_cancellable():
    inj = FaultInjector(parse_chaos_spec("hang@1:30"))
    cancel = threading.Event()
    t = threading.Timer(0.05, cancel.set)
    t.start()
    t0 = time.monotonic()
    with pytest.raises(AttemptAbandoned):
        inj.before_step(1, cancel)
    assert time.monotonic() - t0 < 5.0          # unwound, not a 30 s stall
    t.join(timeout=5)
    assert not t.is_alive()


def test_short_hang_completes():
    inj = FaultInjector(parse_chaos_spec("hang@1:0.05"))
    t0 = time.monotonic()
    inj.before_step(1)                          # no cancel: sleeps it out
    assert time.monotonic() - t0 >= 0.04


def test_straggler_delays_batch():
    inj = FaultInjector(parse_chaos_spec("straggler@2x2:0.05"))
    t0 = time.monotonic()
    inj.on_batch(1)
    assert time.monotonic() - t0 < 0.04
    t0 = time.monotonic()
    inj.on_batch(2)
    assert time.monotonic() - t0 >= 0.04
    t0 = time.monotonic()
    inj.on_batch(2)                             # spent for this step
    assert time.monotonic() - t0 < 0.04
    t0 = time.monotonic()
    inj.on_batch(3)                             # window covers step 3 too
    assert time.monotonic() - t0 >= 0.04


def test_injection_log_records_what_fired():
    inj = FaultInjector(parse_chaos_spec("oom@1"))
    with pytest.raises(TransientOOM):
        inj.before_step(1)
    (entry,) = inj.log
    assert entry["kind"] == "fault_injected"
    assert entry["fault"] == "oom" and entry["step"] == 1


# --------------------------------------------------------------- blob sabotage
def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)
    return path


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_corrupt_blob_flip_deterministic():
    data = bytes(range(256)) * 16
    with tempfile.TemporaryDirectory() as d:
        a = _write(os.path.join(d, "a"), data)
        b = _write(os.path.join(d, "b"), data)
        corrupt_blob(a, seed=3)
        corrupt_blob(b, seed=3)
        assert _read(a) == _read(b)
        assert _read(a) != data


def test_corrupt_blob_truncate():
    with tempfile.TemporaryDirectory() as d:
        p = _write(os.path.join(d, "blob.bin"), b"x" * 1000)
        msg = corrupt_blob(p, mode="truncate")
        assert os.path.getsize(p) == 500 and "truncated" in msg


# ----------------------------------------------------------- data-pipeline hook
def test_shard_loader_fault_hook_sees_batch_indices():
    from repro_torch.core.sharding_service import ShardingService
    from repro_torch.data.pipeline import ShardDataLoader

    seen = []
    svc = ShardingService(64, shard_size=32)
    loader = ShardDataLoader(svc, "w0", lambda idx: {"idx": idx},
                             batch_size=16, fault_hook=seen.append)
    batches = list(loader)
    assert len(batches) == 4
    assert seen == [0, 1, 2, 3]                 # hook fired before every batch


# ------------------------------------------------------------ process faults
def test_process_injector_signals_and_logs(tmp_path):
    """``kill``/``stop`` fire before their step in incarnation 0 only;
    ``kill_ckpt`` fires in the pre-commit window of the first persist at or
    after its step; each leaves a durable log line before the signal."""
    log = str(tmp_path / "faults.jsonl")
    plan = parse_chaos_spec("kill@3,stop@5,kill_ckpt@4")
    sent = []
    inj = ProcessFaultInjector(plan, incarnation=0, signal_fn=sent.append,
                               log_path=log)
    for step in range(7):
        inj.before_step(step)
    inj.on_pre_commit(str(tmp_path / "staging"), 3)
    inj.on_pre_commit(str(tmp_path / "staging"), 6)
    assert sent == [signal.SIGKILL, signal.SIGSTOP, signal.SIGKILL]
    import json
    fired = [json.loads(ln) for ln in open(log)]
    assert [(r["fault"], r["step"]) for r in fired] == [
        ("kill", 3), ("stop", 5), ("kill_ckpt", 6)]
    again = []
    ProcessFaultInjector(plan, incarnation=1,
                         signal_fn=again.append).before_step(3)
    assert again == []                          # the re-exec replays step 3


# ------------------------------------------------------ against the reference
SPECS = ["", "ps_loss@10", "ps_loss@10,hang@20:0.5,straggler@30x5:0.07",
         "oom@5,oom@9", "ckpt_corrupt@8,ps_loss@10", "ckpt_truncate@3",
         "straggler@2x3", "kill@4", "stop@7:2", "kill_ckpt@3",
         "kill_loop@4x2,stop@9", "hang@13,ps_loss@8,ckpt_corrupt@17"]


def _fields(plan):
    return [(s.kind, s.step, s.count, s.param) for s in plan.specs]


@pytest.mark.parametrize("spec", SPECS)
def test_plans_parse_as_in_the_reference(spec):
    t, j = tfaults.parse_chaos_spec(spec), jfaults.parse_chaos_spec(spec)
    assert _fields(t) == _fields(j)
    assert str(t) == str(j)
    for step in range(0, 40):
        assert _fields(FaultPlan(tuple(t.at_step(step)))) == \
            _fields(jfaults.FaultPlan(tuple(j.at_step(step))))


@pytest.mark.parametrize("seed", [0, 7, 8, 123])
def test_random_plans_as_in_the_reference(seed):
    t = tfaults.random_plan(5, 60, seed=seed)
    j = jfaults.random_plan(5, 60, seed=seed)
    assert _fields(t) == _fields(j)
    kinds = ("ps_loss", "oom", "kill")
    assert _fields(tfaults.random_plan(3, 20, seed=seed, kinds=kinds)) == \
        _fields(jfaults.random_plan(3, 20, seed=seed, kinds=kinds))


@pytest.mark.parametrize("mode", ["flip", "truncate"])
@pytest.mark.parametrize("layout", ["file", "dir", "dir-manifest-only"])
def test_corrupt_blob_bytes_as_in_the_reference(tmp_path, mode, layout):
    """The same seed damages the same bytes in both packages, on a legacy
    file, a checkpoint dir's data file, and a dir without one."""
    data = bytes(range(251)) * 37

    def make(root):
        os.makedirs(root)
        if layout == "file":
            return _write(os.path.join(root, "blob.bin"), data), "blob.bin"
        name = "MANIFEST.json" if layout == "dir-manifest-only" \
            else "leaves.npz"
        _write(os.path.join(root, name), data)
        return root, name

    for seed in (0, 5):
        tp, name = make(str(tmp_path / f"t{seed}"))
        jp, _ = make(str(tmp_path / f"j{seed}"))
        tfaults.corrupt_blob(tp, mode=mode, seed=seed)
        jfaults.corrupt_blob(jp, mode=mode, seed=seed)
        tfile = tp if layout == "file" else os.path.join(tp, name)
        jfile = jp if layout == "file" else os.path.join(jp, name)
        assert _read(tfile) == _read(jfile)
        assert _read(tfile) != data


def test_process_fires_as_in_the_reference():
    """The gating predicate over a grid of specs x steps x incarnations."""
    specs = [("kill", 5, 1), ("stop", 5, 1), ("kill_ckpt", 4, 1),
             ("kill_loop", 5, 3), ("kill_loop", 0, 1), ("ps_loss", 5, 1),
             ("hang", 2, 2), ("oom", 3, 1)]
    n = 0
    for kind, step, count in specs:
        ts = tfaults.FaultSpec(kind, step, count)
        js = jfaults.FaultSpec(kind, step, count)
        for s in range(0, 10):
            for inc in range(0, 5):
                got = tfaults.ProcessFaultInjector.fires(ts, s, inc)
                want = jfaults.ProcessFaultInjector.fires(js, s, inc)
                assert got == want, (kind, step, count, s, inc)
                n += got
    assert n > 0


def test_injector_fires_as_in_the_reference():
    """The in-process injector fires the same faults at the same steps,
    replays included."""
    spec = "ps_loss@3:2,oom@5,oom@6,hang@7:0.01,ps_loss@9"
    t = tfaults.FaultInjector(tfaults.parse_chaos_spec(spec))
    j = jfaults.FaultInjector(jfaults.parse_chaos_spec(spec))

    def outcome(inj, step):
        try:
            inj.before_step(step)
        except RuntimeError as e:
            return type(e).__name__
        return None

    for step in [0, 1, 2, 3, 3, 4, 5, 5, 6, 7, 8, 9, 9, 10]:
        assert outcome(t, step) == outcome(j, step), step
    assert t.fired == j.fired
    assert [(e["fault"], e["step"], e["detail"]) for e in t.log] == \
        [(e["fault"], e["step"], e["detail"]) for e in j.log]
