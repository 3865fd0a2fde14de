"""Port parity: seamless migration and OOM prediction
(``repro_torch.core.migration``, ``repro_torch.core.oom``).

Both halves of ``tests/test_oom_migration.py`` against the port: the
``OOMPredictor`` (linear growth, categories per sample, no false positive
on a noisy plateau) and ``MigrationTimings`` / ``MigrationPlan`` /
``MigrationSession``, with the same numbers as the reference (exact: both
are the same float arithmetic) over a grid of timings and plans. The OOM
predictions are held to the reference exactly in
``tests/test_torch_perf_model.py``.
"""
import pytest

from repro.core import migration as jmig
from repro_torch.core.migration import (MigrationPlan, MigrationSession,
                                        MigrationTimings, Phase)
from repro_torch.core import migration as tmig
from repro_torch.core.oom import OOMPredictor


def test_oom_linear_growth_prediction():
    pred = OOMPredictor(dtype_bytes=4, emb_dim=16)
    for i in range(10):
        pred.observe(samples_consumed=i * 1000, mem_bytes=1e9 + i * 1e7)
    # slope = 1e7 bytes / 1000 samples = 1e4 bytes/sample
    assert pred.growth_rate() == pytest.approx(1e4, rel=1e-3)
    assert pred.predict(at_samples=20_000) == pytest.approx(1e9 + 2e8,
                                                            rel=1e-3)
    hit, peak = pred.will_oom(capacity_bytes=1.05e9,
                              samples_to_completion=50_000)
    assert hit and peak > 1.05e9
    ok, _ = pred.will_oom(capacity_bytes=1e12, samples_to_completion=50_000)
    assert not ok


def test_oom_categories_per_sample():
    pred = OOMPredictor(dtype_bytes=4, emb_dim=16)
    pred.observe(0, 0.0)
    pred.observe(1000, 64_000.0)       # 64 bytes/sample = 1 new category
    assert pred.categories_per_sample() == pytest.approx(1.0, rel=1e-3)


def test_oom_noisy_plateau_no_false_positive():
    pred = OOMPredictor()
    for i in range(20):
        pred.observe(i * 1000, 1e9 + (i % 2))    # flat
    hit, _ = pred.will_oom(2e9, 1e9)
    assert not hit


def test_seamless_vs_stop_restart_downtime():
    t = MigrationTimings()
    seamless = MigrationPlan(seamless=True, use_flash_ckpt=True, timings=t)
    trad = MigrationPlan(seamless=False, use_flash_ckpt=False, timings=t)
    assert seamless.downtime_seconds() == \
        t.flash_ckpt_save_s + t.flash_ckpt_load_s
    assert trad.downtime_seconds() == \
        t.rds_ckpt_save_s + t.provision_s + t.rds_ckpt_load_s
    assert seamless.downtime_seconds() < 0.05 * trad.downtime_seconds()


def test_migration_session_overlaps_training():
    plan = MigrationPlan(seamless=True, use_flash_ckpt=True)
    hooks = []
    s = MigrationSession(plan, started_at=0.0, on_sync=lambda: hooks.append(1))
    s.start()
    assert s.phase is Phase.PROVISIONING and not s.training_blocked
    s.tick(100.0)
    assert s.phase is Phase.PROVISIONING          # still training
    s.tick(plan.timings.provision_s + 1)
    assert s.phase is Phase.SYNC and s.training_blocked and hooks == [1]
    s.tick(plan.timings.provision_s + 1 + plan.downtime_seconds() + 0.1)
    assert s.phase is Phase.DONE
    assert s.downtime_accum == pytest.approx(plan.downtime_seconds())


def test_reexec_horizon_falls_back_to_provision():
    assert MigrationTimings().reexec_s() == MigrationTimings().provision_s
    assert MigrationTimings(worker_reexec_s=1.7).reexec_s() == 1.7


TIMINGS = [{}, {"provision_s": 60.0, "flash_ckpt_load_s": 0.4},
           {"worker_reexec_s": 2.5, "rds_ckpt_save_s": 30.0},
           {"flash_ckpt_save_s": 0.23, "flash_ckpt_load_s": 1.3,
            "worker_reexec_s": 5.6}]


@pytest.mark.parametrize("kw", TIMINGS, ids=range(len(TIMINGS)))
@pytest.mark.parametrize("seamless", [True, False])
@pytest.mark.parametrize("flash", [True, False])
def test_numbers_as_in_the_reference(kw, seamless, flash):
    t, j = tmig.MigrationTimings(**kw), jmig.MigrationTimings(**kw)
    assert t.reexec_s() == j.reexec_s()
    tp = tmig.MigrationPlan(seamless=seamless, use_flash_ckpt=flash,
                            timings=t)
    jp = jmig.MigrationPlan(seamless=seamless, use_flash_ckpt=flash,
                            timings=j)
    assert tp.downtime_seconds() == jp.downtime_seconds()
    assert tp.total_seconds() == jp.total_seconds()
    ts = tmig.MigrationSession(tp, started_at=10.0)
    js = jmig.MigrationSession(jp, started_at=10.0)
    ts.start()
    js.start()
    for now in (10.0, 50.0, 10.0 + t.provision_s, 10.0 + t.provision_s + 1,
                10.0 + t.provision_s + tp.downtime_seconds() + 1,
                10.0 + 2 * t.provision_s + 2 * tp.downtime_seconds() + 2):
        assert ts.tick(now).value == js.tick(now).value
        assert ts.training_blocked == js.training_blocked
        assert ts.downtime_accum == js.downtime_accum
