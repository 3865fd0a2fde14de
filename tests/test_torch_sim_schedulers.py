"""Port parity: the cloud simulator's event loop under each of its five
schedulers (``repro_torch.sim.{cluster,schedulers}``).

The same jobs, seeds and failure stream run through the reference's
``CloudSim`` and the port's: the event log is compared byte for byte, and
the job records, the utilisation series and the summary exactly. Failures,
stragglers and hot PSes are on. The runs are small (4 jobs, 4 h):
``dlrover_rm`` runs NSGA-II in every decision round. The port's recovery
costs come from the port's ``MigrationTimings``, the reference's from its
own; both hold the same numbers.
"""
import pytest

from _torch_parity import plain
from repro.core import migration as jmig
from repro.sim import cluster as jcl
from repro.sim import replay as jrep
from repro.sim import trace as jtr
from repro.sim import workload as jwl
from repro_torch.core import migration as tmig
from repro_torch.sim import cluster as tcl
from repro_torch.sim import replay as trep
from repro_torch.sim import schedulers as tsch
from repro_torch.sim import trace as ttr
from repro_torch.sim import workload as twl

SCHEDULERS = ["static_user", "static_tuned", "es", "optimus", "dlrover_rm"]
FAILURES = dict(pod_failure_rate_per_day=5.0,
                straggler_rate_per_pod_per_day=1.0,
                hotps_rate_per_pod_per_day=0.3)


def _run(cl, wl, mig, scheduler, *, wave=None, timings=None, n_jobs=4,
         horizon_h=4.0, **kw):
    jobs = wl.generate_jobs(n_jobs, seed=4, mean_msamples=20.0)
    sim = cl.CloudSim(scheduler, total_cpu=4096, total_mem_gb=32768, seed=2,
                      failure_seed=77, capacity_profile=wave,
                      timings=timings or mig.MigrationTimings(), **kw)
    return sim, sim.run(jobs, horizon_s=horizon_h * 3600.0)


def _assert_same(res_t, res_j):
    assert res_t.event_log() == res_j.event_log()
    assert plain(res_t.records) == plain(res_j.records)
    for series in ("ts_time", "ts_alloc_cpu", "ts_used_cpu", "ts_alloc_mem",
                   "ts_used_mem", "ts_capacity_cpu"):
        assert getattr(res_t, series) == getattr(res_j, series), series
    assert plain(trep.summarize(res_t)) == plain(jrep.summarize(res_j))
    assert plain(res_t.event_rates()) == plain(res_j.event_rates())


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_event_log_byte_identical_with_failures(scheduler):
    sim_t, res_t = _run(tcl, twl, tmig, scheduler, **FAILURES)
    _, res_j = _run(jcl, jwl, jmig, scheduler, **FAILURES)
    _assert_same(res_t, res_j)
    kinds = {k for _, _, k in res_t.events}
    assert "start" in kinds
    assert kinds & {"failure", "straggler", "hot_ps", "oom"}
    assert sim_t.traits.name == scheduler


def test_dlrover_rm_under_a_capacity_wave_and_measured_timings():
    """The brain's degradation ledger, a time-varying capacity and measured
    recovery costs, as the supervisor and the job master report them."""
    kw = dict(n_jobs=3, horizon_h=3.0, **FAILURES)
    sims, results = [], []
    for cl, wl, mig, tr in ((tcl, twl, tmig, ttr), (jcl, jwl, jmig, jtr)):
        wave = tr.CapacityWave(4096.0, 32768.0, amplitude=0.15,
                               period_s=2 * 3600.0)
        timings = mig.MigrationTimings(flash_ckpt_load_s=0.7,
                                       worker_reexec_s=12.5)
        sim, res = _run(cl, wl, mig, "dlrover_rm", wave=wave,
                        timings=timings, **kw)
        sims.append(sim)
        results.append(res)
    _assert_same(*results)
    events = [(t, j, k) for t, j, k in results[0].events
              if k in ("failure", "straggler", "hot_ps", "oom")]
    assert events
    for t, jid, _ in events:
        assert sims[0].scheduler.brain.degradation_penalty(jid, now=t) == \
            sims[1].scheduler.brain.degradation_penalty(jid, now=t)


def test_measured_timings_change_downtime_as_in_the_reference():
    def downtime(cl, wl, mig, **timings):
        _, res = _run(cl, wl, mig, "static_tuned", n_jobs=6, horizon_h=12.0,
                      timings=mig.MigrationTimings(**timings),
                      pod_failure_rate_per_day=5.0)
        return [r.downtime_s for r in res.records]

    slow = dict(provision_s=1800.0, rds_ckpt_load_s=1800.0)
    for kw in ({}, slow):
        assert downtime(tcl, twl, tmig, **kw) == downtime(jcl, jwl, jmig, **kw)
    assert sum(downtime(tcl, twl, tmig, **slow)) > \
        sum(downtime(tcl, twl, tmig))


def test_sim_configuration_as_in_the_reference():
    for cl, mig in ((tcl, tmig), (jcl, jmig)):
        default = cl.CloudSim("dlrover_rm", seed=9)
        assert default.failure_seed == 10
        slow = mig.MigrationTimings(flash_ckpt_load_s=123.0)
        sim = cl.CloudSim("dlrover_rm", seed=1, timings=slow,
                          straggler_rebalance_s=30.0, unmitigated_s=900.0)
        assert sim.timings is slow and sim.straggler_rebalance_s == 30.0
        assert sim.unmitigated_s == 900.0
    assert tcl.CloudSim("es", seed=9).rng.integers(0, 1 << 30, 8).tolist() == \
        jcl.CloudSim("es", seed=9).rng.integers(0, 1 << 30, 8).tolist()
    assert tcl.TIMINGS == tmig.MigrationTimings()
    with pytest.raises(KeyError):
        tsch.make_scheduler("no_such", tsch.ClusterCapacity(1.0, 1.0))
