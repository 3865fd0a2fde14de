"""Port parity: the planning layer of live re-planning, exact.

The placement planners, ``ShardingPolicy``, the padded layout's inverse
maps, the data-sharding service and its loader, the placement service, the
hot-table tracker and the row-frequency counters: the same numpy inputs go
through ``repro`` and ``repro_torch``, and every integer output (ranges,
permutations, cache plans, shard sequences, decisions) must be equal. The
float imbalances come from the same float64 numpy operations on the same
counts, so they must be equal too.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401
from repro.configs import dlrm_models as jcfg  # noqa: E402
from repro.core import sharding_service as jss  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.sharding import policy as jpol  # noqa: E402
from repro_torch.configs import dlrm_models as tcfg  # noqa: E402
from repro_torch.configs.registry import get_dlrm  # noqa: E402
from repro_torch.core import sharding_service as tss  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402

ROWS = (64, 40, 1, 96, 24)                      # a table with one row


def _count_vectors():
    rng = np.random.default_rng(7)
    n = sum(ROWS)
    single = np.zeros(n, np.int64)
    single[70] = 5
    ties = np.ones(n, np.int64)
    ties[::7] = 3
    skewed = rng.zipf(1.3, n).astype(np.int64)
    skewed[100:130] = 0
    return {"zeros": np.zeros(n, np.int64), "single-hot": single,
            "ties": ties, "skewed": skewed,
            "float": rng.random(n) * rng.zipf(1.5, n)}


COUNTS = _count_vectors()


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_planners_equal_the_reference(name):
    counts = COUNTS[name]
    a = jpol.frequency_permutation(counts, ROWS)
    b = tpol.frequency_permutation(counts, ROWS)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    for n_ps in (1, 3, 4, 7):
        ranges = tpol.balanced_vocab_ranges(counts, n_ps)
        assert ranges == jpol.balanced_vocab_ranges(counts, n_ps)
        assert tpol.placement_imbalance(counts, ranges) == \
            jpol.placement_imbalance(counts, ranges)
        uniform = tpol.uniform_vocab_ranges(counts.size, n_ps)
        assert tpol.placement_imbalance(counts, uniform) == \
            jpol.placement_imbalance(counts, uniform)
    packed = np.empty_like(counts)
    packed[b] = counts
    for budget in (0, 1, 16, 500):
        assert tpol.pack_hot_ranges(packed, ROWS, budget) == \
            jpol.pack_hot_ranges(packed, ROWS, budget)


@pytest.mark.parametrize("ranges", [None, [(0, 10), (10, 10), (10, 225)]])
def test_policy_values_equal_the_reference(ranges):
    j = jpol.make_dlrm_policy(None, vocab_ranges=ranges)
    t = tpol.make_dlrm_policy(None, vocab_ranges=ranges)
    assert t.vocab_ranges == j.vocab_ranges
    assert t.ps_row_ranges(225) == j.ps_row_ranges(225)
    assert t.with_vocab_ranges([(0, 5), (5, 225)]).ps_row_ranges(225) == \
        j.with_vocab_ranges([(0, 5), (5, 225)]).ps_row_ranges(225)
    assert t.with_vocab_ranges(None).vocab_ranges is None
    with pytest.raises(ValueError, match="GSPMD"):
        tpol.make_dlrm_policy(object())


@pytest.mark.parametrize("ranges", [[(0, 50), (50, 120), (120, 225)],
                                    [(0, 100), (100, 100), (100, 225)],
                                    [(0, 225)]])
def test_padded_inverse_maps_and_replanned_plan(ranges):
    jl = jpol.padded_layout_for_ranges(ranges)
    tl = tpol.padded_layout_for_ranges(ranges)
    np.testing.assert_array_equal(tl.padding_mask(), jl.padding_mask())
    real = np.flatnonzero(tl.padding_mask().reshape(-1))
    np.testing.assert_array_equal(tl.padded_to_flat(real),
                                  jl.padded_to_flat(real))
    np.testing.assert_array_equal(tl.padded_to_flat(tl.row_translation()),
                                  np.arange(tl.total_rows))
    cfg = tcfg.reduced_dlrm(get_dlrm("wide_deep"))
    jc = jcfg.reduced_dlrm(jcfg.WIDE_DEEP)
    hot = (3, 0, 1, 2, 0, 5)
    t = cfg.embedding_plan(sparse_update=True).with_replan(hot, tl)
    j = jc.embedding_plan(sparse_update=True).with_replan(hot, jl)
    for attr in ("offsets", "combiner", "table_hot", "sparse_update"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.layout == tl and t.with_replan(None, None).table_hot is None


def _drive_services(mod):
    """One scripted call order: pulls, heartbeats, a straggler, a reaped
    worker and an explicit failure (both requeue), completions, a stale
    completion and a second epoch. Returns every observable result."""
    svc = mod.ShardingService(1000, shard_size=96, num_epochs=2,
                              min_shard=16, heartbeat_timeout=5.0)
    log = []

    def pull(w, now):
        s = svc.request_shard(w, now)
        log.append(("pull", w, None if s is None else
                    (s.index, s.start, s.end, s.epoch)))
        return s

    a, b = pull("a", 0.0), pull("b", 0.0)
    pull("c", 0.0)
    svc.heartbeat("a", 96, 1.0)
    svc.heartbeat("b", 10, 1.0)
    svc.heartbeat("c", 90, 1.0)
    svc.report_done("a", a.index, 2.0)
    log.append(("stragglers", svc.detect_stragglers(2.0)))
    pull("b", 2.5)                               # still holds its shard
    svc.report_done("b", b.index, 3.0)
    pull("b", 3.0)                               # a straggler: a split shard
    svc.report_failure("c", 3.0)                 # requeued to the front
    pull("a", 3.5)
    log.append(("reaped", svc.check_failures(20.0)))   # b times out
    log.append(("pending", svc.pending_count()))
    for now in range(21, 60):
        s = pull("d", float(now))
        if s is None:
            break
        svc.heartbeat("d", s.size // 2, float(now))
        svc.report_done("d", s.index, float(now))
        svc.report_done("d", s.index, float(now))     # stale: ignored
    log.append(("coverage", svc.coverage(0), svc.coverage(1)))
    log.append(("completed", svc.completed_samples(),
                svc.completed_samples(0), svc.epochs_completed))
    return log


def test_sharding_service_sequences_equal_the_reference():
    assert _drive_services(tss) == _drive_services(jss)


def test_shard_loader_equals_the_reference():
    def run(ss, pipe):
        svc = ss.ShardingService(300, shard_size=64)
        hooks = []
        loader = pipe.ShardDataLoader(svc, "w", lambda idx: {"ids": idx},
                                      batch_size=24, heartbeat_every=2,
                                      fault_hook=hooks.append)
        ids = [b["ids"] for b in loader]
        return ids, hooks, svc.coverage(0)

    (ja, jh, jc), (ta, th, tc) = run(jss, jpipe), run(tss, tpipe)
    assert len(ja) == len(ta) and jh == th and jc == tc and tc[0]
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(a, b)


def _cfg_pair():
    kw = dict(table_rows=(300,) * 6, zipf_alpha=1.05, hot_rows_k=48)
    return (dataclasses.replace(jcfg.reduced_dlrm(jcfg.WIDE_DEEP), **kw),
            dataclasses.replace(tcfg.reduced_dlrm(get_dlrm("wide_deep")),
                                **kw))


def _stream(cfg, n, seed=3, shift=0):
    for i in range(n):
        sp = jsyn.criteo_batch(cfg, seed, np.arange(64 * i, 64 * i + 64))[
            "sparse"]
        yield ((sp.astype(np.int64) + shift) % 300).astype(sp.dtype)


def _assert_decisions_equal(j, t):
    assert (j is None) == (t is None)
    if j is None:
        return
    assert t.observed_at == j.observed_at
    assert t.table_hot == j.table_hot
    assert t.vocab_ranges == j.vocab_ranges
    np.testing.assert_array_equal(t.permutation, j.permutation)
    assert t.imbalance_before == j.imbalance_before
    assert t.imbalance_after == j.imbalance_after


@pytest.mark.parametrize("cooldown", [0, 3])
def test_hot_table_tracker_decisions_equal_the_reference(cooldown):
    jc, _ = _cfg_pair()
    kw = dict(n_ps=4, hot_budget=48, decay=0.85, trigger=1.2,
              cooldown=cooldown, min_lookups=512)
    jt = jss.HotTableTracker(jc.table_rows, **kw)
    tt = tss.HotTableTracker(jc.table_rows, **kw)
    jmap = np.arange(jt.total_rows)
    applied = 0
    for phase, shift in ((0, 0), (1, 131)):     # the skew drifts once
        for sp in _stream(jc, 8, seed=3 + phase, shift=shift):
            g = sp.astype(np.int64) + jt.offsets[None, :, None]
            local = (jmap[g] - jt.offsets[None, :, None]).astype(sp.dtype)
            jt.observe(local)
            tt.observe(local)
            assert tt.observes == jt.observes
            assert tt.imbalance() == jt.imbalance()
            np.testing.assert_array_equal(tt.snapshot(), jt.snapshot())
            jd, td = jt.maybe_replan(), tt.maybe_replan()
            _assert_decisions_equal(jd, td)
            if jd is not None:
                jt.mark_applied(jd)
                tt.mark_applied(td)
                jmap = jd.permutation[jmap]
                applied += 1
            assert tt.current_ranges == jt.current_ranges
            assert tt.current_hot == jt.current_hot
    assert applied >= 2 and tt.n_replans == jt.n_replans == applied
    delta = np.arange(jt.total_rows, dtype=np.float64) % 5
    jt.observe_counts(delta)
    tt.observe_counts(delta)
    np.testing.assert_array_equal(tt.snapshot(), jt.snapshot())


def test_tracker_seeded_with_a_plan_and_its_gates():
    jc, _ = _cfg_pair()
    ranges = [(0, 400), (400, 900), (900, 1300), (1300, 1800)]
    hot = (8, 8, 8, 8, 8, 8)
    kw = dict(n_ps=4, hot_budget=48, initial_ranges=ranges, initial_hot=hot,
              min_lookups=10 ** 9)
    jt = jss.HotTableTracker(jc.table_rows, **kw)
    tt = tss.HotTableTracker(jc.table_rows, **kw)
    assert tt.current_ranges == jt.current_ranges
    assert tt.current_hot == jt.current_hot == hot
    for sp in _stream(jc, 3):
        jt.observe(sp)
        tt.observe(sp)
    assert jt.maybe_replan() is None and tt.maybe_replan() is None


def test_placement_service_equals_the_reference():
    jc, _ = _cfg_pair()
    j = jss.ParameterPlacementService(jc.table_rows)
    t = tss.ParameterPlacementService(jc.table_rows)
    for i, sp in enumerate(_stream(jc, 4)):
        j.report_batch(f"w{i % 2}", sp)
        t.report_batch(f"w{i % 2}", sp)
    delta = np.arange(t.total_rows, dtype=np.int64) % 3
    j.report_counts("w2", delta)
    t.report_counts("w2", delta)
    np.testing.assert_array_equal(t.counts, j.counts)
    for budget in (0, 48, 5000):
        assert t.hot_plan(budget) == j.hot_plan(budget)
    for n_ps in (1, 4):
        assert t.ps_ranges(n_ps) == j.ps_ranges(n_ps)
        assert t.imbalance(n_ps) == j.imbalance(n_ps)


def test_row_freq_counters_equal_the_reference():
    jc, tc = _cfg_pair()
    j = jsyn.estimate_row_freq(jc, 11, n_samples=300, batch_size=64,
                               start=17)
    t = tsyn.estimate_row_freq(tc, 11, n_samples=300, batch_size=64,
                               start=17)
    np.testing.assert_array_equal(t.counts, j.counts)
    np.testing.assert_array_equal(t.offsets, j.offsets)
    assert t.n_lookups == j.n_lookups == 300 * 6 * tc.multi_hot
    for k in (1, 10, 5000):
        np.testing.assert_array_equal(t.top_k(k), j.top_k(k))
    for hot in ((0,) * 6, (4, 0, 9, 1, 300, 2)):
        assert t.hit_rate(hot) == j.hit_rate(hot)
    empty = tsyn.RowFreqCounter(ROWS)
    assert empty.hit_rate((1,) * 5) == 0.0 == \
        jsyn.RowFreqCounter(ROWS).hit_rate((1,) * 5)
