"""Port parity: the resource-performance model, NSGA-II, the OOM predictor
and the warm start (``repro_torch.core.{perf_model,nsga2,oom,warm_start}``).

Both packages run the same numpy/scipy arithmetic on the same host, so every
comparison is exact (``==``, ``np.array_equal``): fitted ``alpha`` and
``beta_sum``, predictions, NSGA-II fronts, OOM predictions and warm-start
plans. A difference would mean a changed draw or reduction order, not
rounding.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import nsga2 as jnsga
from repro.core import oom as joom
from repro.core import perf_model as jpm
from repro.core import warm_start as jws
from repro_torch.core import nsga2 as tnsga
from repro_torch.core import oom as toom
from repro_torch.core import perf_model as tpm
from repro_torch.core import warm_start as tws

ALPHA = [3.48e-3, 2.36e-3, 0.68e-3, 2.45e-5]
BETA = 2.45e-3
STAT = dict(batch_size=512, model_size=3.2e8, bandwidth=1e9, emb_dim=16)


def _obs(mod, n, seed, noise):
    """Seeded ``synthesize_t_iter`` observations in package ``mod``."""
    rng = np.random.default_rng(seed)
    stat = mod.JobStatics(**STAT)
    out = []
    for _ in range(n):
        r = mod.JobResources(w=int(rng.integers(1, 24)),
                             p=int(rng.integers(1, 12)),
                             cpu_w=float(rng.integers(1, 32)),
                             cpu_p=float(rng.integers(1, 32)))
        out.append((r, stat, mod.synthesize_t_iter(r, stat, ALPHA, BETA,
                                                   noise=noise, rng=rng)))
    return out


def _degenerate(mod):
    """Every observation at one resource point: a singular system."""
    r = mod.JobResources(w=4, p=2, cpu_w=8, cpu_p=8)
    return [(r, mod.JobStatics(**STAT), 0.5)] * 12


PROBES = [dict(w=1, p=1, cpu_w=1.0, cpu_p=1.0),
          dict(w=4, p=2, cpu_w=8.0, cpu_p=8.0),
          dict(w=23, p=11, cpu_w=31.0, cpu_p=2.0)]


def _assert_same_model(tm, jm, t_obs, j_obs):
    assert tm.fitted == jm.fitted
    assert np.array_equal(tm.alpha, jm.alpha)
    assert tm.beta_sum == jm.beta_sum
    stat_t, stat_j = tpm.JobStatics(**STAT), jpm.JobStatics(**STAT)
    for kw in PROBES:
        rt, rj = tpm.JobResources(**kw), jpm.JobResources(**kw)
        assert tm.t_iter(rt, stat_t) == jm.t_iter(rj, stat_j)
        assert tm.throughput(rt, stat_t) == jm.throughput(rj, stat_j)
        assert tm.term_breakdown(rt, stat_t) == jm.term_breakdown(rj, stat_j)
    assert tm.rmsle(t_obs) == jm.rmsle(j_obs)


@pytest.mark.parametrize("n,seed,noise", [(4, 0, 0.0), (48, 0, 0.0),
                                          (64, 2, 0.3), (96, 7, 0.05)])
def test_fit_as_in_the_reference(n, seed, noise):
    t_obs, j_obs = _obs(tpm, n, seed, noise), _obs(jpm, n, seed, noise)
    assert [t for *_, t in t_obs] == [t for *_, t in j_obs]
    for (rt, st, _), (rj, sj, _) in zip(t_obs, j_obs):
        assert np.array_equal(tpm.feature_vector(rt, st),
                              jpm.feature_vector(rj, sj))
    _assert_same_model(tpm.PerfModel().fit(t_obs), jpm.PerfModel().fit(j_obs),
                       t_obs, j_obs)


def test_fit_of_one_observation_leaves_the_model_unfitted():
    t_obs, j_obs = _obs(tpm, 1, 3, 0.0), _obs(jpm, 1, 3, 0.0)
    tm, jm = tpm.PerfModel().fit(t_obs), jpm.PerfModel().fit(j_obs)
    assert not tm.fitted and not jm.fitted
    assert np.array_equal(tm.alpha, jm.alpha)


@pytest.mark.parametrize("nnls_raises", [False, True],
                         ids=["nnls", "lstsq_fallback"])
def test_degenerate_fit_as_in_the_reference(monkeypatch, nnls_raises):
    """All observations at one point. With ``nnls_raises`` both modules'
    ``nnls`` raise ``LinAlgError`` on it, as newer scipy does, and the fit
    takes the clipped ``lstsq`` fall-back in both."""
    calls = []
    if nnls_raises:
        def singular(A, b):
            calls.append(A.shape)
            raise np.linalg.LinAlgError("singular")
        monkeypatch.setattr(tpm, "nnls", singular)
        monkeypatch.setattr(jpm, "nnls", singular)
    t_obs, j_obs = _degenerate(tpm), _degenerate(jpm)
    tm, jm = tpm.PerfModel().fit(t_obs), jpm.PerfModel().fit(j_obs)
    assert calls == ([(12, 5), (12, 5)] if nnls_raises else [])
    assert tm.fitted and np.all(tm.alpha >= 0.0) and tm.beta_sum >= 0.0
    _assert_same_model(tm, jm, t_obs, j_obs)


# ------------------------------------------------------------------ NSGA-II
def _obj(x):
    return (x[0] ** 2 + x[1], (x[0] - 3) ** 2 + 0.1 * x[1])


@pytest.mark.parametrize("seed,integer,pop,gens", [
    (0, True, 12, 6), (5, True, 24, 12), (11, False, 16, 8), (3, False, 2, 2)])
def test_nsga2_front_as_in_the_reference(seed, integer, pop, gens):
    bounds = [(0, 8), (0, 8)]
    got = tnsga.nsga2(_obj, bounds, pop_size=pop, generations=gens,
                      integer=integer, seed=seed)
    want = jnsga.nsga2(_obj, bounds, pop_size=pop, generations=gens,
                       integer=integer, seed=seed)
    assert len(got) == len(want) > 0
    for (xt, ft), (xj, fj) in zip(got, want):
        assert np.array_equal(xt, xj) and np.array_equal(ft, fj)


def _pos(pop, ind):
    return next(i for i, p in enumerate(pop) if p is ind)


def test_nsga2_operators_as_in_the_reference():
    """Sorting, crowding and each variation operator, one draw at a time."""
    rng = np.random.default_rng(4)
    fs = [rng.random(2) for _ in range(10)] + [np.array([0.5, 0.5])] * 2
    tp = [tnsga.Individual(x=np.zeros(1), f=f.copy()) for f in fs]
    jp = [jnsga.Individual(x=np.zeros(1), f=f.copy()) for f in fs]
    tf, jf = tnsga.fast_non_dominated_sort(tp), jnsga.fast_non_dominated_sort(jp)
    assert [[_pos(tp, p) for p in fr] for fr in tf] == \
        [[_pos(jp, p) for p in fr] for fr in jf]
    for fr_t, fr_j in zip(tf, jf):
        tnsga.crowding_distance(fr_t)
        jnsga.crowding_distance(fr_j)
        assert [p.crowding for p in fr_t] == [p.crowding for p in fr_j]
    lo, hi = np.zeros(3), np.full(3, 8.0)
    rt, rj = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(5):
        assert _pos(tp, tnsga._tournament(tp, rt)) == \
            _pos(jp, jnsga._tournament(jp, rj))
        a, b = rt.random(3) * 8, rj.random(3) * 8
        assert np.array_equal(a, b)
        ct = tnsga._sbx(a, a[::-1].copy(), lo, hi, rt)
        cj = jnsga._sbx(b, b[::-1].copy(), lo, hi, rj)
        assert all(np.array_equal(u, v) for u, v in zip(ct, cj))
        assert np.array_equal(tnsga._poly_mutate(a, lo, hi, rt),
                              jnsga._poly_mutate(b, lo, hi, rj))


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_nsga2_rejects_non_finite_as_the_reference(bad):
    for mod in (tnsga, jnsga):
        with pytest.raises(ValueError, match="non-finite"):
            mod.nsga2(lambda x: (bad, 1.0), [(0, 1)], pop_size=4,
                      generations=1, seed=0)


# --------------------------------------------------------------------- OOM
OOM_RUNS = {
    "linear": [(i * 1000, 1e9 + i * 1e7) for i in range(10)],
    "plateau": [(i * 1000, 1e9 + (i % 2)) for i in range(20)],
    "one_category": [(0, 0.0), (1000, 64_000.0)],
    "single": [(5000, 2e9)],
    "windowed": [(i * 997, 3e9 + (i % 7) * 1e6 + i * 2.5e5) for i in range(90)],
    "lifecycle": [(n * 256, 4e9 + n * 256 * 1e3) for n in range(1, 151)],
}


@pytest.mark.parametrize("run", sorted(OOM_RUNS))
def test_oom_predictions_as_in_the_reference(run):
    tp, jp = toom.OOMPredictor(), joom.OOMPredictor()
    for s, m in OOM_RUNS[run]:
        tp.observe(s, m)
        jp.observe(s, m)
    assert tp._samples == jp._samples and tp._mem == jp._mem
    assert tp.growth_rate() == jp.growth_rate()
    assert tp.categories_per_sample() == jp.categories_per_sample()
    for at in (0.0, 2e4, 1e6):
        assert tp.predict(at) == jp.predict(at)
    for cap in (1.05e9, 4.05e9, 1.6e10, 1e12):
        for remaining in (0.0, 5e4, 1e9):
            assert tp.will_oom(cap, remaining) == jp.will_oom(cap, remaining)
            assert tp.recommended_capacity(remaining) == \
                jp.recommended_capacity(remaining)


# -------------------------------------------------------------- warm start
def _meta(mod, kind="dcn", size=1e6, user="u0", rows=1e7):
    return mod.JobMeta(kind, dense_params=size, emb_rows=rows, emb_dim=16,
                       batch_size=512, dataset_samples=1e7, user=user)


HISTORY = [("dcn", 1e12, "x", 1e7, dict(w=1, p=1, cpu_w=1, cpu_p=1)),
           ("dcn", 1e6, "u0", 1e7, dict(w=16, p=8, cpu_w=16, cpu_p=16)),
           ("wide_deep", 3e6, "u1", 5e6, dict(w=6, p=3, cpu_w=12, cpu_p=6)),
           ("xdeepfm", 1e7, "u0", 2e7, dict(w=9, p=2, cpu_w=7.5, cpu_p=3)),
           ("dcn", 2e6, "u2", 1e6, dict(w=3, p=5, cpu_w=4, cpu_p=20))]


def _db(mod, n):
    db = mod.ConfigDB()
    for kind, size, user, rows, res in HISTORY[:n]:
        db.add(mod.ConfigRecord(_meta(mod, kind, size, user, rows),
                                mod.JobResources(**res),
                                throughput=size / 1e3))
    return db


@pytest.mark.parametrize("n_hist", [0, 1, 2, 5])
@pytest.mark.parametrize("k,mu", [(1, 0.5), (2, 0.8), (5, 0.5)])
def test_warm_start_as_in_the_reference(n_hist, k, mu):
    tdb, jdb = _db(tws, n_hist), _db(jws, n_hist)
    for kind, size, user in [("dcn", 1e6, "u0"), ("wide_deep", 4e6, "u9")]:
        tm, jm = _meta(tws, kind, size, user), _meta(jws, kind, size, user)
        default = dict(w=3, p=2, cpu_w=5, cpu_p=5)
        got = tws.warm_start(tm, tdb, k=k, mu=mu,
                             default=tpm.JobResources(**default))
        want = jws.warm_start(jm, jdb, k=k, mu=mu,
                              default=jpm.JobResources(**default))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for rec_t, rec_j in zip(tdb.records, jdb.records):
            assert tws.similarity(tm, rec_t.meta) == \
                jws.similarity(jm, rec_j.meta)
        a = dict(w=8, p=4, cpu_w=8, cpu_p=8)
        assert tws.warm_start_accuracy(got, tpm.JobResources(**a)) == \
            jws.warm_start_accuracy(want, jpm.JobResources(**a))
