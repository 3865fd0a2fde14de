"""Port parity: the row-wise optimizer updates (K2/K3 plain versions on the
CPU) and the optimizer transforms of ``train/optim.py``.

Tolerances, the bounds of ``tests/test_fused_update.py``: updated params
within 64 ULP, moments within 4 ULP of the JAX ``xla`` fallback; rows that
are not touched (and the sentinel tail) stay bit-identical. Optimizer
transforms on random trees: within 4 ULP per leaf (norms and clip scales
are sums whose order differs, so 1e-6 relative there).
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_ulp_close, flatten_jax_tree, to_np  # noqa: E402
from repro.kernels import fused_update as jfu  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.kernels import fused_update as tfu  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

PARAM_ULP, MOMENT_ULP = 64, 4


def _rows_case(R=200, D=16, n=120, seed=0, live=70):
    """Deduped COO rows (unique, with a sentinel tail) + pools, as numpy."""
    rng = np.random.default_rng(seed)
    rows = np.full((n,), R, np.int32)
    if live:
        inner = rng.choice(np.arange(1, R - 1), live - 2, replace=False)
        rows[:live] = np.concatenate([[0, R - 1], inner])  # boundary rows
    vals = rng.standard_normal((n, D)).astype(np.float32)
    vals[live:] = 0.0
    params = rng.standard_normal((R, D)).astype(np.float32)
    m = (0.1 * rng.standard_normal((R, D))).astype(np.float32)
    v = rng.uniform(0.0, 0.5, (R, D)).astype(np.float32)
    return params, m, v, rows, vals


def _untouched(R, rows):
    mask = np.ones(R, bool)
    mask[rows[rows < R]] = False
    return mask


@pytest.mark.parametrize("D", [16, 1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adagrad_rows_match_reference(seed, D):
    params, acc, _, rows, vals = _rows_case(D=D, seed=seed)
    acc = np.abs(acc)
    jp, ja = jfu.adagrad_row_update(jnp.asarray(params), jnp.asarray(acc),
                                    jnp.asarray(rows), jnp.asarray(vals),
                                    lr=0.05, method="xla")
    tp, ta = torch.from_numpy(params.copy()), torch.from_numpy(acc.copy())
    out = tops.fused_row_update(tp, torch.from_numpy(rows),
                                torch.from_numpy(vals), ta, kind="adagrad",
                                lr=0.05)
    assert out[0] is tp and out[1] is ta                  # in place
    assert_ulp_close(tp.numpy(), np.asarray(jp), PARAM_ULP, "params")
    assert_ulp_close(ta.numpy(), np.asarray(ja), MOMENT_ULP, "acc")
    keep = _untouched(params.shape[0], rows)
    np.testing.assert_array_equal(tp.numpy()[keep], params[keep])
    np.testing.assert_array_equal(ta.numpy()[keep], acc[keep])


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("count", [1, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_adam_rows_match_reference(seed, count, wd):
    params, m, v, rows, vals = _rows_case(seed=seed)
    jp, jm, jv = jfu.adam_row_update(
        jnp.asarray(params), jnp.asarray(m), jnp.asarray(v),
        jnp.asarray(rows), jnp.asarray(vals), lr=0.01, count=count,
        weight_decay=wd, method="xla")
    tp, tm, tv = (torch.from_numpy(x.copy()) for x in (params, m, v))
    tops.fused_row_update(tp, torch.from_numpy(rows), torch.from_numpy(vals),
                          tm, tv, kind="adam", lr=0.01, count=count,
                          weight_decay=wd)
    assert_ulp_close(tp.numpy(), np.asarray(jp), PARAM_ULP, "params")
    assert_ulp_close(tm.numpy(), np.asarray(jm), MOMENT_ULP, "m")
    assert_ulp_close(tv.numpy(), np.asarray(jv), MOMENT_ULP, "v")
    keep = _untouched(params.shape[0], rows)
    for got, before in ((tp, params), (tm, m), (tv, v)):
        np.testing.assert_array_equal(got.numpy()[keep], before[keep])


def _interleaved_case(D, seed, R=300, n=160, live=90, tail=30):
    """Unsorted live rows with padding entries (any value >= R) interleaved
    among them and as a tail, as numpy; the padding carries nonzero vals."""
    rng = np.random.default_rng(seed)
    rows = (R + rng.integers(0, 1000, n)).astype(np.int32)
    rows[rng.integers(0, n - tail, 4)] = np.iinfo(np.int32).max
    at = rng.choice(n - tail, live, replace=False)
    rows[at] = rng.choice(R, live, replace=False)
    vals = rng.standard_normal((n, D)).astype(np.float32)
    params = rng.standard_normal((R, D)).astype(np.float32)
    m = (0.1 * rng.standard_normal((R, D))).astype(np.float32)
    v = rng.uniform(0.0, 0.5, (R, D)).astype(np.float32)
    return params, m, v, rows, vals


@pytest.mark.parametrize("kind", ["adagrad", "adam"])
@pytest.mark.parametrize("D", [16, 1])
def test_rows_with_interleaved_padding_match_reference(D, kind):
    """K2/K3's plain versions skip padding wherever it stands, as the
    reference's scatter drops it."""
    params, m, v, rows, vals = _interleaved_case(D, seed=D)
    assert (rows[:-30] >= params.shape[0]).any() and \
        (np.diff(rows[rows < params.shape[0]]) < 0).any()
    if kind == "adagrad":
        state, hyper = (v,), dict(lr=0.05)
        want = jfu.adagrad_row_update(
            *(jnp.asarray(x) for x in (params, v, rows, vals)), method="xla",
            **hyper)
    else:
        state, hyper = (m, v), dict(lr=0.01, count=5, weight_decay=0.01)
        want = jfu.adam_row_update(
            *(jnp.asarray(x) for x in (params, m, v, rows, vals)),
            method="xla", **hyper)
    got = [torch.from_numpy(x.copy()) for x in (params, *state)]
    tops.fused_row_update(got[0], torch.from_numpy(rows),
                          torch.from_numpy(vals), *got[1:], kind=kind,
                          **hyper)
    keep = _untouched(params.shape[0], rows)
    for i, (g, w, before) in enumerate(zip(got, want, (params, *state))):
        assert_ulp_close(g.numpy(), np.asarray(w),
                         PARAM_ULP if i == 0 else MOMENT_ULP, f"{kind} {i}")
        np.testing.assert_array_equal(g.numpy()[keep], before[keep])


def test_update_plan_and_route_follow_the_shape_alone():
    """K2/K3's launch geometry is a function of (N, D, SM count, route), and
    the route of the width and the arrays' alignment."""
    plan, sms, T = tfu.update_plan, 132, tfu.THREADS
    wave = sms * (tfu.THREADS_PER_SM // T)          # 1,056 blocks of 256

    def cdiv(a, b):
        return -(-a // b)

    # the main path: 512 x 26 x 4 entries, deep pool D=16 and wide pool D=1
    N = 512 * 26 * 4
    assert plan(N, 16, sms, "vector") == cdiv(4 * N, T) == 832
    assert plan(N, 1, sms, "scalar") == cdiv(N, T) == 208
    for n in (0, -1):
        assert plan(n, 16, sms) == 0 and plan(n, 1, sms, "scalar") == 0
    assert plan(5, 16, sms) == 1 and plan(5, 1, sms, "scalar") == 1
    # a thread per entry on any other width and on the scalar D=16 route
    for D, route in ((6, "scalar"), (4, "vector"), (16, "scalar")):
        assert plan(1000, D, sms, route) == cdiv(1000, T)
        assert plan(10 ** 8, D, sms, route) == wave
    assert plan(10 ** 8, 16, sms) == wave
    assert plan(10 ** 7, 1, 66, "scalar") == 66 * tfu.THREADS_PER_SM // T
    for n in (1, 31, 33, 1000, 53248, 10 ** 6):
        for D, route, per_entry in ((16, "vector", tfu.VEC_LANES),
                                    (1, "scalar", 1), (6, "scalar", 1)):
            blocks = plan(n, D, sms, route)
            assert 1 <= blocks <= wave
            if blocks < wave:        # uncapped: the grid covers the work
                assert blocks * T >= n * per_entry > (blocks - 1) * T
    # the kernels' block size is the plan's
    cu = (Path(tfu.__file__).parents[1] / "csrc" / "fused_update.cu"
          ).read_text()
    assert f"constexpr int kThreads = {T};" in cu

    # the route: D % 4 == 0 and every array on 16 bytes -> vector
    def pool(R, D, offset=0):
        return torch.zeros(R * D + 4)[offset:offset + R * D].view(R, D)

    route = tfu.update_route
    assert route(16, pool(8, 16), pool(3, 16)) == "vector"
    assert route(4, pool(8, 4), pool(3, 4), pool(8, 4)) == "vector"
    assert route(1, pool(8, 1), pool(3, 1)) == "scalar"
    assert route(6, pool(8, 6), pool(3, 6)) == "scalar"
    assert route(16, pool(8, 16, 1), pool(3, 16)) == "scalar"
    assert route(16, pool(8, 16), pool(3, 16, 2)) == "scalar"
    assert route(16, pool(8, 16), pool(3, 16), pool(8, 16, 3)) == "scalar"
    assert route(16, pool(8, 16), pool(3, 16), pool(8, 16, 4)) == "vector"


def test_adam_bias_pair_matches_reference():
    for count in (1, 2, 10, 1000):
        tc = jnp.asarray(count, jnp.float32)
        want = np.asarray(jnp.stack([1 - 0.9 ** tc, 1 - 0.999 ** tc]))
        got = tfu.adam_bias(count, 0.9, 0.999, "cpu")
        assert got.dtype == torch.float32
        assert_ulp_close(got.numpy(), want, 1, f"bias at {count}")


@pytest.mark.parametrize("kind", ["adagrad", "adam"])
def test_negative_rows_are_padding(kind):
    """Row ids below 0 are padding, as ids >= R are: the plain version
    skips them (the reference's scatter would wrap them to R + id; the
    dedupe never makes one), and the kernels do the same."""
    params, m, v, rows, vals = _interleaved_case(16, seed=5)
    R = params.shape[0]
    neg = rows.copy()
    pad = np.flatnonzero(rows >= R)
    neg[pad[::2]] = -1 - (rows[pad[::2]] - R)
    assert (neg < 0).any()
    hyper = dict(lr=0.05) if kind == "adagrad" else dict(lr=0.01, count=3)
    outs = []
    for r in (rows, neg):
        got = [torch.from_numpy(x.copy()) for x in (params, m, v)]
        state = got[2:] if kind == "adagrad" else got[1:]
        tops.fused_row_update(got[0], torch.from_numpy(r),
                              torch.from_numpy(vals), *state, kind=kind,
                              **hyper)
        outs.append(got)
    for g, w in zip(*outs):
        assert torch.equal(g, w)


def test_all_sentinel_rows_are_a_no_op():
    params, acc, _, rows, vals = _rows_case(live=0)
    rows[:] = params.shape[0]
    tp, ta = torch.from_numpy(params.copy()), torch.from_numpy(acc.copy())
    tfu.adagrad_row_update(tp, ta, torch.from_numpy(rows),
                           torch.from_numpy(vals), lr=0.1)
    assert torch.equal(tp, torch.from_numpy(params))
    with pytest.raises(ValueError):
        tops.fused_row_update(tp, torch.from_numpy(rows),
                              torch.from_numpy(vals), ta, kind="sgd")


# ---------------------------------------------------------------------------
# optimizer transforms over random trees
# ---------------------------------------------------------------------------
def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"tables": rng.standard_normal((12, 4)).astype(np.float32),
            "mlp": {"w0": rng.standard_normal((5, 3)).astype(np.float32),
                    "b0": rng.standard_normal((3,)).astype(np.float32),
                    "w_out": rng.standard_normal((3, 1)).astype(np.float32)},
            "wide_dense": rng.standard_normal((5,)).astype(np.float32)}


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def _ttree(t):
    return {k: torch.from_numpy(v.copy()) for k, v in
            flatten_jax_tree(t).items()}


def _assert_tree_close(ttree, jtree, ulp, msg):
    want = flatten_jax_tree(jtree)
    assert set(ttree) == set(want), msg
    for k, w in want.items():
        assert_ulp_close(to_np(ttree[k]), w, ulp, f"{msg} {k}")


@pytest.mark.parametrize("name,kw", [
    ("adagrad", {}), ("adam", {}), ("adamw", {}), ("sgd", {}),
    ("sgd", {"momentum": 0.9}), ("adagrad", {"clip_norm": 0.5}),
    ("adam", {"master_weights": True}),
])
def test_optimizer_updates_match_reference(name, kw):
    params = _tree(0)
    jo, to = joptim.make(name, 0.01, **kw), toptim.make(name, 0.01, **kw)
    jp, tp = _jtree(params), _ttree(params)
    js, ts = jo.init(jp), to.init(tp)
    assert (jo.update_rows is None) == (to.update_rows is None)
    assert jo.clip_norm == to.clip_norm
    for step in range(3):
        grads = _tree(10 + step)
        ju, js = jo.update(_jtree(grads), js, jp)
        tu, ts = to.update(_ttree(grads), ts, tp)
        jp = joptim.apply_updates(jp, ju)
        tp = toptim.apply_updates(tp, tu)
        _assert_tree_close(tp, jp, 4, f"{name} step {step}")
    if "count" in ts:
        assert int(ts["count"]) == int(js["count"]) == 3


def test_norm_clip_and_compress_match_reference():
    grads = _tree(3)
    rows = np.array([1, 4, 12], np.int32)
    vals = np.random.default_rng(4).standard_normal((3, 4)).astype(np.float32)
    jg = dict(_jtree(grads), tables=joptim.SparseRowGrad(jnp.asarray(rows),
                                                          jnp.asarray(vals)))
    tg = dict(_ttree(grads), tables=toptim.SparseRowGrad(
        torch.from_numpy(rows), torch.from_numpy(vals)))
    np.testing.assert_allclose(float(toptim.global_norm(tg)),
                               float(joptim.global_norm(jg)), rtol=1e-6)
    tc, tn = toptim.clip_by_global_norm(tg, 0.5)
    jc, jn = joptim.clip_by_global_norm(jg, 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert torch.equal(tc["tables"].rows, tg["tables"].rows)
    np.testing.assert_allclose(to_np(tc["tables"].vals),
                               np.asarray(jc["tables"].vals), rtol=1e-6)
    np.testing.assert_allclose(to_np(tc["mlp.w0"]),
                               np.asarray(jc["mlp"]["w0"]), rtol=1e-6)
    tz = toptim.compress_grads(tg)
    jz = joptim.compress_grads(jg)
    np.testing.assert_array_equal(to_np(tz["mlp.w0"]),
                                  np.asarray(jz["mlp"]["w0"]))
    np.testing.assert_array_equal(to_np(tz["tables"].vals),
                                  np.asarray(jz["tables"].vals))
    assert tz["tables"].rows.dtype == torch.int32
