"""The traffic generator: seeded, and the program's formulas."""
import numpy as np
import pytest
import torch

from conftest import small
from portbench.yardstick import traffic as gen
from repro_torch.data.synthetic import zipf_indices

BIG_SEED = 2 ** 31 + 12345


def _pool(seed):
    found = small("wide_deep.zipf105.b65536", batch=32, pool=3)
    return gen.make_pool(found.config, found.traffic, seed, "cpu")


def test_same_seed_same_pool_and_another_seed_another():
    a, b, c = _pool(BIG_SEED), _pool(BIG_SEED), _pool(BIG_SEED + 1)
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not torch.equal(a[0]["sparse"], c[0]["sparse"])
    assert not torch.equal(a[0]["sparse"], a[1]["sparse"])   # rows differ


@pytest.mark.parametrize("alpha", [1.05, 1.0, 0.7, 2.0])
@pytest.mark.parametrize("rows", [7, 1000, 870963])
def test_zipf_draw_is_the_programs_formula(alpha, rows):
    rng_u, rng_p = np.random.default_rng(3), np.random.default_rng(3)
    u = rng_u.random(20000)
    want = zipf_indices(rng_p, rows, 20000, alpha)
    got = gen.zipf_from_uniform(torch.from_numpy(u), torch.tensor(rows),
                                alpha)
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_stream_covers_the_table():
    u = torch.linspace(0, 1 - 1e-12, 1000, dtype=torch.float64)
    ids = gen.zipf_from_uniform(u, torch.tensor(10), 0.0)
    assert ids.min() == 0 and ids.max() == 9


def test_batch_shapes_and_ranges():
    found = small("xdeepfm.zipf105.b8192", batch=16, pool=2)
    pool = gen.make_pool(found.config, found.traffic, 5, "cpu")
    rows = torch.tensor(found.config["table_rows"])
    for b in pool:
        assert b["dense"].shape == (16, 4) and b["dense"].dtype == torch.float32
        assert b["sparse"].shape == (16, 6, 4)
        assert b["sparse"].dtype == torch.int32
        assert (b["sparse"] >= 0).all()
        assert (b["sparse"] < rows[None, :, None]).all()
        assert set(b["label"].unique().tolist()) <= {0.0, 1.0}
