"""The DLRM-DCNv2 cell at a small size on the CPU: the program agrees with
the reference; the TF32 control and each planted fault come out not
correct; the generator, the counts and the per-layer readers."""
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT
from portbench import harness
from portbench.drivers import dlrm_dcnv2, dlrm_train
from portbench.reference import dlrm_dcnv2 as reference
from portbench.yardstick import check, counts, counts_dcnv2, faults, multihot
from portbench.yardstick import traffic as gen

CELL = "dlrm_dcnv2.multihot.zipf105.b8192"
BIG_SEED = 2 ** 31 + 977


def small(batch=64, pool=5):
    """The cell with its tables cut to 60 rows and its widths narrowed
    (D=8, bottom 16-8, rank 4, over 16-8); the published lookups."""
    found = harness.resolve(harness.load_spec(), CELL)
    found.config.update(
        table_rows=[min(r, 60) for r in found.config["table_rows"]],
        embed_dim=8, bottom_mlp_dims=[16, 8], mlp_dims=[16, 8],
        cross_low_rank=4)
    found.traffic.update(batch=batch, pool_batches=pool, warmup_steps=1,
                         profiled_steps=2)
    return found


def run_small(seed, trace=False, **kw):
    return harness.run_workload(
        harness.load_spec(), CELL, seed=seed, seconds=0.2, trace=trace,
        device="cpu", t_start=0.0, found=small(**kw))


def test_config_is_the_published_model_cut_to_one_chip():
    found = harness.resolve(harness.load_spec(), CELL)
    c = found.config
    pub = c["published_table_rows"]
    assert len(pub) == 26 and sum(pub) == 204_184_588
    big = [i for i, r in enumerate(pub) if r == 40_000_000]
    assert big == [0, 9, 19, 20, 21]
    assert [c["table_rows"][i] for i in big] == [5_000_000] * 5
    assert all(c["table_rows"][i] == r for i, r in enumerate(pub)
               if i not in big)
    assert c["total_rows"] == sum(c["table_rows"]) == 29_184_588
    assert c["reduced"] == ["table_rows"]
    assert c["multi_hot"] == found.traffic["lookups_per_table"]
    assert sum(c["multi_hot"]) == 214 and max(c["multi_hot"]) == 100
    shapes = reference.param_shapes(c)
    n = sum(torch.Size(s).numel() for s, _ in shapes.values())
    assert n == c["param_count"]
    from repro_torch.configs.dlrm_models import DLRM_DCNV2
    assert DLRM_DCNV2.param_count() - DLRM_DCNV2.total_embedding_rows * 128 \
        == c["param_count"] - c["total_rows"] * 128


def test_flops_by_hand():
    c = harness.resolve(harness.load_spec(), CELL).config
    bottom = 13 * 512 + 512 * 256 + 256 * 128
    cross = 3 * 2 * 3456 * 512
    over = 3456 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256
    assert counts_dcnv2.forward_macs_per_sample(c) == \
        bottom + cross + over == 16_030_464
    assert counts_dcnv2.cross_macs_per_sample(c) == cross == 10_616_832
    assert abs(counts_dcnv2.train_flops_per_sample(c) * 8192
               / 788e9 - 1) < 1e-3
    assert counts_dcnv2.k1_bytes(10, 2, [3, 1], 2, 128) == \
        10 * 512 + 2 * 4 * 4 + 2 * 2 * 512
    assert counts.k2_bytes(10, 128) == 10 * 2564


def test_the_generator_is_seeded_ragged_and_in_range():
    found = small(batch=300, pool=2)
    a = multihot.make_pool(found.config, found.traffic, 5, "cpu")
    b = multihot.make_pool(found.config, found.traffic, 5, "cpu")
    c = multihot.make_pool(found.config, found.traffic, 6, "cpu")
    assert all(torch.equal(x["sparse"], y["sparse"]) for x, y in zip(a, b))
    assert not torch.equal(a[0]["sparse"], c[0]["sparse"])
    lookups = found.traffic["lookups_per_table"]
    s = a[0]["sparse"]
    assert s.shape == (300, 214) and s.dtype == torch.int32
    starts = multihot.starts(lookups)
    for t, rows in enumerate(found.config["table_rows"]):
        part = s[:, starts[t]:starts[t + 1]]
        assert int(part.min()) >= 0 and int(part.max()) < rows
    flat = multihot.flat_rows(s, found.config["table_rows"], lookups)
    assert int(flat.max()) < sum(found.config["table_rows"])


def test_program_agrees_with_the_reference():
    line = run_small(BIG_SEED)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"train_samples_per_s", "peak_mem_gib",
                                    "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    with faults.planted(dlrm_train, fault):
        line = run_small(BIG_SEED + 1)
    assert not line["correct"], line["checks"]


def test_a_config_cut_to_its_first_tables_keeps_their_sizes():
    found = harness.resolve(harness.load_spec(), CELL)
    config = dict(found.config, n_tables=4,
                  table_rows=found.config["table_rows"][:4])
    c, t = dlrm_dcnv2.tables_of(config, found.traffic)
    assert c["multi_hot"] == t["lookups_per_table"] == [3, 2, 1, 2]
    assert len(found.config["multi_hot"]) == 26
    with pytest.raises(ValueError):
        dlrm_dcnv2.tables_of(dict(config, n_tables=5), found.traffic)


def test_the_tf32_control_is_not_correct():
    found = small(batch=256, pool=3)
    config, traffic = found.config, found.traffic
    lr, eps = float(traffic["lr"]), float(traffic["eps"])
    for seed in (BIG_SEED, BIG_SEED + 2):
        batches = multihot.make_pool(config, traffic, seed, "cpu")

        def weights():
            return reference.make_weights(
                config, gen.generator(seed, gen.WEIGHTS_STREAM, "cpu"))

        ref = reference.train(weights(), batches, config, lr=lr, eps=eps)
        control = reference.train(weights(), batches, config, lr=lr,
                                  eps=eps, precision="tf32")
        ok, numbers = check.verdict(check.readings(control, ref),
                                    found.limits)
        assert not ok, numbers


def test_a_program_without_the_model_fails_before_drawing_weights(
        monkeypatch):
    from repro_torch.configs import dlrm_models
    monkeypatch.setattr(dlrm_models, "DLRMConfig", _NoDCNv2)
    drawn = []
    monkeypatch.setattr(reference, "make_weights",
                        lambda *a, **k: drawn.append(1))
    with pytest.raises(TypeError):
        run_small(BIG_SEED)
    assert not drawn


class _NoDCNv2:
    def __init__(self, *, name, kind, n_dense, n_tables, table_rows,
                 embed_dim, mlp_dims, batch_size, pooling, multi_hot,
                 zipf_alpha, hot_rows_k):
        pass


def test_readers_find_nothing_in_an_untraced_run():
    for name in ("step_mfu", "cross_ms_per_step", "k1_d128_roofline",
                 "k2_d128_roofline"):
        reader = __import__(f"portbench.metrics.{name}", fromlist=["read"])
        assert reader.read({"peaks": None}) is None
        assert reader.read({}) is None


@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_a_short_window_on_the_card():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", CELL, "--seed", str(BIG_SEED), "--seconds", "2",
         "--trace", "1"], capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 0, out.stderr
