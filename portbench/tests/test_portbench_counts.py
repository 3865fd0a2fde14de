"""The benchmark's own operation and byte counts."""
import torch

from conftest import small
from portbench import harness
from portbench.yardstick import counts
from portbench.yardstick import traffic as gen


def _config(name):
    return harness.resolve(harness.load_spec(), {
        "wide_deep": "wide_deep.zipf105.b65536",
        "xdeepfm": "xdeepfm.zipf105.b8192"}[name]).config


def test_wide_deep_flops_by_hand():
    # MLP 429-512-256-128-1: 383,616 multiply-adds; the wide dense dot 13
    macs = 429 * 512 + 512 * 256 + 256 * 128 + 128
    assert macs == 383_616
    assert counts.train_flops_per_sample(_config("wide_deep")) == \
        3 * (2 * macs + 2 * 13)
    assert abs(counts.train_flops_per_sample(_config("wide_deep"))
               / 2.30e6 - 1) < 1e-3


def test_xdeepfm_flops_by_hand():
    mlp = 383_616
    cin = 26 * 26 * 16 * 128 + 128 * 26 * 16 * 128       # 8.2 M multiply-adds
    outer = 26 * 26 * 16 + 128 * 26 * 16
    assert cin == 8_200_192
    want = 3 * (2 * (mlp + cin) + outer + 2 * 256)
    assert counts.train_flops_per_sample(_config("xdeepfm")) == want
    assert abs(want / 51.6e6 - 1) < 5e-3


def test_byte_counts_on_a_hand_made_batch():
    table_rows = [10, 20]
    sparse = torch.tensor([[[0, 0], [3, 5]],
                           [[0, 1], [5, 5]]], dtype=torch.int32)  # B=2,T=2,H=2
    distinct = gen.distinct_rows({"sparse": sparse}, table_rows)
    assert distinct == 4                       # rows 0, 1 and 10+3, 10+5
    # K1 at D=16: 4 rows x 64 B, 8 int32 lookups, 2x2 bags of 64 B
    assert counts.k1_bytes(distinct, 2, 2, 2, 16) == 4 * 64 + 8 * 4 + 4 * 64
    # K1 at D=1 (the wide table)
    assert counts.k1_bytes(distinct, 2, 2, 2, 1) == 4 * 4 + 8 * 4 + 4 * 4
    # K2 at D=16: per row param, acc and grad read, param and acc written,
    # and its id
    assert counts.k2_bytes(distinct, 16) == 4 * (5 * 64 + 4)
    assert counts.sparse_stores(_config("wide_deep")) == [16, 1]
    assert counts.sparse_stores(_config("xdeepfm")) == [16]


def test_small_configs_count_what_they_hold():
    found = small("xdeepfm.zipf105.b8192")
    c = found.config
    d_in = c["n_dense"] + c["n_tables"] * c["embed_dim"]
    assert counts.mlp_macs(c) == d_in * 32 + 32 * 16 + 16
