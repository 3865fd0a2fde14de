"""Whole runs of the shrunk cells on the CPU: the program agrees with the
reference; the control and planted faults come out not correct; without a
card the harness fails and prints no result."""
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import CELLS, ROOT, run_small, small
from portbench.drivers import dlrm_train
from portbench.reference import dlrm as reference
from portbench.yardstick import check, faults
from portbench.yardstick import traffic as gen

BIG_SEED = 2 ** 31 + 977


@pytest.mark.parametrize("workload", CELLS)
def test_program_agrees_with_the_reference(workload):
    line = run_small(workload, BIG_SEED)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    for c in line["checks"].values():
        assert c["value"] <= 0.1 * c["limit"]
    assert set(line["metrics"]) == {"train_samples_per_s", "peak_mem_gib",
                                    "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_is_not_correct(workload, fault):
    with faults.planted(dlrm_train, fault):
        line = run_small(workload, BIG_SEED + 1)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_tf32_control_is_not_correct(workload):
    found = small(workload, batch=256, pool=3)
    config, traffic = found.config, found.traffic
    lr, eps = float(traffic["lr"]), float(traffic["eps"])
    for seed in (BIG_SEED, BIG_SEED + 2, BIG_SEED + 3):
        batches = gen.make_pool(config, traffic, seed, "cpu")

        def weights():
            return reference.make_weights(
                config, traffic["lookups_per_table"],
                gen.generator(seed, gen.WEIGHTS_STREAM, "cpu"))

        ref = reference.train(weights(), batches, config, lr=lr, eps=eps)
        control = reference.train(weights(), batches, config, lr=lr, eps=eps,
                                  precision="tf32")
        ok, numbers = check.verdict(check.readings(control, ref),
                                    found.limits)
        assert not ok, numbers


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 3 * 2 ** -12)])
    got = reference._round_tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                            -(1.0 + 2 ** -10)]


def test_without_a_card_it_fails_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", CELLS[0], "--seed", str(BIG_SEED), "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_window_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs on the card")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", CELLS[-1], "--seed", str(BIG_SEED), "--seconds", "2",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
