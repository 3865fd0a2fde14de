"""Shared pieces of the benchmark's CPU tests: the import paths, and the
cells of ``BENCHMARK.json`` shrunk to a size a test run holds (every width
but the embedding's cut; the same traffic and limits files)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for _path in (os.path.join(ROOT, "src"), ROOT):
    if _path not in sys.path:
        sys.path.insert(0, _path)

import torch  # noqa: E402

from portbench import harness  # noqa: E402

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


def small(workload: str, batch: int = 64, pool: int = 5):
    """``harness.resolve(...)`` of ``workload`` with a few small tables, a
    narrow MLP and CIN, and a small batch and pool."""
    found = harness.resolve(harness.load_spec(), workload)
    found.config.update(n_dense=4, n_tables=6,
                        table_rows=[50, 300, 64, 1000, 20, 7],
                        mlp_dims=[32, 16])
    if "cin_layers" in found.config:
        found.config["cin_layers"] = [8, 8]
    found.traffic.update(batch=batch, pool_batches=pool, warmup_steps=1,
                         profiled_steps=2)
    return found


def run_small(workload: str, seed: int, **kw):
    """One CPU run of the shrunk cell through the harness; its result line."""
    return harness.run_workload(
        harness.load_spec(), workload, seed=seed, seconds=0.2, trace=False,
        device="cpu", t_start=0.0, found=small(workload, **kw))


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
