"""``BENCHMARK.json``: every cell resolves to its files, and the file keeps
the shape the benchmark's contract gives it."""
import dataclasses
import importlib
import json
import os
import re

import pytest

from conftest import CELLS, ROOT
from portbench import harness
from portbench.yardstick import check, faults

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# Criteo Kaggle's 26 categorical vocabularies, as the DLRM reference
# (github.com/facebookresearch/dlrm) counts them without hashing
CRITEO_KAGGLE_ROWS = [
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572]


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["portbench"]
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word
    assert all(os.path.exists(os.path.join(ROOT, w))
               for w in SPEC["command"][1:])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_to_its_files(workload):
    found = harness.resolve(SPEC, workload)
    assert found.cell["chips"] == 1
    assert found.config["name"] == found.cell["config"]
    assert found.traffic["name"] == found.cell["traffic"]
    assert set(found.limits) >= set(check.NUMBERS) | {"readings"}
    importlib.import_module(f"portbench.drivers.{found.config['driver']}")
    for m in SPEC["per_layer"]:
        if harness.applies(m, workload):
            reader = importlib.import_module(f"portbench.metrics.{m['name']}")
            assert callable(reader.read)
    # each limit lies above the program's readings and below the least
    # upper one: the control's where it reads 3x the program's or more,
    # each fault's that reads 10x (the unchanged state: 3x)
    for num in check.NUMBERS:
        r = found.limits["readings"][num]
        low = r["program_max"]
        upper = [r["control_min"]] if r["control_min"] >= 3 * low else []
        for fault in faults.FAULTS:
            got = r[f"{fault}_min"]
            if got > 0 and got >= (3 if fault == "unchanged" else 10) * low:
                upper.append(got)
        assert upper and low < found.limits[num] < min(upper), num


def test_configs_are_the_programs():
    """Every width is the program's own config's; the tables are Criteo
    Kaggle's vocabularies, whole."""
    from repro_torch.configs.dlrm_models import WIDE_DEEP, XDEEPFM
    for entry in SPEC["configs"]:
        with open(os.path.join(ROOT, entry["file"])) as f:
            c = json.load(f)
        prog = {"wide_deep": WIDE_DEEP, "xdeepfm": XDEEPFM}[entry["name"]]
        assert entry["reduced"] == [] and c["reduced"] == []
        assert entry["source"] == c["source"]
        assert c["table_rows"] == CRITEO_KAGGLE_ROWS
        assert c["total_rows"] == sum(c["table_rows"]) == 33762577
        assert (c["n_dense"], c["n_tables"], c["embed_dim"]) == \
            (prog.n_dense, prog.n_tables, prog.embed_dim)
        assert tuple(c["mlp_dims"]) == prog.mlp_dims
        tables = dataclasses.replace(prog, table_rows=tuple(c["table_rows"]))
        assert c["param_count"] == tables.param_count()
        if c["kind"] == "xdeepfm":
            assert tuple(c["cin_layers"]) == prog.cin_layers


def test_names_units_and_metrics():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)


def test_check_time_fits_with_twenty_four_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
