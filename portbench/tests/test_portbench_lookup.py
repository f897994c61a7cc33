"""BENCHMARK.json against the contract the checker holds it to, and every
cell found through the lookup by name that a run uses."""

import json
import os
import re

import pytest

from portbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = bench.definitions()
CELLS = [w["name"] for w in B["workloads"]]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["portbench"]
    assert B["command"][1] == "portbench/run.py"
    assert 1 <= B["run_seconds"] <= 51
    cells = len(B["workloads"])
    assert 1 <= cells <= 24
    # a full check of 24 cells must fit: 2 + 14 n runs, n cells' compiles
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(B)) < 64 * 1024


def test_entries():
    """Each entry's keys and names; 1 or 4 cards a cell, and at most a
    quarter of the cells (rounded down, one always) on 4."""
    B = bench.definitions()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"] == \
            f"portbench/configs/{c['name']}.json"
        with open(os.path.join(bench.ROOT, c["file"])) as f:
            file = json.load(f)
        # each key changed from the source is in the file, with its reason
        assert c["reduced"] == file["reduced"]
        assert all(k in file and k in file["assumed"] for k in c["reduced"])
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    four = [w["name"] for w in B["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(B["workloads"]) // 4), \
        f"too many four-card cells: {four}"
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(set(names)) == len(names) and all(map(NAME.match, names))
    setup = [m for m in B["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in B["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    """The configuration, the mix, its generator, the limits and each
    per-layer reader of ``name``, as a run finds them; each cell reports
    setup_s, another end-to-end metric and a per-layer one."""
    cell = bench.cell(name)
    assert all(k in cell.config for k in cell.config["reduced"])
    kind = bench.kind(cell.traffic)
    for fn in ("setup", "window", "release", "check"):
        assert callable(getattr(kind, fn))
    where = f"traffic/{cell.traffic['kind']}.py"
    assert isinstance(getattr(kind, "SMALL", None), dict), \
        f"{where} lacks SMALL, its mix at a CPU test's size"
    assert getattr(kind, "CONTROL_SECONDS", 0) > 0, \
        f"{where} lacks CONTROL_SECONDS, the window of a control run"
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(bench.reader(m["name"]).read)
        moved = [e for e in cell.end_to_end if e["name"] == m["moves"]]
        assert moved, (m["name"], name)


def test_every_file_is_named_from_a_name():
    here = bench.HERE
    for sub in ("configs", "traffic", "limits", "metrics"):
        for f in os.listdir(os.path.join(here, sub)):
            if f != "__pycache__":
                assert NAME.match(f), f
