"""The benchmark's definitions, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics; everything else lives in a file of its own under this
folder, found by the name it carries there:

- ``configs/<config>.json``     the configuration as it is run
- ``traffic/<traffic>.json``    a traffic mix: its ``kind`` and parameters
- ``traffic/<kind>.py``         the generator of one kind of traffic:
                                ``setup``, ``window``, ``release`` and
                                ``check`` of a run, and for the tests
                                ``SMALL`` (the mix's keys at a CPU test's
                                size) and ``CONTROL_SECONDS`` (the window
                                of a control run on the card)
- ``limits/<cell>.json``        the limit of each number ``correct`` compares
- ``metrics/<metric>.py``       the reader of one per-layer metric

so a later change adds a cell, a configuration, a mix or a metric by
adding files and entries, and edits none.  A cell's ``chips`` (1 or 4)
are cards 0..n-1; a kind whose work spans processes runs rank 0 in the
harness's process, on ``cuda:0``, and the others as its children
(``run.py`` says what the harness then reads and watches).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "season_nerf_tpu")
# the reference's precision in the program's place, by mode and by the
# configuration's compute dtype: the control is one step below it
PRECISION = {"control": {"bfloat16": "fp8", "float32": "tf32"}}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json, with its name
    traffic: dict           # traffic/<traffic>.json, with its name
    limits: Dict[str, float]
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports


def definitions() -> dict:
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no BENCHMARK.json at {ROOT}")
    with open(path) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files read."""
    bench = definitions()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(_json("configs", f"{w['config']}.json"),
                  name=w["config"], reduced=configs[w["config"]]["reduced"])
    traffic = dict(_json("traffic", f"{w['traffic']}.json"),
                   name=w["traffic"])
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=_json("limits", f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def _module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(traffic: dict) -> ModuleType:
    """The generator module of a traffic mix's kind."""
    return _module(os.path.join(HERE, "traffic", f"{traffic['kind']}.py"),
                   f"portbench.traffic.{traffic['kind']}")


def reader(metric: str) -> ModuleType:
    """The reader module of a per-layer metric (its ``read(run)``)."""
    return _module(os.path.join(HERE, "metrics", f"{metric}.py"),
                   "portbench.metrics." + metric.replace(".", "_"))


def banned_modules(modules) -> List[str]:
    """The loaded modules whose top-level name, compared whole, is one
    the benchmark may not load."""
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in BANNED})
