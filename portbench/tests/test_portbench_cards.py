"""A cell added by new files and entries alone, on one card or on four:
the benchmark's contract and the spans' switch take it, and the harness
keeps to its multi-card contract (``run.py``): the fullest card's peak,
the busy time of the run's own card, and a run ended when a child dies.

Each test works on a copy of the benchmark's definitions and data files,
with the harness's lookup pointed at the copy, and adds what a later
change would add: a mix of a toy kind, its limits, a reader and their
entries in ``BENCHMARK.json``."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import bench, trace
from portbench import run as harness
from portbench.tests import test_portbench_lookup as lookup
from portbench.tests import test_portbench_spans as spans
from portbench.tests.test_portbench_spans import MS, Events

TOY = '''"""A kind for the harness's tests: set-up starts the mix's
``children`` (Python sources), writes their ids to ``pids`` and reports
the mix's ``peaks``; the window sleeps."""

import json
import subprocess
import sys
import time

SMALL = {}
CONTROL_SECONDS = 1.0


def setup(run):
    t = run.traffic
    for code in t.get("children", []):
        run.children.append(subprocess.Popen([sys.executable, "-c", code]))
    if "pids" in t:
        with open(t["pids"], "w") as f:
            json.dump([c.pid for c in run.children], f)
    run.peaks.update({int(k): v for k, v in t.get("peaks", {}).items()})


def window(run):
    t0 = time.perf_counter()
    time.sleep(run.seconds)
    run.window_span = (t0, time.perf_counter())
    run.attempted = 1
    run.end_to_end["toy_per_s"] = (1.0, "1/s")


def release(run):
    pass


def check(run, modes):
    return {m: {"gap": 0.0} for m in modes}
'''
READER = '''"""The toy kind's reader: nothing to read."""

SPANS = {spans}


def read(run):
    return None
'''


class Copy:
    """The benchmark's definitions and data files under ``root``, where
    the harness looks for them while the test runs."""

    def __init__(self, root, monkeypatch):
        self.root, self.here = str(root), str(root / "portbench")
        for sub in ("configs", "traffic", "limits", "metrics"):
            shutil.copytree(os.path.join(bench.HERE, sub),
                            os.path.join(self.here, sub),
                            ignore=shutil.ignore_patterns("__pycache__"))
        self.b = bench.definitions()
        self._write("traffic/toy.py", TOY)
        self.b["end_to_end"].append(
            {"name": "toy_per_s", "unit": "1/s", "better": "higher",
             "bound": 0.05, "source": "host_clock", "workloads": []})
        self.save()
        monkeypatch.setattr(bench, "ROOT", self.root)
        monkeypatch.setattr(bench, "HERE", self.here)

    def _write(self, path: str, text: str):
        with open(os.path.join(self.here, path), "w") as f:
            f.write(text)

    def save(self):
        with open(os.path.join(self.root, "BENCHMARK.json"), "w") as f:
            json.dump(self.b, f, indent=1)

    def add(self, name: str, chips: int, spans=False, **mix) -> str:
        """A cell ``name`` of the toy kind on ``chips`` cards, with a mix
        of its own (``mix``), its limit and a reader of its own."""
        self._write(f"traffic/{name}-mix.json",
                    json.dumps(dict(kind="toy", **mix)))
        self._write(f"limits/{name}.json", json.dumps({"gap": 1.0}))
        self._write(f"metrics/toy_ms.{name}.py", READER.format(spans=spans))
        self.b["workloads"].append(
            {"name": name, "config": "snerf-512-bf16",
             "traffic": f"{name}-mix", "chips": chips,
             "why": "a toy cell of the harness's tests"})
        self.b["end_to_end"][-1]["workloads"].append(name)
        self.b["per_layer"].append(
            {"name": f"toy_ms.{name}", "unit": "ms", "better": "lower",
             "source": "program_span", "layer": "toy",
             "moves": "toy_per_s", "workloads": [name]})
        self.save()
        return name


@pytest.fixture
def copy(tmp_path, monkeypatch):
    return Copy(tmp_path, monkeypatch)


def test_a_fifth_four_card_cell_keeps_to_the_contract(copy):
    name = copy.add("toy-dp4", 4)
    assert len(bench.definitions()["workloads"]) == 5
    lookup.test_entries()
    lookup.test_cell_found_by_name(name)
    lookup.test_every_file_is_named_from_a_name()


def test_a_second_four_card_cell_among_five_breaks_the_contract(copy):
    copy.add("toy-dp4", 4)
    copy.b["workloads"][0]["chips"] = 4
    copy.save()
    with pytest.raises(AssertionError, match="too many four-card cells"):
        lookup.test_entries()


@pytest.mark.parametrize("reads", [True, False])
def test_a_fifth_one_card_cell_keeps_the_spans_switch(copy, reads):
    name = copy.add("toy-one", 1, spans=reads)
    spans.test_only_the_cells_whose_readers_read_spans_turn_them_on()
    assert harness.reads_spans(bench.cell(name)) is reads
    lookup.test_cell_found_by_name(name)


RUN = """
import json, sys, time
import torch
from portbench import bench
from portbench import run as harness
bench.ROOT, bench.HERE = {root!r}, {here!r}
with open({stamp!r}, "w") as f:
    f.write(repr(time.monotonic()))
print(json.dumps(harness.execute("toy-dies", 7, 60.0, False, device="cpu",
                                 age=lambda: 0.0)))
"""


def test_a_dying_child_ends_the_run(copy, tmp_path):
    """One child exits with code 3 after a second, another would sleep
    for two minutes and the window for one: the run ends within 15 s of
    its start, with another code than 0 and no result, and neither child
    outlives it."""
    pids, stamp = tmp_path / "pids.json", tmp_path / "stamp"
    copy.add("toy-dies", 4, pids=str(pids), children=[
        "import sys, time; time.sleep(1); sys.exit(3)",
        "import time; time.sleep(120)"])
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=copy.root, here=copy.here,
                                          stamp=str(stamp))],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=harness.ROOT))
    ended = time.monotonic()
    assert out.returncode == harness.CHILD_DIED, out.stderr[-2000:]
    assert ended - float(stamp.read_text()) < 15
    assert '"correct"' not in out.stdout
    assert "exited with code 3" in out.stderr
    for pid in json.loads(pids.read_text()):
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_a_child_that_died_unseen_fails_close(copy):
    """A child dead before the watch looked fails the run at ``close``,
    which still ends the others."""
    name = copy.add("toy-close", 1)
    run = harness.Run(bench.cell(name), 1, 0.0, torch.device("cpu"))
    dead = subprocess.Popen([sys.executable, "-c", "raise SystemExit(5)"])
    dead.wait()
    alive = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(120)"])
    run.children += [dead, alive]
    with pytest.raises(RuntimeError, match="exited with code 5"):
        run.close()
    assert alive.poll() is not None


def test_a_kinds_peaks_raise_the_memory_peak(copy):
    copy.add("toy-peaks", 4, peaks={"2": 123_456_789})
    res = harness.execute("toy-peaks", 8, 0.05, False, device="cpu",
                          age=lambda: 0.0)
    assert res["correct"]
    assert res["device"]["memory_peak_bytes"] == 123_456_789
    assert res["device"]["count"] == 4


def test_busy_time_is_the_runs_cards():
    """Operations on two cards and one that names none: the busy time, its
    share inside spans and the idle gaps are card 0's (with the unnamed
    one), device time by name is every card's."""
    ev = Events()
    for start, dur, card in ((1.0, 10 * MS, 0), (2.0, 30 * MS, 1),
                             (3.0, 5 * MS, None)):
        ev.kernel("k", start, dur)
        if card is not None:
            ev.items[-1]["args"]["device"] = card
    zero, one, every = (trace.read_events(ev.items, 0.5, 0.0, 5.0, None, c)
                        for c in (0, 1, None))
    assert zero.busy_s == pytest.approx(15 * MS)
    assert one.busy_s == pytest.approx(35 * MS)
    assert every.busy_s == pytest.approx(45 * MS)
    for tr in (zero, one, every):
        assert tr.device_s() == pytest.approx(45 * MS)
    assert zero.busy_within([(0.0, 2.5)]) == pytest.approx(10 * MS)
    gaps = zero.breakdown(trace.Spans())["idle_gaps"]
    assert sum(g for _, g in gaps) == pytest.approx(5.0 - 15 * MS)
