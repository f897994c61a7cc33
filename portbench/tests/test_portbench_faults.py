"""A run with the timed path broken underneath comes out not correct.

Each test passes over the harness's look for a card and drives the rest
of a run on the CPU at a small size (float32, where the sound run agrees
with the reference to rounding), once sound and once with each fault of
``faults.py`` that the cell can have."""

import pytest

from portbench import bench, faults
from portbench import run as harness
from portbench.tests.conftest import small

F32 = {"compute_dtype": "float32", "fast_sine": False}


CASES = [("train-bf16-default", "unchanged"),
         ("train-bf16-default", "half_batch"),
         ("train-bf16-ghostbn", "unchanged"),
         ("train-bf16-ghostbn", "half_batch"),
         ("render-f32-frames", "altered"),
         ("render-f32-frames", "half_rays"),
         ("serve-bf16-mixed", "altered"),
         ("serve-bf16-mixed", "half_rays")]


def _execute(cell, hooks=None):
    config = {} if "ghostbn" in cell else F32
    return harness.execute(cell, 4242, 1.0, False, device="cpu",
                           faults=hooks, overrides=small(cell, **config),
                           age=lambda: 0.0)


@pytest.mark.parametrize("cell", sorted({c for c, _ in CASES
                                         if "ghostbn" not in c}))
def test_sound_run_is_correct(cell):
    res = _execute(cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell,name", CASES,
                         ids=[f"{c}-{n}" for c, n in CASES])
def test_fault_is_not_correct(cell, name):
    res = _execute(cell, faults.FAULTS[name](bench.cell(cell).config))
    assert not res["correct"], (name, res["checks"])
