"""The control of every cell comes out not correct, on the card at the
cell's own size: the plain reference put in the program's place and
computed one precision below the configuration's (fp8 operands for a
bfloat16 configuration, TF32 for a float32 one), on three seeds.

    python3 -m pytest portbench/tests -m gpu
"""

import pytest

from portbench import bench
from portbench import run as harness

SEEDS = (2_200_000_001, 2_200_000_002, 2_200_000_003)
WINDOW = {"train_steps": 2.0, "frames_closed": 3.0, "http_open": 8.0}


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  bench.definitions()["workloads"]])
def test_control_is_not_correct(cell, seed):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kind = bench.cell(cell).traffic["kind"]
    res = harness.execute(cell, seed, WINDOW[kind], False, modes=("control",))
    assert not res["correct"], res["checks"]
