"""The control of every cell comes out not correct, on the card at the
cell's own size: the plain reference put in the program's place and
computed one precision below the configuration's (fp8 operands for a
bfloat16 configuration, TF32 for a float32 one), on three seeds, each
over its kind's ``CONTROL_SECONDS``.

    python3 -m pytest portbench/tests -m gpu
"""

import pytest

from portbench import bench
from portbench import run as harness

SEEDS = (2_200_000_001, 2_200_000_002, 2_200_000_003)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  bench.definitions()["workloads"]])
def test_control_is_not_correct(cell, seed):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seconds = bench.kind(bench.cell(cell).traffic).CONTROL_SECONDS
    res = harness.execute(cell, seed, seconds, False, modes=("control",))
    assert not res["correct"], res["checks"]
