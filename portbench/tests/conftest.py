"""Small shapes for the benchmark's CPU tests: the cells' own code paths
at a width and a batch that one CPU core runs in seconds."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {"fc_units": 32, "batch_size": 64, "n_samples": 32, "chunk": 256}


def small(cell: str, **config) -> dict:
    """``execute`` overrides that run ``cell`` at a CPU test's size (the
    fused trunk takes widths that are multiples of 256 at the least, and
    two 2,048-row tiles, so that half of the batch is still one); the
    mix's kind gives its own small mix (its ``SMALL``)."""
    from portbench import bench
    c = bench.cell(cell)
    cfg = dict(SMALL, **config)
    if c.config.get("pallas_trunk"):
        cfg["fc_units"] = max(cfg["fc_units"], 256)
        cfg["batch_size"] = max(cfg["batch_size"], 128)
    return {"config": cfg, "traffic": bench.kind(c.traffic).SMALL}


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
