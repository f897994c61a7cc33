"""What a run may load: no ``jax``, ``jaxlib``, ``flax`` or JAX package
by whole top-level name; nothing of the program in the reference; and no
result without a card."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import bench

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def test_names_compare_whole():
    mods = ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "jaxtyping",
            "flaxen", "season_nerf_tpu.ops", "season_nerf_torch.ops",
            "season_nerf_tpu_extra", "numpy"]
    assert bench.banned_modules(mods) == ["flax", "jax", "jaxlib",
                                          "season_nerf_tpu"]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True, env=dict(
                             os.environ, PYTHONPATH=ROOT))
    return set(out.stdout.split())


def test_a_run_loads_nothing_of_jax():
    """Everything a run imports: the harness, every kind of traffic and
    reader, the reference and the program's modules the kinds reach."""
    code = "\n".join([
        "from portbench import bench, run, readings, frames",
        "import season_nerf_torch.train.engine, season_nerf_torch.render."
        "serving, season_nerf_torch.render.loading",
        "b = bench.definitions()",
        "[bench.kind(bench.cell(w['name']).traffic) for w in "
        "b['workloads']]",
        "[bench.reader(m['name']) for m in b['per_layer']]",
        "import portbench.reference.train, portbench.reference.render"])
    assert bench.banned_modules(_loaded(code)) == []


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in (
                    "season_nerf_torch", *bench.BANNED), (name, n)
    loaded = _loaded("import portbench.reference.model, "
                     "portbench.reference.train, portbench.reference.render")
    assert not [m for m in loaded if m.split(".")[0] == "season_nerf_torch"]


def test_no_result_without_a_card():
    """On a host without CUDA the run exits with another code than 0 and
    prints nothing on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "train-bf16-default", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
