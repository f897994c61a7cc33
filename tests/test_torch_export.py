"""The render export: K3 as the operator ``season_nerf::trunk_apply`` and
``season_nerf_torch/tools/export_render.py`` against the JAX tool.

- ``torch.library.opcheck`` on the operator (schema, fake, autograd
  registration, AOT dispatch) for both fold dtypes and both sines.
- The exported program calls the operator once a chunk (exact) or twice
  (fast: the density-only pass and the full one): the live
  ``render_chunk_outputs`` reaches K3 only through it.
- The port's program, saved and loaded in a clean process that imports
  ``season_nerf_torch`` and nothing of its tools, against the live chunk
  at the JAX tool's ``--check`` tolerance, 2e-5 (the same aten ops on the
  same weights: equal in fact).
- The port's program against the JAX tool's program on the same weights
  (a JAX-written model directory, read through the port's weight bridge)
  and rays, exact and fast, at ``tests/test_torch_render.py``'s
  tolerances: f32 1e-4 (the fold's re-association, ~3e-6 on x_enc) and
  bf16 2e-2 (the packages round to bf16 in other places), a quarter of
  each on the mean.
- The manifest has the JAX manifest's keys, plus the device and how to
  load it; ``python -m season_nerf_torch.tools.export_render <dir> --check
  --device cpu`` passes.

Width 32, 8 samples, chunk 64.  About 45 s on one worker, most of it the
JAX exports' compiles and the clean process's imports."""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from season_nerf_torch.ops import fused_trunk as ft
from season_nerf_torch.render import loading as t_loading
from season_nerf_torch.tools import export_render as t_export
from season_nerf_tpu.config import Config
from season_nerf_tpu.models.tnerf import model_from_config
from season_nerf_tpu.render import loading as j_loading
from season_nerf_tpu.train.state import save_model_artifact

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CHUNK, SAMPLES, FAST = 64, 8, (8, 8)
# max abs of every output; a quarter of it on the mean
TOL = {"f32_dir": 1e-4, "bf16_dir": 2e-2}


def _jax_tool():
    sys.path.insert(0, str(ROOT))
    try:
        from tools import export_render
    finally:
        sys.path.remove(str(ROOT))
    return export_render


@functools.lru_cache(maxsize=None)
def _jax_program(model_dir, fast):
    """The JAX tool's export of ``model_dir`` -> (blob, manifest)."""
    jl = j_loading.load_model_dir(model_dir)
    return _jax_tool().export_render(jl.model, jl.variables, SAMPLES, CHUNK,
                                     fast_render=fast)


def _model_dir(tmp_path_factory, name, **kw):
    """A JAX-written model directory with BatchNorm statistics from one
    train-mode pass."""
    d = tmp_path_factory.mktemp(name)
    cfg = Config(site_name=name, n_samples=SAMPLES, chunk=CHUNK,
                 fc_units=32, **kw)
    cfg.save_json(str(d / "opts.json"))
    model = model_from_config(cfg)
    v = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(5), jnp.zeros((2, 3)), jnp.zeros((2, 3)),
        jnp.zeros((2, 4)), train=False)
    pts = jax.random.uniform(jax.random.PRNGKey(6), (512, 3), minval=-1,
                             maxval=1)
    _, upd = jax.jit(lambda v, *a: model.apply(
        v, *a, train=True, mutable=["batch_stats"]))(
        v, pts, jnp.ones((512, 3)) / 3 ** 0.5, jnp.ones((512, 4)))
    save_model_artifact(str(d / "Final_Model.nn"), v["params"],
                        upd["batch_stats"], meta={})
    return str(d)


@pytest.fixture(scope="module")
def f32_dir(tmp_path_factory):
    return _model_dir(tmp_path_factory, "export_f32", fc_layers=4,
                      compute_dtype="float32", fast_sine=False)


@pytest.fixture(scope="module")
def bf16_dir(tmp_path_factory):
    return _model_dir(tmp_path_factory, "export_bf16", fc_layers=2,
                      compute_dtype="bfloat16", fast_sine=True)


@pytest.fixture(scope="module")
def rays():
    return t_export.check_rays(CHUNK)


@pytest.fixture(scope="module")
def programs(bf16_dir, tmp_path_factory):
    """The bf16 directory's programs, exact and fast, saved; the live
    chunk outputs on the check rays beside them."""
    d = tmp_path_factory.mktemp("programs")
    model = t_loading.load_model_dir(bf16_dir, device="cpu").model
    tr = [torch.from_numpy(a) for a in t_export.check_rays(CHUNK)]
    out = {}
    for name, fast in (("exact", None), ("fast", FAST)):
        blob, manifest = t_export.export_render(model, SAMPLES, CHUNK,
                                                fast_render=fast)
        (d / f"{name}.pt2").write_bytes(blob)
        with torch.no_grad():
            want = t_export.build_render_fn(model, SAMPLES, False, fast)(*tr)
        np.savez(d / f"{name}.npz",
                 **{k: v.numpy() for k, v in want.items()})
        out[name] = manifest
    return d, out


def _op_args(dtype, fast_sine):
    from season_nerf_torch.models.tnerf import TNeRF
    torch.manual_seed(0)
    g = TNeRF(layer_width=32, n_layers=4).eval().G_NeRF_net
    f = ft.fold_trunk(g, dtype)
    pe = ft.encode_points(torch.rand(37, 3) * 2 - 1)
    return f, (pe, f.weights, f.biases, f.ring_weights,
               f.inputs.index("h+pe"), 32, f.width_pad, f.out_features,
               fast_sine)


@pytest.mark.parametrize("fast_sine", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_opcheck(dtype, fast_sine):
    folded, args = _op_args(dtype, fast_sine)
    torch.library.opcheck(ft.trunk_op, args)
    want = ft.trunk_apply_reference(args[0], folded, fast_sine).numpy()
    np.testing.assert_array_equal(ft.trunk_op(*args).numpy(), want)
    np.testing.assert_array_equal(
        ft.trunk_apply(args[0], folded, fast_sine).numpy(), want)


@pytest.mark.parametrize("fast", [None, FAST], ids=["exact", "fast"])
def test_the_program_reaches_k3_through_the_operator(bf16_dir, fast):
    model = t_loading.load_model_dir(bf16_dir, device="cpu").model
    fn = t_export.build_render_fn(model, SAMPLES, False, fast)
    model.G_NeRF_net.fused()
    args = tuple(torch.zeros(CHUNK, k) for k in (3, 3, 3, 4))
    with torch.no_grad():
        ep = torch.export.export(fn, args)
    calls = [n for n in ep.graph.nodes
             if n.target is torch.ops.season_nerf.trunk_apply.default]
    assert len(calls) == (2 if fast else 1)
    launches = ft.trunk_apply.launches
    with torch.no_grad():
        ep.module()(*args)
    assert ft.trunk_apply.launches == launches      # no kernel on the CPU


CLEAN = """
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import season_nerf_torch                 # registers the operator
rays = [torch.from_numpy(a) for a in np.load("rays.npz").values()]
for name in ("exact", "fast"):
    program = torch.export.load(name + ".pt2").module()
    with torch.no_grad():
        got = program(*rays)
    want = np.load(name + ".npz")
    assert sorted(got) == sorted(want.files), (sorted(got), want.files)
    for k in want.files:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2e-5,
                                   atol=2e-5, err_msg=k)
bad = sorted(m for m in sys.modules if m.startswith(("jax", "tools",
             "season_nerf_torch.tools", "season_nerf_tpu")))
assert not bad, bad
print("LOADED")
"""


def test_saved_program_runs_in_a_clean_process(programs):
    d, _ = programs
    np.savez(d / "rays.npz", *t_export.check_rays(CHUNK))
    res = subprocess.run([sys.executable, "-I", "-c", CLEAN, str(ROOT)],
                         cwd=d, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith("LOADED")


def test_manifest_has_the_jax_keys(programs, bf16_dir):
    _, manifests = programs
    _, want = _jax_program(bf16_dir, FAST)
    got = manifests["fast"]
    assert set(got) - set(want) == {"device", "load"}
    assert set(want) <= set(got)
    assert got["format"] == "torch.export ExportedProgram"
    assert got["device"] == "cpu" and "import season_nerf_torch" in got["load"]
    for k in set(want) - {"format"}:
        assert got[k] == want[k], k
    assert manifests["exact"]["fast_render"] is None


@pytest.mark.parametrize("fast", [None, FAST], ids=["exact", "fast"])
@pytest.mark.parametrize("dir_name", sorted(TOL))
def test_port_program_matches_the_jax_program(request, dir_name, fast, rays,
                                              tmp_path):
    d = request.getfixturevalue(dir_name)
    tol = TOL[dir_name]
    blob, _ = _jax_program(d, fast)
    from jax import export as jax_export
    want = jax_export.deserialize(blob).call(*rays)
    model = t_loading.load_model_dir(d, device="cpu").model
    blob, _ = t_export.export_render(model, SAMPLES, CHUNK, fast_render=fast)
    (tmp_path / "r.pt2").write_bytes(blob)
    with torch.no_grad():
        got = t_export.load_exported(str(tmp_path / "r.pt2"))(
            *map(torch.from_numpy, rays))
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy().astype(np.float64)
        w = np.asarray(want[k], np.float64)
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=k)
        assert np.mean(np.abs(g - w)) <= tol / 4, k


def test_export_render_cli_check(f32_dir, tmp_path):
    out = t_export.main([f32_dir, "-o", str(tmp_path / "r.pt2"), "--check",
                         "--device", "cpu", "--fast_render", "8", "8"])
    assert out == str(tmp_path / "r.pt2")
    manifest = json.loads((tmp_path / "r.pt2.json").read_text())
    assert manifest["chunk"] == CHUNK and manifest["fast_render"] == [8, 8]


def test_a_model_k3_cannot_take_is_refused_before_export(tmp_path):
    """On the card, ``load_model_dir`` refuses a padded width above 1024
    before it reads a weight (``fused_trunk.k3_refusal``), so nothing is
    exported; the refusal needs no card."""
    Config(site_name="wide", fc_units=1152).save_json(
        str(tmp_path / "opts.json"))
    with pytest.raises(ValueError, match="trunk kernel \\(K3\\) takes padded "
                                         "widths up to 1024"):
        t_export.main([str(tmp_path), "--device", "cuda"])
    assert not (tmp_path / "render.pt2").exists()
