"""Reference checkpoints: ``utils/torch_convert.py`` and
``tools/convert_reference_model.py`` of the port against the JAX package's.

No reference-trained ``Final_Model.nn`` is in the repository, so the
checkpoint is made here: a seeded port ``TNeRF`` (it carries the reference
``T_NeRF``'s names and its three unused heads) with BatchNorm statistics
that are not trivial, saved by ``torch.save`` as a state dict and as a
pickled module.  Both tools convert both files: the artifacts hold the
same arrays and meta, and each package loads the other's.  A directory of
the converted artifact with an ``opts.json`` that predates
``compute_dtype``/``fast_sine`` (float32, the exact sine: how the reference
trained) renders a 16 px frame on the CPU within ``TOL[float32]`` (1e-3
max, 1e-5 mean: the two differ by the fold's re-association, ~3e-6 on
x_enc) of the JAX render.  A missing leaf and a shape mismatch raise in
both converters.

About 20 s on one worker, most of it the JAX tool's init and the JAX
render's compile."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import LEGACY_KEYS, TOL, calibrate_bn_
from season_nerf_torch.config import Config
from season_nerf_torch.models.tnerf import TNeRF as TTNeRF
from season_nerf_torch.render import loading as t_loading
from season_nerf_torch.tools import convert_reference_model as t_tool
from season_nerf_torch.train import state as t_state
from season_nerf_torch.utils import msgpack_lite
from season_nerf_torch.utils.torch_convert import (convert_state_dict,
                                                   load_reference_checkpoint)
from season_nerf_tpu.render import loading as j_loading
from season_nerf_tpu.train import state as j_state
from season_nerf_tpu.utils import torch_convert as j_convert

# the JAX package's tool, tools/convert_reference_model.py
_spec = importlib.util.spec_from_file_location(
    "jax_convert_reference_model",
    Path(__file__).resolve().parents[1] / "tools" /
    "convert_reference_model.py")
j_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(j_tool)

torch.set_num_threads(1)

WIDTH, CLASSES = 32, 2


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(state dict, {kind: checkpoint path}) of a seeded reference-named
    model, saved as a state dict and as a pickled module."""
    d = tmp_path_factory.mktemp("reference")
    torch.manual_seed(11)
    net = TTNeRF(layer_width=WIDTH, n_classes=CLASSES)
    calibrate_bn_(net.G_NeRF_net, seed=11)
    sd = net.state_dict()
    assert any(k.startswith("adjust_rho.") for k in sd)
    assert any(k.endswith("num_batches_tracked") for k in sd)
    paths = {"state_dict": str(d / "sd.nn"), "module": str(d / "module.nn")}
    torch.save(sd, paths["state_dict"])
    torch.save(net, paths["module"])
    return sd, paths


def _convert(tool, ckpt, out, monkeypatch):
    argv = ["--torch_model", ckpt, "--fc_units", str(WIDTH), "--n_classes",
            str(CLASSES), "--out", out]
    if tool is j_tool:
        monkeypatch.setattr(sys, "argv", ["convert_reference_model"] + argv)
        tool.main()
    else:
        tool.main(argv)
    return out


@pytest.fixture(scope="module")
def artifacts(reference, tmp_path_factory):
    """{(package, checkpoint kind): converted Final_Model.nn}."""
    d = tmp_path_factory.mktemp("converted")
    mp = pytest.MonkeyPatch()
    try:
        return {(name, kind): _convert(tool, path,
                                       str(d / f"{name}_{kind}.nn"), mp)
                for name, tool in (("jax", j_tool), ("port", t_tool))
                for kind, path in reference[1].items()}
    finally:
        mp.undo()


def _leaves(tree, path=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("kind", ["state_dict", "module"])
def test_both_tools_write_the_same_arrays(artifacts, kind):
    """Leaf for leaf the same names, dtypes and bytes (the unused heads
    kept, as the JAX converter keeps them; num_batches_tracked dropped),
    and the same meta but for the path each was given."""
    load = lambda p: msgpack_lite.unpackb(open(p, "rb").read())
    j, t = load(artifacts["jax", kind]), load(artifacts["port", kind])
    for part in ("params", "batch_stats"):
        jl, tl = dict(_leaves(j[part])), dict(_leaves(t[part]))
        assert sorted(jl) == sorted(tl), part
        for k in jl:
            assert np.asarray(tl[k]).dtype == np.asarray(jl[k]).dtype, k
            np.testing.assert_array_equal(tl[k], jl[k], err_msg=str(k))
    assert ("adjust_rho", "kernel") in dict(_leaves(t["params"]))
    for m in (j["meta"], t["meta"]):
        assert m.pop("converted_from").endswith(".nn")
    assert j["meta"] == t["meta"] == {"fc_units": WIDTH,
                                      "n_classes": CLASSES}


@pytest.mark.parametrize("kind", ["state_dict", "module"])
def test_each_package_loads_the_others_file(reference, artifacts, kind):
    sd = {k: v for k, v in reference[0].items()
          if not k.endswith("num_batches_tracked")}
    # the port reads the JAX tool's file: the reference's own values
    got, meta = t_state.load_model_artifact(artifacts["jax", kind])
    assert meta["n_classes"] == CLASSES
    for k, v in sd.items():
        assert torch.equal(got[k], v.float()), k
    # the JAX package reads the port tool's file: the leaves it converts
    # the reference to itself
    params, stats, _ = j_state.load_model_artifact(artifacts["port", kind])
    want_p, want_s = j_convert.convert_state_dict(sd)
    for tree, want in ((params, want_p), (stats, want_s)):
        wl = dict(_leaves(want))
        assert sorted(dict(_leaves(tree))) == sorted(wl)
        for k, v in _leaves(tree):
            np.testing.assert_array_equal(np.asarray(v), wl[k],
                                          err_msg=str(k))


def _legacy_dir(d, artifact):
    """A model directory of ``artifact`` with an opts.json written before
    ``compute_dtype``/``fast_sine`` existed: float32 with the exact sine."""
    cfg = Config(site_name="reference", fc_units=WIDTH,
                 number_low_frequency_cases=CLASSES, n_samples=16, chunk=100)
    cfg.save_json(str(d / "opts.json"))
    opts = json.loads((d / "opts.json").read_text())
    for k in LEGACY_KEYS:
        opts.pop(k)
    (d / "opts.json").write_text(json.dumps(opts))
    (d / "Final_Model.nn").write_bytes(open(artifact, "rb").read())
    return str(d)


def test_converted_directory_renders_as_jax(artifacts, tmp_path):
    d = _legacy_dir(tmp_path, artifacts["port", "module"])
    t = t_loading.load_model_dir(d, device="cpu")
    fused = t.model.G_NeRF_net.fused()
    assert fused.folded.dtype == torch.float32 and not fused.fast_sine
    j = j_loading.load_model_dir(d)
    args = ((70.0, 30.0), (45.0, 160.0), 0.4, 16)
    got, want = t.renderer.render_img(*args), j.renderer.render_img(*args)
    tol_max, tol_mean = TOL[torch.float32]
    for k in ("Col_Img", "Shadow_Mask", "Height", "PS_Sum"):
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), k)
        err = np.abs(g - w)
        assert np.nanmax(err) <= tol_max and np.nanmean(err) <= tol_mean, \
            (k, np.nanmax(err), np.nanmean(err))


def test_missing_leaf_and_shape_mismatch_raise_in_both(reference):
    sd = dict(reference[0])
    with torch.device("meta"):
        template = TTNeRF(layer_width=WIDTH, n_classes=CLASSES).state_dict()
    j_template = j_tool_template()
    # complete: both convert (the unused heads may be absent)
    no_heads = {k: v for k, v in sd.items()
                if k.split(".")[0] not in TTNeRF.UNUSED_HEADS}
    assert "adjust_rho.weight" not in convert_state_dict(no_heads, template)
    j_convert.load_reference_checkpoint(no_heads, j_template)
    missing = {k: v for k, v in sd.items()
               if k != "G_NeRF_net.fc3.linear.weight"}
    with pytest.raises(ValueError, match="missing converted leaf "
                       "G_NeRF_net.fc3.linear.weight"):
        load_reference_checkpoint(missing, template)
    with pytest.raises(AssertionError):
        j_convert.load_reference_checkpoint(missing, j_template)
    wrong = dict(sd, **{"time_layer_2.linear.weight":
                        torch.zeros(WIDTH, WIDTH + 1)})
    with pytest.raises(ValueError, match="shape mismatch at "
                       "time_layer_2.linear.weight"):
        load_reference_checkpoint(wrong, template)
    with pytest.raises(AssertionError, match="shape mismatch"):
        j_convert.load_reference_checkpoint(wrong, j_template)


def j_tool_template():
    """The JAX tool's template: ``TNeRF.init`` at WIDTH, CLASSES."""
    import jax
    import jax.numpy as jnp
    from season_nerf_tpu.models.tnerf import TNeRF
    return TNeRF(layer_width=WIDTH, n_classes=CLASSES).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 3)), jnp.zeros((2, 3)),
        jnp.zeros((2, 4)), train=False)
