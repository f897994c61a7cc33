"""``mesh_shape`` is honoured or refused, never ignored
(``train/engine.py::mesh_refusal``).

The port has no mesh yet (``parallel/mesh.py`` is not ported), so it takes
the JAX package's ``_auto_mesh`` decisions as far as one process on one
device can honour them: an explicit ``mesh_shape`` above 1 raises in the
trainer (above the visible devices with the JAX message, the JAX
``_auto_mesh`` as the oracle; at or below them because data-parallel
training is not ported) and warns on the render side, which renders on
one device: the images equal, bit for bit, those of the same weights
under an opts.json without a mesh.  ``mesh_shape`` None or 1 changes
nothing.  A resumed run keeps the mesh_shape it is given (the field is not
resume-critical in either package), so a directory trained on a slice
resumes in the port.

About 20 s on one worker, most of it importing the JAX package."""

import json
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from season_nerf_torch import cli as t_cli
from season_nerf_torch.config import Config as TConfig
from season_nerf_torch.config import get_opts
from season_nerf_torch.data.synthetic import make_scene, scene_ray_tables
from season_nerf_torch.render import loading as t_loading
from season_nerf_torch.train.engine import Trainer, mesh_refusal
from season_nerf_tpu.config import Config as JConfig
from season_nerf_tpu.train.engine import _auto_mesh

torch.set_num_threads(1)

VIEW, SUN, T = (70.0, 30.0), (45.0, 160.0), 0.4


@pytest.fixture(scope="module")
def table():
    scene = make_scene(n_views=3, img_size=16, grid=16, seed=0)
    return scene_ray_tables(scene, testing_size=1)[0]


def _trainer(table, **kw):
    cfg = TConfig(fc_units=32, fc_layers=2, batch_size=16, n_samples=8,
                  max_train_steps=4, compute_dtype="float32", **kw)
    return Trainer(cfg, table, device="cpu")


def test_trainer_refuses_a_mesh_it_cannot_build(table):
    with pytest.raises(ValueError, match="mesh_shape=2 but only 1 device"):
        _trainer(table, mesh_shape=2)


def test_trainer_refuses_with_the_jax_message(table):
    """The JAX ``_auto_mesh`` raises for 999 devices on its 8 CPU devices;
    the port's ``Trainer`` raises the same message but for its own device
    count."""
    with pytest.raises(ValueError) as want:
        _auto_mesh(JConfig(mesh_shape=999, batch_size=999 * 4))
    cfg = TConfig(fc_units=32, fc_layers=2, n_samples=8, mesh_shape=999,
                  batch_size=999 * 4)
    with pytest.raises(ValueError) as got:
        Trainer(cfg, table, device="cpu")
    import jax
    n = len(jax.devices())
    assert str(got.value) == str(want.value).replace(
        f"only {n} device(s)", "only 1 device(s)")


def test_a_mesh_within_the_devices_is_refused_as_not_ported(monkeypatch):
    """Four visible cards (``device_count`` patched): a mesh of 2 raises in
    training, since data-parallel training is not ported; the render side
    warns and renders on one card; above 4 the JAX message again."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="data-parallel training over 2"):
        mesh_refusal(TConfig(mesh_shape=2), "cuda")
    with pytest.warns(UserWarning, match="render mesh is not ported"):
        mesh_refusal(TConfig(mesh_shape=2), "cuda", strict=False)
    with pytest.raises(ValueError, match="mesh_shape=8 but only 4 device"):
        mesh_refusal(TConfig(mesh_shape=8), "cuda")
    with pytest.warns(UserWarning, match="clamping to 4, rendering on one"):
        mesh_refusal(TConfig(mesh_shape=8), "cuda", strict=False)


@pytest.mark.parametrize("mesh_shape", [None, 1, 0])
def test_no_mesh_trains_as_before(table, mesh_shape):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr = _trainer(table, mesh_shape=mesh_shape)
    loss = tr.train_step()
    assert all(bool(torch.isfinite(v)) for v in loss.values())


def _with_mesh(src, dst, mesh_shape):
    shutil.copytree(src, dst)
    path = os.path.join(dst, "opts.json")
    with open(path) as f:
        opts = json.load(f)
    opts["mesh_shape"] = mesh_shape
    with open(path, "w") as f:
        json.dump(opts, f)
    return str(dst)


def test_a_directory_trained_on_a_slice_warns_and_renders_the_same(
        tiny_model_dir, tmp_path):
    """A JAX-written directory whose opts.json records ``mesh_shape: 8``
    (a slice) loads with a warning and renders the bytes of the one that
    records None; ``cli render`` too."""
    plain = _with_mesh(tiny_model_dir, tmp_path / "none", None)
    slice8 = _with_mesh(tiny_model_dir, tmp_path / "slice", 8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want = t_loading.load_model_dir(plain, device="cpu").renderer \
            .render_img(VIEW, SUN, T, 8, exact_shadow=True)
    with pytest.warns(UserWarning, match="mesh_shape=8 but only 1 device.*"
                                         "clamping to 1"):
        loaded = t_loading.load_model_dir(slice8, device="cpu")
    got = loaded.renderer.render_img(VIEW, SUN, T, 8, exact_shadow=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.warns(UserWarning, match="mesh_shape=8"):
        t_cli.main(["render", "--Model_Location", slice8, "--Output_Size",
                    "8", "--device", "cpu", "--Save_Name",
                    str(tmp_path / "r.png")])
    assert (tmp_path / "r.png").stat().st_size > 0


def test_cli_train_refuses_before_preparing_the_site(tmp_path, monkeypatch):
    prepared = []
    monkeypatch.setattr(t_cli, "_prepare",
                        lambda *a, **k: prepared.append(a) or None)
    with pytest.raises(ValueError, match="mesh_shape=4 but only 1 device"):
        t_cli.main(["train", "--site_name", "SYNTH_M", "--exp_name", "m",
                    "--IO_Location", str(tmp_path), "--mesh_shape", "4",
                    "--device", "cpu"])
    assert prepared == []


def test_a_resumed_slice_run_keeps_the_given_mesh_shape(tmp_path):
    """``adopt_resume_settings`` does not adopt ``mesh_shape`` (not
    resume-critical, as in the JAX package): a run recorded with
    ``mesh_shape: 8`` resumes under the command line's value, and the
    trainer then checks that value."""
    logs = tmp_path / "Logs" / "r"
    logs.mkdir(parents=True)
    JConfig(site_name="SYNTH_R", exp_name="r", mesh_shape=8,
            IO_Location=str(tmp_path)).save_json(str(logs / "opts.json"))
    (logs / "Model_5.nn").write_bytes(b"")
    argv = ["--site_name", "SYNTH_R", "--exp_name", "r", "--IO_Location",
            str(tmp_path)]
    assert get_opts(argv).mesh_shape is None
    cfg = get_opts(argv + ["--mesh_shape", "8"])
    assert cfg.mesh_shape == 8
    with pytest.raises(ValueError, match="mesh_shape=8"):
        mesh_refusal(cfg, "cpu")
