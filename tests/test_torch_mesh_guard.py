"""``mesh_shape`` is honoured or refused, never ignored, as the JAX
package's ``_auto_mesh`` decides (``train/engine.py::_auto_mesh``), and
a run on a mesh of CPU ranks goes through ``cli.run_train`` end to end.

- ``_auto_mesh``'s decisions and messages against the JAX ``_auto_mesh``
  (8 virtual CPU devices there, 8 cards patched into ``torch.cuda`` here):
  an explicit mesh above the devices or over an indivisible batch raises
  (warns and clamps with ``strict=False``), the automatic one warns and
  falls back, ``None`` takes every visible card; on the CPU one device is
  visible;
- a ``Trainer`` in one process refuses a mesh of several devices (its
  ranks are processes of their own), and ``cli train`` refuses before it
  prepares the site;
- a model directory recording ``mesh_shape: 8`` renders on one CPU, with
  a warning where it is asked to take its mesh (``use_mesh``), the bytes
  of the same weights without it;
- ``cli.run_train`` on 2 gloo ranks on the CPU writes a model directory
  that the port renders, only rank 0 writing, and a run stopped at a save
  point resumes on the mesh to the weights of the run that was not
  stopped, bit for bit.

About 45 s on one worker: importing the JAX package, and three runs of 2
ranks (about 6 s each)."""

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
from season_nerf_torch.parallel.mesh import make_mesh
from season_nerf_torch.render.renderer import Renderer
from season_nerf_torch.train.engine import Trainer, _auto_mesh as t_auto_mesh
from season_nerf_torch.train.state import load_model_artifact
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


def _decision(auto, cfg, strict, *device):
    """What ``_auto_mesh`` decides: ("raises", message) or (the mesh's
    size or None, the warnings' messages)."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        try:
            mesh = auto(cfg, *device, strict=strict)
        except ValueError as e:
            return "raises", str(e)
    size = None if mesh is None else (
        mesh.size if hasattr(mesh, "size") and isinstance(mesh.size, int)
        else int(mesh.devices.size))
    return size, [str(x.message) for x in w]


# (mesh_shape, batch_size, strict): test_parallel's cases and the rest of
# the decision table
AUTO_CASES = [(8, 65, True), (999, 999 * 4, True), (999, 999 * 8, False),
              (None, 65, True), (None, 64, True), (1, 64, True),
              (4, 64, True), (3, 64, False), (None, 65, False),
              (16, 64, False), (0, 64, True)]


@pytest.mark.parametrize("mesh_shape,batch_size,strict", AUTO_CASES)
def test_auto_mesh_decides_as_the_jax_package(monkeypatch, mesh_shape,
                                              batch_size, strict):
    """Eight visible cards (``device_count`` patched) against the JAX
    package's eight CPU devices: the same mesh size (None for one device),
    the same warnings, the same messages raised."""
    import jax
    assert len(jax.devices()) == 8
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    kw = dict(mesh_shape=mesh_shape, batch_size=batch_size)
    want = _decision(_auto_mesh, JConfig(**kw), strict)
    got = _decision(t_auto_mesh, TConfig(**kw), strict, "cuda")
    assert got == want
    if got[0] not in (None, "raises"):
        mesh = t_auto_mesh(TConfig(**kw), "cuda", strict=strict)
        assert mesh.devices == [torch.device("cuda", i)
                                for i in range(got[0])]


def test_auto_mesh_on_the_cpu_sees_one_device():
    assert t_auto_mesh(TConfig(), "cpu") is None
    with pytest.raises(ValueError, match="mesh_shape=2 but only 1 device"):
        t_auto_mesh(TConfig(mesh_shape=2), "cpu")
    with pytest.warns(UserWarning, match="clamping to 1"):
        assert t_auto_mesh(TConfig(mesh_shape=2), "cpu", strict=False) is None


def test_one_process_trainer_refuses_a_mesh_of_cards(table, monkeypatch):
    """Four visible cards: ``mesh_shape`` None (every card) or 4 is a mesh
    whose ranks are processes of their own, so a ``Trainer`` built in one
    process raises before it builds anything on a card (none is reached
    here); ``mesh_shape=1`` keeps one card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for shape in (None, 4):
        with pytest.raises(ValueError, match="4-device mesh trains one "
                                             "process per device"):
            Trainer(TConfig(fc_units=32, fc_layers=2, batch_size=16,
                            n_samples=8, mesh_shape=shape), table,
                    device="cuda")
    with pytest.raises(ValueError, match="training rank's mesh"):
        Trainer(TConfig(fc_units=32, fc_layers=2, batch_size=16,
                        n_samples=8), table, device="cpu",
                mesh=make_mesh(devices=["cpu", "cpu"]))


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
    (a slice) loads on the CPU's one device: with a warning where it is
    asked for its mesh (``use_mesh``, as ``cli render`` and the service
    load), silently without (``mesh_shape`` is not read), and renders the
    bytes of the one that records None either way."""
    plain = _with_mesh(tiny_model_dir, tmp_path / "none", None)
    slice8 = _with_mesh(tiny_model_dir, tmp_path / "slice", 8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want = t_loading.load_model_dir(plain, device="cpu").renderer \
            .render_img(VIEW, SUN, T, 8, exact_shadow=True)
    with pytest.warns(UserWarning, match="mesh_shape=8 but only 1 device.*"
                                         "clamping to 1"):
        loaded = t_loading.load_model_dir(slice8, use_mesh=True,
                                          device="cpu")
    assert loaded.renderer.mesh is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        unmeshed = t_loading.load_model_dir(slice8, device="cpu")
    for r in (loaded.renderer, unmeshed.renderer):
        got = r.render_img(VIEW, SUN, T, 8, exact_shadow=True)
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
        t_auto_mesh(cfg, "cpu")


# --- a run on 2 CPU ranks through cli.run_train ------------------------------
RUN = ["--site_name", "SYNTH_MESH", "--max_train_steps", "6", "--n_saves",
       "2", "--n_samples", "8", "--batch_size", "16", "--fc_units", "32",
       "--synth_views", "3", "--synth_img_size", "16", "--synth_grid", "16",
       "--testing_size", "1", "--compute_dtype", "float32"]


def _run(tmp_path, name, train_steps=None):
    cfg = get_opts(RUN + ["--exp_name", name, "--IO_Location",
                          str(tmp_path)])
    return cfg, t_cli.run_train(cfg, train_steps=train_steps, device="cpu",
                                mesh=make_mesh(devices=["cpu", "cpu"]))


def test_cli_train_on_two_ranks_writes_a_model_dir_that_resumes(tmp_path):
    """6 steps on 2 ranks (save points 4 and 6): the model directory loads
    and renders (on the render mesh too), its ``Final_Model.nn`` holds rank
    0's last weights, and one writer wrote (one event file, each metric
    once); a run stopped
    after its save point at step 4 resumes on the mesh (every rank loads
    ``Model_4.nn``) and ends on the weights of the run not stopped, bit for
    bit (the same draws, the same reductions)."""
    cfg, run = _run(tmp_path, "whole")
    assert isinstance(run, t_cli.MeshRun) and run.step == 6
    d = cfg.logs_dir
    for name in ("Final_Model.nn", "Model_4.nn", "Model_6.nn", "opts.json",
                 "metrics.jsonl", "heartbeat", "W2C_W2L_H.npy"):
        assert os.path.exists(os.path.join(d, name)), name
    assert len([f for f in os.listdir(d) if f.startswith("events.")]) == 1
    with open(os.path.join(d, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    # each metric once (the final report repeats step 6's on purpose)
    keys = [(r["tag"], r["step"]) for r in recs if r["step"] < 6
            or r["tag"].startswith("Training/")]
    assert len(keys) == len(set(keys))
    logged = {(r["tag"], r["step"]) for r in recs}
    assert ("Testing/Mean_PSNR", 4) in logged
    assert ("Testing/Total", 6) in logged
    sd, _ = load_model_artifact(os.path.join(d, "Final_Model.nn"))
    for k, t in run.model.state_dict().items():
        if k in sd:
            assert torch.equal(sd[k], t), k
    loaded = t_loading.load_model_dir(d, device="cpu")
    out = loaded.renderer.render_img(VIEW, SUN, T, 8)
    assert np.isfinite(out["Col_Img"]).all()
    mesh_out = Renderer(loaded.model, n_samples=8, chunk=50,
                        mesh=make_mesh(devices=["cpu", "cpu"])).render_img(
                            VIEW, SUN, T, 8)
    np.testing.assert_allclose(mesh_out["Col_Img"], out["Col_Img"],
                               rtol=1e-5, atol=1e-5)

    cfg_s, first = _run(tmp_path, "split", train_steps=4)
    assert first.step == 4
    assert os.path.exists(os.path.join(cfg_s.logs_dir, "Model_4.nn"))
    _, second = _run(tmp_path, "split")
    assert second.step == 6
    for k, t in run.model.state_dict().items():
        assert torch.equal(second.model.state_dict()[k], t), k
