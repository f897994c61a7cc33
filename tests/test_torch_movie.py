"""Movies: ``geometry/spline.py``, ``render/movie.py`` and
``tools/make_movie.py`` of the port against the JAX package.

``Spline3`` and ``MovieScript.sample`` are float64 host arithmetic on
scipy's ``CubicSpline``: bit-equal to the JAX modules, in both script modes
(by view direction and 6-DoF), with the same error for a mixed script.  A
3-frame 8 px movie of the same model directory, rendered by both packages
on the CPU in both modes, is held within 2 uint8 levels in float32 (the two
differ by the fold's re-association, ~3e-6 on x_enc: at most a rounding
across a level boundary) and 6 levels in bf16 (the packages round to bf16
in other places; ``tests/test_torch_render.py`` holds bf16 images to 2e-2,
5.1 levels).  Frames with ``pipeline=2`` are the bytes of ``pipeline=1``.
``export_film`` writes a GIF, and an ``.mp4`` path as the GIF beside it
(what the JAX function writes without an ffmpeg backend), read back by
imageio as the format's oracle.  ``make_movie`` runs with the JAX tool's
flags.

About 25 s on one worker, most of it the JAX renders' compiles."""

import jax
import jax.numpy as jnp
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from season_nerf_torch.geometry.spline import Spline3 as TSpline3
from season_nerf_torch.render import loading as t_loading
from season_nerf_torch.render import movie as t_movie
from season_nerf_torch.tools import make_movie as t_make_movie
from season_nerf_tpu.config import Config
from season_nerf_tpu.geometry.spline import Spline3 as JSpline3
from season_nerf_tpu.models.tnerf import model_from_config
from season_nerf_tpu.render import loading as j_loading
from season_nerf_tpu.render import movie as j_movie
from season_nerf_tpu.train.state import save_model_artifact

torch.set_num_threads(1)


def _scripts(movie):
    """The same two scripts in ``movie``'s classes: the default orbit
    (by view direction) and a 6-DoF camera pass."""
    orbit = movie.MovieScript()
    for frac in (0.0, 0.25, 0.5, 0.75, 1.0):
        orbit.add((80 - 15 * abs(frac - 0.5) * 2, 360 * frac),
                  (40 + 25 * (0.5 - abs(frac - 0.5)) * 2, 180), frac)
    pose = movie.MovieScript()
    pose.add(None, (50.0, 150.0), 0.1, cam_pose=(0.2, -1.5, 0.6, 20, 80, 50))
    pose.add(None, (60.0, 180.0), 0.4, cam_pose=(0.0, -1.4, 0.8, 30, 90, 45))
    pose.add(None, (45.0, 210.0), 0.9, cam_pose=(-0.2, -1.5, 0.6, 20, 100,
                                                  50))
    return {"orbit": orbit, "six_dof": pose}


def test_spline_is_bit_equal():
    pts = np.random.default_rng(0).normal(size=(6, 5)) * [30, 90, 20, 50, 1]
    j, t = JSpline3(pts), TSpline3(pts)
    assert t.total_length == j.total_length
    q = np.concatenate([np.linspace(-0.1, 1.1, 97), [0.0, 0.5, 1.0]])
    for fn in ("at", "at_arc", "derivative"):
        np.testing.assert_array_equal(getattr(t, fn)(q), getattr(j, fn)(q),
                                      err_msg=fn)
    line = np.array([0.0, 1.0, 4.0])            # one channel
    np.testing.assert_array_equal(TSpline3(line).at_arc(q),
                                  JSpline3(line).at_arc(q))


@pytest.mark.parametrize("mode", ["orbit", "six_dof"])
def test_script_sample_is_bit_equal(mode):
    j, t = _scripts(j_movie)[mode], _scripts(t_movie)[mode]
    assert t.six_dof == j.six_dof == (mode == "six_dof")
    for n in (1, 7, 30):
        assert [vars(k) for k in t.sample(n)] == [vars(k)
                                                  for k in j.sample(n)]


def test_mixed_script_raises_in_both():
    for movie in (j_movie, t_movie):
        s = movie.MovieScript().add((80, 0), (40, 180), 0.0).add(
            None, (40, 180), 0.5, cam_pose=(0, -1.5, 0.6, 20, 80, 50))
        with pytest.raises(ValueError, match="mixed script"):
            s.sample(3)


@pytest.fixture(scope="module")
def f32_model_dir(tmp_path_factory):
    """A JAX-written float32 (exact sine) model directory, width 48."""
    d = tmp_path_factory.mktemp("movie_f32")
    cfg = Config(site_name="movie", fc_units=48, fc_layers=4, n_samples=12,
                 chunk=50, compute_dtype="float32", fast_sine=False)
    cfg.save_json(str(d / "opts.json"))
    v = model_from_config(cfg).init(jax.random.PRNGKey(5), jnp.zeros((2, 3)),
                                    jnp.zeros((2, 3)), jnp.zeros((2, 4)),
                                    train=False)
    save_model_artifact(str(d / "Final_Model.nn"), v["params"],
                        v.get("batch_stats", {}), meta={})
    return str(d)


# model directory fixture -> uint8 levels a frame's pixel may differ by
LEVELS = {"f32_model_dir": 2, "tiny_model_dir": 6}


@pytest.fixture(scope="module", params=sorted(LEVELS))
def movie_renderers(request):
    d = request.getfixturevalue(request.param)
    return (j_loading.load_model_dir(d).renderer,
            t_loading.load_model_dir(d, device="cpu").renderer,
            LEVELS[request.param])


@pytest.mark.parametrize("mode", ["orbit", "six_dof"])
def test_movie_frames_match_jax(movie_renderers, mode):
    jr, tr, levels = movie_renderers
    want = j_movie.render_movie(jr, _scripts(j_movie)[mode], 3, 8,
                                pipeline=1)
    got = t_movie.render_movie(tr, _scripts(t_movie)[mode], 3, 8,
                               pipeline=1)
    assert got.shape == want.shape == (3, 8, 8, 3)
    assert got.dtype == want.dtype == np.uint8
    assert want.std() > 0                       # frames that show something
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= levels, diff.max()


@pytest.mark.parametrize("mode", ["orbit", "six_dof"])
def test_pipelined_frames_are_the_same_bytes(f32_model_dir, mode):
    r = t_loading.load_model_dir(f32_model_dir, device="cpu").renderer
    one = t_movie.render_movie(r, _scripts(t_movie)[mode], 4, 8, pipeline=1)
    two = t_movie.render_movie(r, _scripts(t_movie)[mode], 4, 8, pipeline=2)
    assert np.array_equal(one, two)


@pytest.mark.parametrize("name", ["film.gif", "film.mp4"])
def test_export_film_writes_a_gif(tmp_path, name):
    frames = np.random.default_rng(1).integers(0, 256, (3, 8, 8, 3),
                                               dtype=np.uint8)
    path = t_movie.export_film(frames, str(tmp_path / "sub" / name), fps=12)
    assert path == str(tmp_path / "sub" / "film.gif")
    back = np.stack([f[..., :3] for f in imageio.mimread(path)])
    np.testing.assert_array_equal(back, frames)   # 64 colours: exact
    # 1/12 s a frame: 8 hundredths, as the JAX writer stores 1000/12 ms
    assert imageio.get_reader(path).get_meta_data()["duration"] == 80


def test_make_movie_tool(f32_model_dir, tmp_path):
    out = t_make_movie.main(["--Model_Location", f32_model_dir, "--frames",
                             "3", "--size", "8", "--out",
                             str(tmp_path / "m.mp4"), "--keyframe",
                             "80,0,40,180,0", "--keyframe",
                             "70,90,50,180,0.5", "--device", "cpu"])
    assert out == str(tmp_path / "m.gif")
    frames = np.stack([f[..., :3] for f in imageio.mimread(out)])
    assert frames.shape == (3, 8, 8, 3)
    # the default script is the JAX tool's orbit
    assert [vars(k) for k in t_make_movie.default_script().sample(5)] == \
        [vars(k) for k in _scripts(j_movie)["orbit"].sample(5)]
