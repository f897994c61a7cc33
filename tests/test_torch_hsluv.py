"""HSLuv ray colours (``use_HSLuv``) in the port against the JAX package:
``rgb_to_hsluv`` and ``rgb_to_hsluv_normalized`` (with the known values
and the round trip of ``tests/test_extras.py``), the ray table built with
``use_hsluv``, its ``_hsluv`` cache crossing between the packages, the
validation render of a model trained on HSLuv targets, and one tiny
``use_HSLuv`` run of ``cli train``.

Tolerances: the conversions are the same float64 numpy arithmetic in both
packages, so they are held bit for bit; the table's colours too (the same
images through the same conversion), its geometry to 1e-6 as in
``test_torch_train_step.py``.  The validation render is float32 from the
same weights: 1e-4 (``test_torch_validation.py``'s float32 bound on the
image, through HSLuv -> sRGB, whose slope stays under ~3 here); the
ground truth converts the same float32 rows, so it is held to 1e-12.

Seconds on one worker: about 30, most of them the one ``cli train`` (its
evaluation at 8 px) and the JAX renderer's compile.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from season_nerf_torch import cli as t_cli
from season_nerf_torch.config import Config as TConfig
from season_nerf_torch.data import rays as t_rays
from season_nerf_torch.data import synthetic as t_synth
from season_nerf_torch.train.engine import Trainer as TTrainer
from season_nerf_torch.utils import hsluv as t_hsluv
from season_nerf_torch.utils.convert import state_dict_from_flax
from season_nerf_tpu.config import Config as JConfig
from season_nerf_tpu.data import rays as j_rays
from season_nerf_tpu.data import synthetic as j_synth
from season_nerf_tpu.train.engine import Trainer as JTrainer
from season_nerf_tpu.utils import hsluv as j_hsluv

torch.set_num_threads(1)

SITE = dict(n_views=4, img_size=16, grid=24, seed=5)
CFG = dict(fc_units=32, batch_size=16, n_samples=8, max_train_steps=4,
           compute_dtype="float32", fast_sine=True, n_saves=0, logs_dir="",
           use_HSLuv=True)


# --- the conversions -----------------------------------------------------------
def test_rgb_to_hsluv_matches_jax():
    rng = np.random.default_rng(0)
    rgb = np.concatenate([rng.random((500, 3)), np.eye(3), np.zeros((1, 3)),
                          np.ones((1, 3)), [[0.5, 0.5, 0.5]],
                          [[-0.1, 1.2, 0.3]]])          # clipped into [0, 1]
    np.testing.assert_array_equal(t_hsluv.rgb_to_hsluv(rgb),
                                  j_hsluv.rgb_to_hsluv(rgb))
    img = rng.random((6, 7, 3)).astype(np.float32)
    got = t_hsluv.rgb_to_hsluv_normalized(img)
    np.testing.assert_array_equal(got, j_hsluv.rgb_to_hsluv_normalized(img))
    assert got.shape == (6, 7, 3) and (got >= 0).all() and (got <= 1).all()


def test_hsluv_known_values_and_round_trip():
    w = t_hsluv.rgb_to_hsluv([[1.0, 1.0, 1.0]])[0]
    assert w[2] > 99.99 and w[1] < 1e-4
    assert t_hsluv.rgb_to_hsluv([[0.0, 0.0, 0.0]])[0][2] < 1e-6
    # pure red: hue ~12.2 deg, S ~100, L ~53.2 (published HSLuv values)
    np.testing.assert_allclose(t_hsluv.rgb_to_hsluv([[1.0, 0.0, 0.0]])[0],
                               [12.177, 100.0, 53.237], atol=0.05)
    rgb = np.random.default_rng(1).random((64, 3))
    np.testing.assert_allclose(
        t_hsluv.hsluv_to_rgb(t_hsluv.rgb_to_hsluv(rgb)), rgb, atol=1e-6)
    np.testing.assert_allclose(t_hsluv.hsluv_normalized_to_rgb(
        t_hsluv.rgb_to_hsluv_normalized(rgb)), rgb, atol=1e-6)


# --- the ray table ----------------------------------------------------------------
@pytest.fixture(scope="module")
def scenes():
    return j_synth.make_scene(**SITE), t_synth.make_scene(**SITE)


def test_hsluv_ray_table_matches_jax(scenes):
    js, ts = scenes
    want = j_rays.build_ray_table(js.cameras, js.images, use_hsluv=True)
    got = t_rays.build_ray_table(ts.cameras, ts.images, use_hsluv=True)
    np.testing.assert_array_equal(got.img_ids, want.img_ids)
    np.testing.assert_array_equal(got.rows[:, 19:22], want.rows[:, 19:22])
    np.testing.assert_allclose(got.rows, want.rows, rtol=0, atol=1e-6)
    rgb = t_rays.build_ray_table(ts.cameras, ts.images)
    np.testing.assert_array_equal(got.rows[:, :19], rgb.rows[:, :19])
    assert not np.allclose(got.rows[:, 19:22], rgb.rows[:, 19:22],
                           atol=0.05)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_hsluv_cache_crosses_between_the_packages(scenes, tmp_path, writer):
    """A table cached under its ``_hsluv`` name by one package loads in the
    other; a cache hit is returned as it was saved (no second
    conversion)."""
    js, ts = scenes
    cfg = TConfig(use_HSLuv=True, img_training_downscale=1,
                  img_validation_downscale=1)
    path = t_rays.cache_path(str(tmp_path), cfg, [1] * len(ts.cameras))
    assert "_hsluv" in os.path.basename(path)
    if writer == "port":
        built = t_rays.build_ray_table(ts.cameras, ts.images,
                                       use_hsluv=True, cache_path=path)
        loaded = j_rays.RayTable.load(path)
        again = t_rays.build_ray_table(ts.cameras, ts.images,
                                       use_hsluv=True, cache_path=path)
    else:
        built = j_rays.build_ray_table(js.cameras, js.images,
                                       use_hsluv=True, cache_path=path)
        loaded = t_rays.RayTable.load(path)
        again = t_rays.build_ray_table(ts.cameras, ts.images,
                                       use_hsluv=True, cache_path=path)
    for table in (loaded, again):
        np.testing.assert_array_equal(table.rows, built.rows)
        np.testing.assert_array_equal(table.img_ids, built.img_ids)
        assert list(table.img_names) == list(built.img_names)


# --- training and validation ----------------------------------------------------
def test_validation_render_of_an_hsluv_model_matches_jax(scenes):
    """From the same weights, ``render_table_image`` of a model trained on
    HSLuv targets: both packages return sRGB renders and sRGB ground
    truth, and the port's PSNR report equals JAX's."""
    js, ts = scenes
    jt, jv = (j_rays.build_ray_table(js.cameras, js.images, use_hsluv=True)
              .split(ids) for ids in (np.arange(3), np.array([3])))
    tt, tv = (t_rays.build_ray_table(ts.cameras, ts.images, use_hsluv=True)
              .split(ids) for ids in (np.arange(3), np.array([3])))
    jtr = JTrainer(JConfig(**CFG, mesh_shape=1), jt, jv)
    jtr._enter_phase(jtr.phases[0])
    v = jax.device_get(jtr.variables_template)
    ttr = TTrainer(TConfig(**CFG), tt, tv, device="cpu")
    ttr.model.load_weights(state_dict_from_flax(v["params"],
                                                v["batch_stats"]))
    want = jtr.render_table_image(jv, 0)
    got = ttr.render_table_image(tv, 0)
    seen = want[3]
    np.testing.assert_array_equal(got[3], seen)
    assert seen.sum() > 100
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)
    rows_rgb = t_hsluv.hsluv_normalized_to_rgb(tv.rows[:, 19:22])
    ij = tv.rows[:, 0:2].astype(int)
    np.testing.assert_allclose(got[1][ij[:, 0], ij[:, 1]], rows_rgb,
                               atol=1e-6)
    np.testing.assert_allclose(got[0][seen], want[0][seen], rtol=0,
                               atol=1e-4)
    assert got[0].min() >= 0.0 and got[0].max() <= 1.0
    rep_t, rep_j = ttr.validation_report(), jtr.validation_report()
    np.testing.assert_allclose(rep_t["Mean_PSNR"], rep_j["Mean_PSNR"],
                               rtol=1e-5)


def test_cli_train_with_hsluv(tmp_path, monkeypatch):
    """``cli train --use_HSLuv`` on a synthetic site: the rows it trains on
    are HSLuv, its save point's validation render and the model directory's
    renders are sRGB."""
    from season_nerf_torch.render.loading import load_model_dir
    monkeypatch.setattr(t_cli, "run_test", functools.partial(
        t_cli.run_test, eval_img_size=(8, 8), eval_season_size=(8, 8)))
    rc = t_cli.main(["train", "--site_name", "SYNTH_HSLUV", "--exp_name",
                     "h", "--IO_Location", str(tmp_path),
                     "--max_train_steps", "4", "--n_samples", "8",
                     "--batch_size", "16", "--fc_units", "32",
                     "--synth_views", "3", "--synth_img_size", "16",
                     "--synth_grid", "16", "--testing_size", "1",
                     "--n_saves", "1", "--use_HSLuv", "--device", "cpu"])
    assert rc == 0
    d = tmp_path / "Logs" / "h"
    opts = json.loads((d / "opts.json").read_text())
    assert opts["use_HSLuv"] is True
    psnr = [json.loads(l) for l in open(d / "metrics.jsonl")
            if json.loads(l)["tag"] == "Testing/Mean_PSNR"]
    assert psnr and all(np.isfinite(p["value"]) for p in psnr)
    loaded = load_model_dir(str(d), device="cpu")
    assert loaded.renderer.use_hsluv
    img = loaded.renderer.render_img((70.0, 30.0), (45.0, 160.0), 0.4,
                                     8)["Col_Img"]
    assert np.isfinite(img).all() and img.min() >= 0 and img.max() <= 1
    assert (d / "Output" / "Image_scores.txt").exists()
