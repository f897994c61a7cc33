"""The port's claim checks and overview figures against the JAX package's,
on the CPU: ``eval/shadow_eval.py``, ``eval/season_eval.py``,
``eval/summary_images.py``, ``eval/pairwise_metrics.py`` and
``eval/phase_congruency.py``.  The same numpy inputs, made from a seed, go
through both; the network carries its weights across by
``state_dict_from_flax`` (float32, polynomial sine, width 32, four layers,
BatchNorm statistics from a train-mode pass), over a synthetic site of 4
views of 24 px.

Tolerances, each with its reason (float32: the fold re-associates the
trunk, ~3e-6 on x_enc):
- ``eval_shadow_angles``: the exact transmittance within 3e-5 (the
  density head is linear in x_enc, but a low sun's ray is long: at 5 deg
  of elevation a sample's step is up to 2.9 cube units, so the optical
  depth sums the density's ~3e-6 difference several times over; measured
  1.04e-5); the learned visibility within 1e-4,
  as the renders: the solar branch's first sine layer (omega_0 = 30)
  amplifies the trunk's difference (measured up to 6.2e-5 at low suns);
  the sky colour within 1e-6 (no trunk on its path);
- ``shadow_analysis``: equal on the same arrays (the same numpy);
- ``test_shadow_points``: its arrays as ``eval_shadow_angles``; its
  statistics are thresholded at 0.5, so a sample may be classed apart only
  where the JAX value lies within its array's tolerance of 0.5 (such
  samples are counted), and without one the statistics agree to 1e-5;
- ``advanced_solar_sweep``: the same confusion counts wherever no pixel
  of either mask lies within 1e-4 of the threshold (the rows' shared
  keys), and the CSV written with its header and one row a combination;
- ``full_eval_seasons``: renders within 1e-4 (as ``test_torch_render``),
  ``Time_Class`` within 1e-6 (the class branch has no trunk), the walk
  points equal;
- ``season_stability``: the EM matrices within 2e-5 relative, Sinkhorn
  (float32 logsumexps in other orders) and exact (the same LP on
  signatures of renders 1e-5 apart);
- ``prototype_baseline_em``: equal (the same float64 signatures and LP);
- ``best_time_match``: the same time, the distances within 2e-5
  relative;
- the figures: decoded (PIL, the oracle) to the panel layout, the
  cameras' dots in their colours, ``season_sun_grid``'s panels within
  1/255 + 1e-4 of the JAX renders (8-bit PNG);
- the pairwise metrics on a seeded ``[2, 3, 16, 16, 3]`` stack within
  1e-5 (MS-SSIM at 32 x 32: at 16 its last scale has one pixel and is
  NaN in both), PSNR within 1e-4 dB, ``fsim`` and ``phase_congruency``
  within 1e-4; on the diagonal (an image against itself) SAM takes the
  arccos of a cosine 1 up to rounding, whose slope is unbounded there,
  so within 1e-4, and SRE (1e-10 clamped) within 1e-6 relative.
About 30 s on one worker, most of it the JAX package's compiles.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from season_nerf_torch.config import Config as TConfig
from season_nerf_torch.data import synthetic as t_synth
from season_nerf_torch.eval import pairwise_metrics as t_pm
from season_nerf_torch.eval import season_eval as t_season
from season_nerf_torch.eval import shadow_eval as t_shadow
from season_nerf_torch.eval import summary_images as t_summary
from season_nerf_torch.eval.phase_congruency import (
    phase_congruency as t_pc)
from season_nerf_torch.models.tnerf import model_from_config as t_model
from season_nerf_torch.render.renderer import Renderer as TRenderer
from season_nerf_torch.utils.convert import state_dict_from_flax
from season_nerf_tpu.config import Config as JConfig
from season_nerf_tpu.data import synthetic as j_synth
from season_nerf_tpu.eval import pairwise_metrics as j_pm
from season_nerf_tpu.eval import season_eval as j_season
from season_nerf_tpu.eval import shadow_eval as j_shadow
from season_nerf_tpu.eval import summary_images as j_summary
from season_nerf_tpu.eval.phase_congruency import (
    phase_congruency as j_pc)
from season_nerf_tpu.models.tnerf import model_from_config as j_model
from season_nerf_tpu.render.renderer import Renderer as JRenderer

torch.set_num_threads(1)

SITE = dict(n_views=4, img_size=24, grid=24, seed=7)
MODEL = dict(fc_units=32, fc_layers=4, n_samples=8, compute_dtype="float32",
             fast_sine=True)
TEST_IDX = [1, 3]
EXACT_TOL = 3e-5
EST_TOL = 1e-4
SKY_TOL = 1e-6
IMG_TOL = 1e-4
EM_RTOL = 2e-5
SEASON = dict(n_sun=2, n_view=2, n_time=2)
SEASON_SIZE = (8, 8)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables, the port's model in eval mode)."""
    jm = j_model(JConfig(**MODEL))
    rng = np.random.default_rng(5)
    pts = jnp.asarray(rng.uniform(-1, 1, (256, 3)), jnp.float32)
    sun = jnp.asarray(rng.normal(size=(256, 3)), jnp.float32)
    t4 = jnp.asarray(rng.uniform(-1, 1, (256, 4)), jnp.float32)
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(13), pts[:2], sun[:2], t4[:2], train=False)
    _, upd = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=True, mutable=["batch_stats"]))(v, pts, sun, t4)
    jv = {"params": v["params"], "batch_stats": upd["batch_stats"]}
    tm = t_model(TConfig(**MODEL)).load_weights(state_dict_from_flax(
        *jax.device_get((jv["params"], jv["batch_stats"])))).eval()
    return jm, jv, tm


@pytest.fixture(scope="module")
def renderers(pair):
    jm, jv, tm = pair
    return (JRenderer(jm, jv, n_samples=8, chunk=64),
            TRenderer(tm, n_samples=8, chunk=64))


@pytest.fixture(scope="module")
def cams():
    return (j_synth.make_scene(**SITE).cameras,
            t_synth.make_scene(**SITE).cameras)


# --- eval/shadow_eval.py -----------------------------------------------------
def _ground(n):
    return np.stack(np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                                indexing="ij"), -1).reshape(-1, 2)


def test_eval_shadow_angles_matches_jax(pair):
    jm, jv, tm = pair
    angles = np.array([[30.0, 120.0], [62.5, 200.0], [85.0, 10.0]])
    ground = _ground(5)
    want = j_shadow.eval_shadow_angles(jm, jv, angles, ground, 8)
    got = t_shadow.eval_shadow_angles(tm, angles, ground, 8)
    for g, w, tol in zip(got, want, (EXACT_TOL, EST_TOL, SKY_TOL)):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    # no angle, no rows
    empty = t_shadow.eval_shadow_angles(tm, np.zeros((0, 2)), ground, 8)
    assert [a.shape for a in empty] == [(0, 25, 8), (0, 25, 8), (0, 3)]


def test_shadow_analysis_equals_jax():
    rng = np.random.default_rng(1)
    exact = rng.uniform(size=(3, 10, 6)).astype(np.float32)
    est = np.clip(exact + rng.normal(0, 0.3, exact.shape), 0, 1).astype(
        np.float32)
    for a, b in ((exact, est), (exact, exact), (np.ones_like(exact), est)):
        got, want = t_shadow.shadow_analysis(a, b), \
            j_shadow.shadow_analysis(a, b)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k] or (np.isnan(got[k])
                                         and np.isnan(want[k])), k


def test_test_shadow_points_matches_jax(pair, cams):
    jm, jv, tm = pair
    j_cams, t_cams = cams
    split = lambda cs: ([c for i, c in enumerate(cs) if i not in TEST_IDX],
                        [cs[i] for i in TEST_IDX])
    kw = dict(n_samples=8, points_in_space=4, points_across_angles=3)
    want = j_shadow.test_shadow_points(jm, jv, *split(j_cams), **kw)
    got = t_shadow.test_shadow_points(tm, *split(t_cams), **kw)
    np.testing.assert_array_equal(got["Ground_Points"], want["Ground_Points"])
    assert got["Sun_El_Az"].keys() == want["Sun_El_Az"].keys()
    for k, v in want["Sun_El_Az"].items():
        np.testing.assert_array_equal(got["Sun_El_Az"][k], v)
    assert got["Results"].keys() == want["Results"].keys() \
        == got["Stats"].keys()
    flips = 0
    for name, r_w in want["Results"].items():
        r_g = got["Results"][name]
        tols = {"Exact_Vis": EXACT_TOL, "Est_Vis": EST_TOL,
                "Sky_Col": SKY_TOL}
        for key, tol in tols.items():
            np.testing.assert_allclose(r_g[key], r_w[key], rtol=0, atol=tol,
                                       err_msg=f"{name} {key}")
        apart = np.zeros(r_w["Exact_Vis"].shape, bool)
        for key in ("Exact_Vis", "Est_Vis"):
            diff = (r_g[key] > 0.5) != (r_w[key] > 0.5)
            assert np.all(np.abs(r_w[key][diff] - 0.5) <= tols[key]), name
            apart |= diff
        flips += int(apart.sum())
        if not apart.any():
            for k, v in want["Stats"][name].items():
                g = got["Stats"][name][k]
                assert abs(g - v) <= 1e-5 or (np.isnan(g) and np.isnan(v)), \
                    (name, k)
    assert flips <= 2, f"{flips} samples classed apart"


def test_advanced_solar_sweep_matches_jax(renderers, tmp_path):
    j_r, t_r = renderers
    views = np.array([[70.0, 30.0]])
    suns = np.array([[40.0, 150.0], [65.0, 220.0]])
    path = tmp_path / "sweep" / "solar.csv"
    want = j_shadow.advanced_solar_sweep(j_r, views, suns, out_size=(8, 8))
    got = t_shadow.advanced_solar_sweep(t_r, views, suns, out_size=(8, 8),
                                        csv_path=str(path))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            assert g[k] == v or (np.isnan(g[k]) and np.isnan(v)), k
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 and list(rows[0]) == list(got[0])
    assert float(rows[1]["sun_az"]) == 220.0


# --- eval/season_eval.py -----------------------------------------------------
@pytest.fixture(scope="module")
def walks(renderers, cams):
    (j_r, t_r), (j_cams, t_cams) = renderers, cams
    return (j_season.full_eval_seasons(j_r, j_cams, SEASON_SIZE, **SEASON),
            t_season.full_eval_seasons(t_r, t_cams, SEASON_SIZE, **SEASON))


def test_full_eval_seasons_matches_jax(walks):
    want, got = walks
    for k, v in want["Input_Vals"].items():
        np.testing.assert_array_equal(got["Input_Vals"][k], v)
    assert got["Imgs"].shape == want["Imgs"].shape
    assert want["Imgs"].shape[:2] == (2, 2)
    for idx in np.ndindex(*want["Imgs"].shape):
        g, w = got["Imgs"][idx], want["Imgs"][idx]
        assert g.shape == (8, 8, 3)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(np.nan_to_num(g), np.nan_to_num(w),
                                   rtol=0, atol=IMG_TOL, err_msg=str(idx))
        np.testing.assert_allclose(got["Time_Class"][idx],
                                   want["Time_Class"][idx], rtol=0, atol=1e-6)


@pytest.mark.parametrize("use_sinkhorn", [True, False],
                         ids=["sinkhorn", "exact"])
def test_season_stability_matches_jax(walks, use_sinkhorn):
    want_walk, got_walk = walks
    want = j_season.season_stability(want_walk, use_sinkhorn=use_sinkhorn)
    got = t_season.season_stability(got_walk, use_sinkhorn=use_sinkhorn,
                                    device="cpu")
    T = want_walk["Imgs"].shape[2]
    assert got["EM_matrices"].shape == want["EM_matrices"].shape == (T, 4, 4)
    np.testing.assert_array_equal(np.isnan(got["EM_matrices"]),
                                  np.isnan(want["EM_matrices"]))
    np.testing.assert_allclose(np.nan_to_num(got["EM_matrices"]),
                               np.nan_to_num(want["EM_matrices"]),
                               rtol=EM_RTOL, atol=0)
    for k, v in want["Stats"].items():
        assert abs(got["Stats"][k] - v) <= EM_RTOL * abs(v), k


def test_season_stability_pads_as_jax_does():
    """The Sinkhorn batch pads every signature of every time together, as
    the JAX package does: on the same renders the values agree to 2e-5
    relative, the padding included."""
    rng = np.random.default_rng(4)
    imgs = np.empty((2, 1, 3), object)
    for idx in np.ndindex(2, 1, 3):
        imgs[idx] = rng.uniform(size=(6, 6, 3)) ** (1 + idx[0] + idx[2])
    walk = {"Imgs": imgs}
    want = j_season.season_stability(walk)
    got = t_season.season_stability(walk, device="cpu")
    np.testing.assert_allclose(np.nan_to_num(got["EM_matrices"]),
                               np.nan_to_num(want["EM_matrices"]),
                               rtol=EM_RTOL, atol=0)


def test_prototype_baseline_em_equals_jax(cams):
    imgs = [c.image for c in cams[1][:3]]
    got = t_season.prototype_baseline_em(imgs)
    want = j_season.prototype_baseline_em(imgs)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(np.diag(got)).all() and np.isfinite(got[0, 1])


# --- eval/summary_images.py --------------------------------------------------
def _png(path):
    return np.asarray(Image.open(path).convert("RGB"), float) / 255


def test_best_time_match_matches_jax(renderers, cams):
    (j_r, t_r), target = renderers, cams[1][0].image
    kw = dict(view_el_az=(80.0, 40.0), sun_el_az=(50.0, 160.0), out_size=8,
              n_times=5)
    t_w, img_w, d_w = j_summary.best_time_match(j_r, target, **kw)
    t_g, img_g, d_g = t_summary.best_time_match(t_r, target, **kw)
    assert t_g == t_w
    np.testing.assert_allclose(d_g, d_w, rtol=EM_RTOL, atol=0)
    np.testing.assert_allclose(img_g, img_w, rtol=0, atol=IMG_TOL)


def test_season_sun_grid_panels_match_jax_renders(renderers, tmp_path):
    j_r, t_r = renderers
    times, suns = [0.1, 0.6], [(40.0, 150.0), (70.0, 200.0), (55.0, 90.0)]
    path = t_summary.season_sun_grid(t_r, times, suns, (75.0, 20.0), 8,
                                     str(tmp_path / "grid.png"))
    img = _png(path)
    gap = 4
    assert img.shape == (3 * 8 + 2 * gap, 2 * 8 + gap, 3)
    for j, sun in enumerate(suns):
        for i, t in enumerate(times):
            want = np.clip(j_r.render_img((75.0, 20.0), sun, t, 8)["Col_Img"],
                           0, 1)
            panel = img[j * (8 + gap):j * (8 + gap) + 8,
                        i * (8 + gap):i * (8 + gap) + 8]
            np.testing.assert_allclose(panel, want, rtol=0,
                                       atol=1 / 255 + IMG_TOL)


def test_angle_scatter_and_proto_time_plot(cams, tmp_path):
    t_cams = cams[1]
    d = t_summary.DISC_PX
    path = str(tmp_path / "angles.png")
    t_summary.angle_scatter(t_cams, TEST_IDX, path,
                            walk_sun=np.array([[45.0, 90.0]]))
    img = _png(path)
    assert img.shape == (d, 2 * d + 4, 3)
    for i, c in enumerate(t_cams):
        rgb = t_summary.RED if i in TEST_IDX else t_summary.BLUE
        for k, (el, az) in enumerate((c.view_el_az, c.sun_el_az)):
            x, y = t_summary._polar_xy((90 - el) / 90, np.deg2rad(az))
            px = img[int(round(y)), int(round(x)) + k * (d + 4)]
            np.testing.assert_allclose(px, rgb, atol=1 / 255)
    x, y = t_summary._polar_xy(45 / 90, np.deg2rad(90.0))
    np.testing.assert_allclose(img[int(round(y)), int(round(x)) + d + 4],
                               t_summary.GREEN, atol=1 / 255)

    path = str(tmp_path / "proto.png")
    t_summary.proto_time_plot(t_cams, [0, 2], TEST_IDX, TEST_IDX,
                              np.array([0.25]), path)
    img = _png(path)
    # the clock, then each prototype scaled to the clock's height
    assert img.shape == (d, 3 * d + 2 * 4, 3)
    x, y = t_summary._polar_xy(1.0, 2 * np.pi * t_cams[3].time_frac)
    np.testing.assert_allclose(img[int(round(y)), int(round(x))],
                               t_summary.RED, atol=1 / 255)
    proto = img[:, d + 4:2 * d + 4]
    assert abs(proto.mean() - np.clip(t_cams[1].image, 0, 1).mean()) < 0.02


# --- eval/pairwise_metrics.py, eval/phase_congruency.py ----------------------
@pytest.fixture(scope="module")
def stacks():
    rng = np.random.default_rng(0)
    return {hw: rng.uniform(0.05, 0.95, (2, 3, hw, hw, 3)).astype(np.float32)
            for hw in (16, 32)}


METRIC_TOL = {"psnr": 1e-4, "fsim": 1e-4}


@pytest.mark.parametrize("name", list(j_pm.METRICS))
def test_pairwise_metric_matches_jax(stacks, name):
    x = stacks[32 if name == "ms_ssim" else 16]
    want = np.asarray(j_pm.METRICS[name](jnp.asarray(x)))
    got = t_pm.METRICS[name](torch.from_numpy(x))
    assert isinstance(got, torch.Tensor) and got.shape == (2, 3, 3)
    got = got.numpy()
    off = ~np.eye(3, dtype=bool)[None].repeat(2, 0)
    assert np.isfinite(want).all()
    tol = METRIC_TOL.get(name, 1e-5)
    np.testing.assert_allclose(got[off], want[off], rtol=0, atol=tol)
    if name == "sam":
        np.testing.assert_allclose(got[~off], want[~off], rtol=0, atol=1e-4)
    elif name == "sre":
        np.testing.assert_allclose(got[~off], want[~off], rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got[~off], want[~off], rtol=0, atol=tol)


def test_ms_ssim_is_nan_where_jax_is(stacks):
    """At 16 x 16 the fifth scale has one pixel: its unbiased variance is
    NaN in both packages."""
    x = stacks[16]
    want = np.asarray(j_pm.ms_ssim(jnp.asarray(x)))
    got = t_pm.ms_ssim(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_phase_congruency_matches_jax(stacks):
    g = stacks[16][..., 0]                         # [2, 3, 16, 16]
    want = np.asarray(j_pc(jnp.asarray(g)))
    got = t_pc(torch.from_numpy(g))
    assert got.shape == g.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    want = np.asarray(j_pc(jnp.asarray(g[0, 0]), nscale=3, norient=6))
    got = t_pc(torch.from_numpy(g[0, 0]), nscale=3, norient=6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
