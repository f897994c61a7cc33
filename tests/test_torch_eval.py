"""The port's evaluation modules against the JAX package's, on the CPU:
``eval/emd.py``, ``eval/img_eval.py``, ``eval/hm_eval.py``,
``eval/walks.py``, ``eval/reports.py``, ``render/movie.py::giffify`` (the
GIF writer of ``utils/gif.py``) and the renderer's camera rays and
component render.  The same numpy inputs, made from a seed, go through
both; networks carry their weights across by ``state_dict_from_flax``
(width 32, four layers, BatchNorm statistics from a train-mode pass).

Tolerances, each with its reason:
- ``rgb_to_lab``, ``color_signature``, ``emd_exact``: 1e-9, the same
  float64 numpy and the same HiGHS LP (the port's constraint matrix is
  sparse, the LP the same);
- ``emd_sinkhorn_batch``: 1e-4 relative, both float32 with the
  logsumexps in other orders; zero-weight rows that leave the cost scale
  as it is change the value by under 1e-5 relative;
- ``camera_grid_rays``, the walks, ``shift_and_rotate``,
  ``apply_affine``, ``greedy_align``, ``simple_align``, ``hm_scores``,
  ``shadow_confusion``: exactly equal, the same numpy and scipy calls;
- ``_resize``: 1e-5 of ``cv2.resize`` (the oracle), float32 taps in
  another order;
- ``density_surface``: float32 (both sines) 1e-5 on the surface, the
  fold re-associating the trunk (~3e-6 on x_enc); the interval widths
  equal except at columns where a widening's mass lies within 1e-5 of
  0.67 (counted); bfloat16 2e-2 on the surface, the two packages
  rounding to bf16 in other places (ROADMAP Queue 3);
- the seasonal alignment: float32 1e-5 relative on every candidate's
  error and the same choice wherever the runner-up trails by more than
  1e-4 (relative); bfloat16 1e-2 relative;
- the gauntlet: PSNR 1e-4 dB and SSIM 1e-5 (float32 filters in other
  orders), EM 1e-9 (the same signatures and LP); on each package's own
  renders (the evaluation variants) EM 2e-5 relative;
- the component render: float32 1e-4 (as ``test_torch_render.py``);
- reports: byte for byte against the JAX package's writer with
  ``tabulate`` blocked (its fallback layout, the port's only one);
- the GIF: frame count, size, loop 0 and 200 ms a frame as decoded by
  PIL, and a mean absolute error against each frame no larger than that
  of the JAX package's imageio GIF of the same frames plus 2/255.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from season_nerf_torch.config import Config as TConfig
from season_nerf_torch.data import synthetic as t_synth
from season_nerf_torch.eval import emd as t_emd
from season_nerf_torch.eval import hm_eval as t_hm
from season_nerf_torch.eval import img_eval as t_img
from season_nerf_torch.eval import reports as t_reports
from season_nerf_torch.eval import walks as t_walks
from season_nerf_torch.models.tnerf import model_from_config as t_model
from season_nerf_torch.render import movie as t_movie
from season_nerf_torch.render import renderer as t_renderer
from season_nerf_torch.utils.convert import state_dict_from_flax
from season_nerf_tpu.config import Config as JConfig
from season_nerf_tpu.data import synthetic as j_synth
from season_nerf_tpu.eval import emd as j_emd
from season_nerf_tpu.eval import hm_eval as j_hm
from season_nerf_tpu.eval import img_eval as j_img
from season_nerf_tpu.eval import reports as j_reports
from season_nerf_tpu.eval import walks as j_walks
from season_nerf_tpu.models.tnerf import model_from_config as j_model
from season_nerf_tpu.render import movie as j_movie
from season_nerf_tpu.render import renderer as j_renderer

torch.set_num_threads(1)

SITE = dict(n_views=4, img_size=24, grid=24, seed=3)
MODEL = dict(fc_units=32, fc_layers=4, n_samples=8)
CONFIGS = {"f32": dict(compute_dtype="float32", fast_sine=True),
           "f32_sin": dict(compute_dtype="float32", fast_sine=False),
           "bf16": dict(compute_dtype="bfloat16", fast_sine=True)}
SURFACE_TOL = {"f32": 1e-5, "f32_sin": 1e-5, "bf16": 2e-2}
ALIGN_RTOL = {"f32": 1e-5, "bf16": 1e-2}
GRID, S_HM, CHUNK_COLS = (10, 13), 16, 50      # 130 columns, 3 calls


def _nan_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(scope="module")
def scenes():
    return j_synth.make_scene(**SITE), t_synth.make_scene(**SITE)


@pytest.fixture(scope="module")
def pairs():
    """{config: (JAX model, its variables, the port's model)}, the JAX
    BatchNorms given running statistics by one train-mode pass."""
    out = {}
    for name, kw in CONFIGS.items():
        cfg = dict(MODEL, **kw)
        jm = j_model(JConfig(**cfg))
        rng = np.random.default_rng(5)
        pts = jnp.asarray(rng.uniform(-1, 1, (256, 3)), jnp.float32)
        sun = jnp.asarray(rng.normal(size=(256, 3)), jnp.float32)
        t4 = jnp.asarray(rng.uniform(-1, 1, (256, 4)), jnp.float32)
        v = jax.jit(jm.init, static_argnames="train")(
            jax.random.PRNGKey(11), pts[:2], sun[:2], t4[:2], train=False)
        _, upd = jax.jit(lambda v, *a: jm.apply(
            v, *a, train=True, mutable=["batch_stats"]))(v, pts, sun, t4)
        jv = {"params": v["params"], "batch_stats": upd["batch_stats"]}
        tm = t_model(TConfig(**cfg)).load_weights(state_dict_from_flax(
            *jax.device_get((jv["params"], jv["batch_stats"]))))
        out[name] = (jm, jv, tm)
    return out


# --- eval/emd.py -------------------------------------------------------------
def _images(seed, shape=(20, 24, 3), holes=True):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape) ** 1.5
    if holes:
        a[rng.uniform(size=shape[:2]) < 0.1] = np.nan
    return a


def test_rgb_to_lab_and_signatures_match_jax():
    x = _images(0, holes=False)
    np.testing.assert_allclose(t_emd.rgb_to_lab(x), j_emd.rgb_to_lab(x),
                               rtol=0, atol=1e-9)
    img = _images(1)
    for kw in ({}, {"space": "rgb"}, {"space": "rgb", "bins_per_edge": 4},
               {"prune_thresh": 0.05}):
        got = t_emd.color_signature(img, **kw)
        want = j_emd.color_signature(img, **kw)
        assert got.shape == want.shape, kw
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9,
                                   err_msg=str(kw))


def test_emd_exact_matches_jax():
    for seed in range(2):
        a = _images(2 * seed, shape=(14, 12, 3))
        b = _images(2 * seed + 1, shape=(14, 12, 3)) ** 2
        s1, s2 = t_emd.color_signature(a), t_emd.color_signature(b)
        for metric in ("l1", "l2"):
            want = j_emd.emd_exact(s1, s2, metric)
            assert abs(t_emd.emd_exact(s1, s2, metric) - want) <= 1e-9
        assert abs(t_emd.compare_em_imgs(a, b)
                   - j_emd.compare_em_imgs(a, b)) <= 1e-9


def test_emd_sinkhorn_batch_matches_jax_and_ignores_padding():
    sigs = [t_emd.color_signature(_images(s, shape=(12, 12, 3)),
                                  space="rgb", bins_per_edge=4)
            for s in range(4)]
    assert len({s.shape[0] for s in sigs}) > 1      # padding is exercised
    W1, X1 = t_emd.pad_signatures(sigs)
    W2, X2 = t_emd.pad_signatures(sigs[::-1])
    for metric in ("l1", "l2"):
        want = j_emd.emd_sinkhorn_batch(W1, X1, W2, X2, metric=metric)
        got = t_emd.emd_sinkhorn_batch(W1, X1, W2, X2, metric=metric,
                                       device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
        for i, (a, b) in enumerate(zip(sigs, sigs[::-1])):
            one = t_emd.emd_sinkhorn(a[:, 3], a[:, :3], b[:, 3], b[:, :3],
                                     metric=metric, device="cpu")
            assert abs(one - j_emd.emd_sinkhorn(
                a[:, 3], a[:, :3], b[:, 3], b[:, :3], metric=metric)) \
                <= 1e-4 * one
            # zero-weight rows carry no mass: padded with copies of a real
            # centroid (which leave the cost scale as it is), the value
            # stays (the zero-centroid padding of pad_signatures moves the
            # scale, as in the JAX package)
            pad = np.concatenate([a, np.repeat(a[:1] * [1, 1, 1, 0], 5, 0)])
            padded = t_emd.emd_sinkhorn(pad[:, 3], pad[:, :3], b[:, 3],
                                        b[:, :3], metric=metric,
                                        device="cpu")
            assert abs(padded - one) <= 1e-5 * one
    assert abs(t_emd.compare_em_imgs(_images(7), _images(8), exact=False,
                                     device="cpu")
               - j_emd.compare_em_imgs(_images(7), _images(8), exact=False)
               ) <= 1e-4 * j_emd.compare_em_imgs(_images(7), _images(8),
                                                 exact=False)


# --- the renderer ------------------------------------------------------------
def test_camera_grid_rays_match_jax(scenes):
    js, ts = scenes
    dropped = 0
    for jc, tc in zip(js.cameras, ts.cameras):
        for size in ((20, 17), (24, 24)):
            got = t_renderer.camera_grid_rays(tc, size)
            want = j_renderer.camera_grid_rays(jc, size)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            dropped += size[0] * size[1] - got[0].shape[0]
    assert dropped > 0           # the in-cube filter is exercised


def test_component_render_by_camera_matches_jax(pairs, scenes):
    jm, jv, tm = pairs["f32"]
    cam_j, cam_t = scenes[0].cameras[1], scenes[1].cameras[1]
    want = j_renderer.Renderer(jm, jv, n_samples=8, chunk=100) \
        .component_render_by_camera(cam_j, (12, 11))
    got = t_renderer.Renderer(tm, n_samples=8, chunk=100) \
        .component_render_by_camera(cam_t, (12, 11))
    assert set(got) == set(want)
    for k in ("img_pts", "gt_img_pts", "sun_vec"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("pts", "deltas", "rho", "col_raw", "vis", "sky",
              "class_probs", "adjust_per_class"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)


# --- eval/img_eval.py --------------------------------------------------------
@pytest.mark.parametrize("src,dst", [((64, 48, 3), (16, 12)),
                                     ((24, 24, 3), (256, 256)),
                                     ((37, 53, 3), (20, 31)),
                                     ((30, 50), (17, 9))],
                         ids=["down2x", "up", "non_square", "gray"])
def test_resize_matches_cv2(src, dst):
    x = np.random.default_rng(sum(src)).uniform(size=src).astype(np.float32)
    got = t_img._resize(x, dst)
    want = cv2.resize(x, (dst[1], dst[0]))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_gauntlet_and_shadow_confusion_match_jax():
    gt = _images(3, shape=(16, 18, 3), holes=False).astype(np.float32)
    est = np.clip(gt + np.random.default_rng(4).normal(0, 0.1, gt.shape),
                  0, 1).astype(np.float32)
    est[2:5, 3:9] = np.nan
    for a, b in ((gt, est), (gt, gt), (gt, np.full_like(gt, np.nan))):
        got = t_img.image_quality_gauntlet(a, b)
        want = j_img.image_quality_gauntlet(a, b)
        assert abs(got[0] - want[0]) <= 1e-6
        assert abs(got[1] - want[1]) <= 1e-4
        assert abs(got[2] - want[2]) <= 1e-5
        assert abs(got[3] - want[3]) <= 1e-9
    rng = np.random.default_rng(6)
    m1, m2 = rng.uniform(size=(9, 9)), rng.uniform(size=(9, 9))
    m1[0, 0] = np.nan
    assert t_img.shadow_confusion(m1, m2) == j_img.shadow_confusion(m1, m2)


def test_eval_variants_match_jax(pairs, scenes):
    """``full_eval_images`` with exact solar shadows (the exact-shadow
    variants and the shadow confusion) and ``eval_img_dict``'s per-class
    scores: the gauntlet's tolerances, EM 2e-5 relative (the renders agree
    to ~1e-5, as ``test_component_render_by_camera_matches_jax``, which
    moves the signatures' centroids), the confusion equal (NaN where a
    class is absent)."""
    jm, jv, tm = pairs["f32"]
    kw = dict(exact_solar=True, n_align_times=20)
    want = j_img.full_eval_images(
        j_renderer.Renderer(jm, jv, n_samples=8, chunk=100),
        scenes[0].cameras[:1], (10, 10), **kw)
    got = t_img.full_eval_images(t_renderer.Renderer(tm, n_samples=8,
                                                     chunk=100),
                                 scenes[1].cameras[:1], (10, 10), **kw)
    assert set(got) == set(want)
    for name, e_w in want.items():
        e_g = got[name]
        assert set(e_g) == set(e_w)
        np.testing.assert_equal(e_g["Shadow_Scores"], e_w["Shadow_Scores"])
        assert e_g["Aligned_Vals"][2] == e_w["Aligned_Vals"][2]
        s_g = t_img.eval_img_dict(e_g["Result"], score_extremes=True)
        s_w = j_img.eval_img_dict(e_w["Result"], score_extremes=True)
        assert set(s_g) == set(s_w) and "Base_Exact_Shadow_Img" in s_g
        assert "Class_3_Img" in s_g
        for variant, w in s_w.items():
            g = s_g[variant]
            assert abs(g[0] - w[0]) <= 1e-5, variant
            assert abs(g[1] - w[1]) <= 1e-4, variant
            assert abs(g[2] - w[2]) <= 1e-5, variant
            assert abs(g[3] - w[3]) <= 2e-5 * abs(w[3]), variant


def _jax_align_errors(jm, jv, comp, gt_cols, base_time, n_times):
    """The JAX ``seasonal_align``'s candidate errors (its own steps)."""
    ts = np.concatenate([[base_time], np.linspace(0, 1, n_times)])
    t4 = np.stack([np.cos(ts * 2 * np.pi), np.sin(ts * 2 * np.pi),
                   np.cos(ts * 2 * np.pi), np.sin(ts * 2 * np.pi)], 1)
    cvs = np.asarray(jm.apply(jv, jnp.asarray(t4, jnp.float32), train=False,
                              method="class_only"))
    rho, deltas = comp["rho"], comp["deltas"]
    tau = np.cumsum(rho * deltas, 1)
    pv = np.exp(-np.concatenate([np.zeros_like(tau[:, :1]), tau[:, :-1]], 1))
    ps = pv * (1 - np.exp(-rho * deltas))
    gate = j_renderer._sig((np.sum(ps * comp["vis"], 1) - 0.2) * 30.0)
    errors, skies = jax.device_get(j_img._score_align_candidates(
        jnp.asarray(cvs), jnp.asarray(ps, jnp.float32),
        jnp.asarray(comp["col_raw"], jnp.float32),
        jnp.asarray(comp["adjust_per_class"], jnp.float32),
        jnp.asarray(gate, jnp.float32), jnp.asarray(gt_cols, jnp.float32),
        jnp.asarray((gate < 0.99)[:, 0])))
    return cvs, np.asarray(errors), np.asarray(skies)


@pytest.mark.parametrize("name", sorted(ALIGN_RTOL))
def test_seasonal_align_matches_jax(name, pairs, scenes, monkeypatch):
    jm, jv, tm = pairs[name]
    cam = scenes[0].cameras[2]
    comp = j_renderer.Renderer(jm, jv, n_samples=8, chunk=100) \
        .component_render_by_camera(cam, (12, 12))
    gt_cols = cam.image[comp["gt_img_pts"][:, 0], comp["gt_img_pts"][:, 1]]
    n_times = 40
    cvs, want, want_sky = _jax_align_errors(jm, jv, comp, gt_cols,
                                            cam.time_frac, n_times)
    N, S = comp["rho"].shape[:2]
    # blocks of 7 candidates: the blocking changes nothing
    monkeypatch.setattr(t_img, "ALIGN_BLOCK_BYTES", 7 * N * S * 3 * 4)
    tr = t_renderer.Renderer(tm, n_samples=8, chunk=100)
    ts, got_cvs, got, got_sky = t_img.align_errors(tr, comp, gt_cols,
                                                   cam.time_frac, n_times)
    rtol = ALIGN_RTOL[name]
    assert got.shape == (n_times + 1,)
    np.testing.assert_allclose(got_cvs, cvs, rtol=0, atol=rtol)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    if name == "f32":
        np.testing.assert_allclose(got_sky, want_sky, rtol=0, atol=1e-4)
        cvec, sky, t_best = t_img.seasonal_align(tr, comp, gt_cols,
                                                 cam.time_frac, n_times)
        j_cvec, j_sky, j_t = j_img.seasonal_align(
            j_renderer.Renderer(jm, jv, n_samples=8, chunk=100), comp,
            gt_cols, cam.time_frac, n_times)
        order = np.sort(want)
        if order[1] - order[0] > 1e-4 * order[0]:
            assert t_best == j_t and int(np.argmin(got)) == int(
                np.argmin(want))
            np.testing.assert_allclose(cvec, j_cvec, rtol=0, atol=1e-5)


# --- eval/hm_eval.py ---------------------------------------------------------
def _ci_masses(tm, S):
    """Every widening's mass of every column, in float64 from the port's
    densities: [columns, S]."""
    H, W = GRID
    xy = np.stack(np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                              indexing="ij"), -1).reshape(-1, 2)
    zs = np.linspace(1, -1, S)
    pts = np.concatenate([np.repeat(xy, S, 0), np.tile(zs[:, None],
                                                       (len(xy), 1))], 1)
    with torch.no_grad():
        rho = tm.sigma_only(torch.as_tensor(pts, dtype=torch.float32)) \
            .double().numpy().reshape(len(xy), S)
    tau = np.cumsum(rho * 2 / S, 1)
    pv = np.exp(-np.concatenate([np.zeros_like(tau[:, :1]), tau[:, :-1]], 1))
    ps = pv * (1 - np.exp(-rho * 2 / S))
    cdf = np.concatenate([np.zeros_like(ps[:, :1]),
                          np.cumsum(ps / ps.sum(1, keepdims=True), 1)], 1)
    amax = np.argmax(ps, 1)[:, None]
    k = np.arange(S)[None]
    z0, z1 = np.maximum(amax - k, 0), np.minimum(amax + 1 + k, S)
    return (np.take_along_axis(cdf, z1, 1) - np.take_along_axis(cdf, z0, 1))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_density_surface_matches_jax(name, pairs):
    jm, jv, tm = pairs[name]
    want_e, want_ci = j_hm.density_surface(jm, jv, GRID, n_samples=S_HM,
                                           chunk_cols=CHUNK_COLS)
    tm.train()                     # density_surface evaluates in eval mode
    got_e, got_ci = t_hm.density_surface(tm, GRID, n_samples=S_HM,
                                         chunk_cols=CHUNK_COLS)
    assert tm.training
    tm.eval()
    assert got_e.shape == got_ci.shape == GRID
    np.testing.assert_allclose(got_e, want_e, rtol=0, atol=SURFACE_TOL[name])
    if name != "bf16":
        differ = (got_ci != want_ci).ravel()
        near = (np.abs(_ci_masses(tm, S_HM) - 0.67) < 1e-5).any(1)
        assert not (differ & ~near).any()
        assert differ.sum() <= near.sum()


def _rasters(seed, n=18):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    gt = 10 + 3 * np.sin(xx / 3.0) + 2 * np.cos(yy / 4.0) + (xx > n // 2) * 4
    est = np.roll(gt, 1, axis=1) + rng.normal(0, 0.3, gt.shape) + 1.5
    est[0, :3] = np.nan
    return est, gt


def test_alignment_searches_match_jax():
    est, gt = _rasters(0)
    for shift, rot in (((1, -1), 0), ((0, 0), 3), ((-1, 1), -5)):
        _nan_equal(t_hm.shift_and_rotate(est, shift, rot),
                   j_hm.shift_and_rotate(est, shift, rot))
    _nan_equal(t_hm.apply_affine(est, 4.0, (1.02, 0.97), (1.0, -2.0)),
               j_hm.apply_affine(est, 4.0, (1.02, 0.97), (1.0, -2.0)))
    got, want = t_hm.greedy_align(est, gt), j_hm.greedy_align(est, gt)
    _nan_equal(got[0], want[0])
    _nan_equal(got[1], want[1])
    assert np.abs(got[1]).sum() > 0          # the search moved
    got, want = t_hm.simple_align(est, gt), j_hm.simple_align(est, gt)
    for g, w in zip(got, want):
        _nan_equal(g, w)
    assert t_hm.hm_scores(est, gt) == j_hm.hm_scores(est, gt)


# --- eval/walks.py -----------------------------------------------------------
def test_walking_points_match_jax(scenes):
    js, ts = scenes
    for sep in (0, 20.0):
        for g, w in zip(t_walks.get_walking_points(ts.cameras, 3, 5, 12,
                                                   min_day_sep=sep),
                        j_walks.get_walking_points(js.cameras, 3, 5, 12,
                                                   min_day_sep=sep)):
            np.testing.assert_array_equal(g, w)
    got = t_walks.shadow_walk_points(ts.cameras[:3], ts.cameras[3:])
    want = j_walks.shadow_walk_points(js.cameras[:3], js.cameras[3:])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# --- eval/reports.py ---------------------------------------------------------
def test_reports_equal_jax_without_tabulate(tmp_path, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "tabulate", None)
    before = {"MAE": 1.25, "RMSE": 2.5, "Acc_1_m": 0.4, "Median": 0.75}
    after = dict(before, MAE=1.0, Shift_x_y_deg=[1.0, 0.0, -2.0])
    summary = {v: {m: {"avg": 0.5 + i, "best": 0.25, "worst": 1.0 / 3}
                   for m in ("PSNR", "SSIM", "EM", "L2")}
               for i, v in enumerate(("Base_Img", "Aligned_Shadow_Img"))}
    shadow = {"Training": {k: 0.125 for k in (
        "Acc", "Prec_Sun", "Recall_Sun", "Prec_Shadow", "Recall_Shadow",
        "Avg_Error", "Avg_Offset")}}
    stability = {"Stats": {"mean": 1.5, "median": 1.25, "p95": 3.0,
                           "max": 4.0}}
    base = np.array([1.0, np.nan, 3.0])
    calls = [("hm_report", (before, after)),
             ("hm_report", (before, after, before)),
             ("image_report", (summary,)), ("shadow_report", (shadow,)),
             ("season_report", (stability, base))]
    for i, (fn, args) in enumerate(calls):
        t, j = tmp_path / f"t{i}.txt", tmp_path / f"j{i}.txt"
        getattr(t_reports, fn)(str(t), *args)
        getattr(j_reports, fn)(str(j), *args)
        assert t.read_bytes() == j.read_bytes(), fn
    rows = [["a", 1.0, 2], ["bbbb", np.float32(3.5), "x"]]
    assert t_reports.text_table(["h1", "h2", "h3"], rows) == \
        j_reports.text_table(["h1", "h2", "h3"], rows)


# --- render/movie.py::giffify ------------------------------------------------
def _decode_gif(path):
    im = Image.open(path)
    frames, durations = [], []
    for k in range(im.n_frames):
        im.seek(k)
        frames.append(np.asarray(im.convert("RGB"), float))
        durations.append(im.info.get("duration"))
    return im, frames, durations


def test_giffify_writes_a_looping_gif_as_good_as_jax(tmp_path):
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:40, 0:48] / 40.0
    images = [np.stack([np.sin(3 * xx + i) * 0.5 + 0.5, yy + 0.05 * i,
                        np.cos(5 * yy + 2 * xx) * 0.5 + 0.5], -1)
              + rng.normal(0, 0.05, (40, 48, 3)) for i in range(4)]
    images[1][3:6, 4:9] = np.nan                    # drawn as 0
    images.append(np.zeros((40, 48, 3)))            # few colours: exact
    t_path, j_path = str(tmp_path / "t.gif"), str(tmp_path / "j.gif")
    t_movie.giffify(images, t_path)
    j_movie.giffify(images, j_path)
    want_u8 = [(np.clip(np.nan_to_num(im), 0, 1) * 255).astype(np.uint8)
               for im in images]
    im, got, durations = _decode_gif(t_path)
    _, ref, _ = _decode_gif(j_path)
    assert len(got) == len(images) and im.size == (48, 40)
    assert im.info.get("loop") == 0 and durations == [200] * len(images)
    for g, r, w in zip(got, ref, want_u8):
        assert np.abs(g - w).mean() <= np.abs(r - w).mean() + 2.0
    np.testing.assert_array_equal(got[-1], want_u8[-1])
