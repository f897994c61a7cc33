"""The port's regional evaluation against the JAX package's, on the CPU:
``regional_eval`` into ``Detailed_Output/``, ``multi_region_merge``,
``area_overviews``, ``cli.run_test`` and ``cli eval_region``.  One model
directory written by the JAX package (float32, polynomial sine, width 32,
four layers, BatchNorm statistics from a train-mode pass) over a synthetic
site (4 views of 24 px, two held out); both packages evaluate it at test
renders of 12 x 12, season renders of 8 x 8 and 8 samples (height map and
shadow rays), with the prior DSM on a coarser grid than the lidar's so
that its resize runs (``cv2.resize`` in the JAX package).  One JAX
``regional_eval`` run serves every test.

Tolerances (float32; the fold re-associates the trunk, ~3e-6 on x_enc),
those of ``test_torch_analysis.py`` where the quantity is the same:
- height maps and their scores 2e-4 m, the alignment's shift equal; the
  prior's scores 1e-4 m (the port's resize is within 1e-5 of cv2's);
- per-image scores L2 1e-5, PSNR 1e-4 dB, SSIM 1e-5, EM 2e-5 relative,
  the aligned time equal, the class vector 1e-5;
- shadows: the arrays as ``test_torch_claims.py`` (exact 3e-5, learned
  visibility 1e-4, sky 1e-6); a sample classed apart at 0.5 only where
  the JAX value lies within that of 0.5; with none classed apart in a set,
  its statistics within 1e-5;
- seasons: the walk's points equal, every EM within 2e-5 relative
  (Sinkhorn on renders 1e-4 apart), the baseline equal (the same LP);
- the text reports: the JAX package's writer, ``tabulate`` blocked, on
  the port's values gives the port's file (byte for byte, up to the
  height-scale table the port appends);
- the merged tables: byte for byte between the packages on the same
  region directories, both ways;
- ``area_overviews``' panel within 1e-4 of the JAX render.
About 55 s on one worker, 35 s of it the JAX package's model init and
regional_eval.
"""

import functools
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from season_nerf_torch import cli as t_cli
from season_nerf_torch.config import get_opts
from season_nerf_torch.data import synthetic as t_synth
from season_nerf_torch.eval import regional as t_regional
from season_nerf_torch.eval import shadow_eval as t_shadow
from season_nerf_torch.render.loading import load_model_dir as t_load
from season_nerf_tpu.config import Config as JConfig
from season_nerf_tpu.data import synthetic as j_synth
from season_nerf_tpu.data.ingest import save_world_artifact
from season_nerf_tpu.data.rays import train_test_split
from season_nerf_tpu.eval import regional as j_regional
from season_nerf_tpu.eval import reports as j_reports
from season_nerf_tpu.eval import shadow_eval as j_shadow
from season_nerf_tpu.models.tnerf import model_from_config as j_model
from season_nerf_tpu.render.loading import load_model_dir as j_load
from season_nerf_tpu.train.state import save_model_artifact

torch.set_num_threads(1)

CFG = dict(site_name="SYNTH_RG", fc_units=32, fc_layers=4, n_samples=8,
           chunk=200, compute_dtype="float32", fast_sine=True,
           synth_views=4, synth_img_size=24, synth_grid=24, testing_size=2,
           seed=5)
EVAL = dict(img_size=(12, 12), season_size=(8, 8), hm_samples=8)
DETAILED = {"Data_Sat_and_Sun_pose.png", "Prototypical_Imgs.png",
            "HM_Summary.pickle", "HM_scores.txt", "Height_Maps.png",
            "Img_Summary.pickle", "Image_scores.txt",
            "Shadow_Scores_Summary.pickle", "Shadow_scores.txt",
            "Season_Summary.pickle", "Season_scores.txt",
            "Region_Results.pickle"}
MERGED = {"All_HM_scores.txt", "All_Image_scores.txt",
          "All_Shadow_scores.txt", "All_Season_scores.txt",
          "Merged_Results.pickle"}
HM_TOL_M = 2e-4
PRIOR_TOL_M = 1e-4
SCORE_TOL = {"L2": 1e-5, "PSNR": 1e-4, "SSIM": 1e-5}
EM_RTOL = 2e-5
SHADOW_TOL = {"Exact_Vis": 3e-5, "Est_Vis": 1e-4, "Sky_Col": 1e-6}
IMG_TOL = 1e-4


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A model directory written by the JAX package."""
    d = tmp_path_factory.mktemp("jax_model_dir")
    cfg = JConfig(**CFG)
    cfg.save_json(str(d / "opts.json"))
    jm = j_model(cfg)
    rng = np.random.default_rng(2)
    pts = jnp.asarray(rng.uniform(-1, 1, (256, 3)), jnp.float32)
    sun = jnp.asarray(rng.normal(size=(256, 3)), jnp.float32)
    t4 = jnp.asarray(rng.uniform(-1, 1, (256, 4)), jnp.float32)
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(7), pts[:2], sun[:2], t4[:2], train=False)
    _, upd = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=True, mutable=["batch_stats"]))(v, pts, sun, t4)
    save_model_artifact(str(d / "Final_Model.nn"), v["params"],
                        upd["batch_stats"], meta={})
    save_world_artifact(str(d / "W2C_W2L_H.npy"), None, None, (0.0, 30.0))
    return str(d)


def _site(synth):
    scene = synth.make_scene(n_views=CFG["synth_views"],
                             img_size=CFG["synth_img_size"],
                             grid=CFG["synth_grid"], seed=CFG["seed"])
    _, test_idx = train_test_split(CFG["synth_views"],
                                   testing_size=CFG["testing_size"])
    # the prior on a coarser grid than the lidar's: regional_eval resizes
    return scene, list(test_idx), scene.prior_hm[::2, ::3]


def _capture(module, name, box):
    """Wrap ``module.name`` so that its last result lands in ``box``."""
    fn = getattr(module, name)

    def wrapper(*a, **kw):
        box[name] = fn(*a, **kw)
        return box[name]
    return wrapper


@pytest.fixture(scope="module")
def jax_region(model_dir, tmp_path_factory):
    """The JAX package's regional_eval of the model directory -> (results,
    its output directory, its shadow summary with the arrays)."""
    out = str(tmp_path_factory.mktemp("jax_region") / "Region_J")
    loaded = j_load(model_dir)
    scene, test_idx, prior = _site(j_synth)
    box = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(j_shadow, "test_shadow_points",
               _capture(j_shadow, "test_shadow_points", box))
    try:
        res = j_regional.regional_eval(
            loaded.renderer, loaded.model, loaded.variables, scene.cameras,
            test_idx, scene.hm, prior, (0.0, 30.0), out, **EVAL)
    finally:
        mp.undo()
    return res, out, box["test_shadow_points"]


@pytest.fixture(scope="module")
def port_region(model_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_region") / "Region_T")
    loaded = t_load(model_dir, device="cpu")
    scene, test_idx, prior = _site(t_synth)
    box = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(t_shadow, "test_shadow_points",
               _capture(t_shadow, "test_shadow_points", box))
    try:
        res = t_regional.regional_eval(
            loaded.renderer, loaded.model, scene.cameras, test_idx,
            scene.hm, prior, (0.0, 30.0), out, **EVAL)
    finally:
        mp.undo()
    return res, out, box["test_shadow_points"]


def _load(d, name):
    with open(os.path.join(d, name), "rb") as f:
        return pickle.load(f)


def _leaves(x, path=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, x


def _close(got, want, atol, what, rtol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               rtol=rtol, atol=atol, err_msg=what)


def test_regional_eval_writes_every_file_of_numpy_values(port_region,
                                                         jax_region):
    _, out, _ = port_region
    assert set(os.listdir(out)) == DETAILED == set(os.listdir(jax_region[1]))
    for name in sorted(DETAILED):
        if name.endswith(".pickle"):
            for path, v in _leaves(_load(out, name)):
                assert isinstance(v, (np.ndarray, np.generic, float, int,
                                      str, bool, type(None))), (name, path,
                                                                type(v))
        elif name.endswith(".png"):
            with open(os.path.join(out, name), "rb") as f:
                assert f.read(8) == b"\x89PNG\r\n\x1a\n", name


def test_height_maps_match_jax(port_region, jax_region):
    got, want = (_load(r[1], "HM_Summary.pickle")
                 for r in (port_region, jax_region))
    assert got.keys() == want.keys()
    for part in ("Before", "After"):
        assert got[part].keys() == want[part].keys()
        for k, v in want[part].items():
            if k == "Shift_x_y_deg":
                assert got[part][k] == v
            else:
                assert abs(got[part][k] - v) <= HM_TOL_M, (part, k)
    for k, v in want["Imgs"].items():
        _close(got["Imgs"][k], v, HM_TOL_M, k)
    assert want["Prior"] is not None
    for k, v in want["Prior"].items():
        assert abs(got["Prior"][k] - v) <= PRIOR_TOL_M, k


def test_image_scores_match_jax(port_region, jax_region):
    got, want = (_load(r[1], "Img_Summary.pickle")
                 for r in (port_region, jax_region))
    assert got.keys() == want.keys() and len(want) == 2
    for name, e_w in want.items():
        e_g = got[name]
        assert e_g.keys() == e_w.keys() == {"Scores", "Aligned_Vals"}
        for variant, s_w in e_w["Scores"].items():
            s_g = e_g["Scores"][variant]
            for i, m in enumerate(("L2", "PSNR", "SSIM")):
                assert abs(s_g[i] - s_w[i]) <= SCORE_TOL[m], (name, variant,
                                                              m)
            assert abs(s_g[3] - s_w[3]) <= EM_RTOL * abs(s_w[3])
        assert e_g["Aligned_Vals"][2] == e_w["Aligned_Vals"][2], name
        _close(e_g["Aligned_Vals"][0], e_w["Aligned_Vals"][0], 1e-5, name)
    res_g, res_w = port_region[0], jax_region[0]
    for variant, cols in res_w["Images"]["Summary"].items():
        for m, stats in cols.items():
            for k, v in stats.items():
                g = res_g["Images"]["Summary"][variant][m][k]
                tol = EM_RTOL * abs(v) if m == "EM" else SCORE_TOL[m]
                assert abs(g - v) <= tol, (variant, m, k)


def test_shadow_claims_match_jax(port_region, jax_region):
    got, want = port_region[2], jax_region[2]
    assert _load(port_region[1], "Shadow_Scores_Summary.pickle").keys() == \
        _load(jax_region[1], "Shadow_Scores_Summary.pickle").keys()
    for k, v in want["Sun_El_Az"].items():
        np.testing.assert_array_equal(got["Sun_El_Az"][k], v)
    assert got["Stats"].keys() == want["Stats"].keys()
    assert set(want["Stats"]) == {"Training", "Testing", "Near_Walk",
                                  "Full_Walk"}
    for name, r_w in want["Results"].items():
        r_g = got["Results"][name]
        apart = np.zeros(r_w["Exact_Vis"].shape, bool)
        for key, tol in SHADOW_TOL.items():
            _close(r_g[key], r_w[key], tol, f"{name} {key}")
            if key != "Sky_Col":
                diff = (r_g[key] > 0.5) != (r_w[key] > 0.5)
                assert np.all(np.abs(r_w[key][diff] - 0.5) <= tol), name
                apart |= diff
        own = t_shadow.shadow_analysis(r_g["Exact_Vis"], r_g["Est_Vis"])
        for k, v in own.items():
            g = got["Stats"][name][k]
            assert g == v or (np.isnan(g) and np.isnan(v)), (name, k)
        if not apart.any():
            for k, v in want["Stats"][name].items():
                g = got["Stats"][name][k]
                assert abs(g - v) <= 1e-5 or (np.isnan(g) and np.isnan(v)), \
                    (name, k)
    assert port_region[0]["Shadows"] == got["Stats"]


def test_season_claims_match_jax(port_region, jax_region):
    got, want = (_load(r[1], "Season_Summary.pickle")
                 for r in (port_region, jax_region))
    assert got.keys() == want.keys()
    for k, v in want["Input_Vals"].items():
        np.testing.assert_array_equal(got["Input_Vals"][k], v)
    _close(got["Stability"]["EM_matrices"], want["Stability"]["EM_matrices"],
           0.0, "EM", rtol=EM_RTOL)
    for k, v in want["Stability"]["Stats"].items():
        assert abs(got["Stability"]["Stats"][k] - v) <= EM_RTOL * abs(v), k
    np.testing.assert_array_equal(got["Baseline"], want["Baseline"])
    assert np.isfinite(got["Baseline"][0, 1])
    res = port_region[0]["Seasons"]
    assert res["Stability"] == got["Stability"]["Stats"]


def test_region_results_and_reports(port_region, monkeypatch, tmp_path):
    """``Region_Results.pickle`` has the JAX layout; each text report is
    the JAX package's writer on the port's values (``tabulate`` blocked),
    the height map's with the port's scale table below it."""
    monkeypatch.setitem(__import__("sys").modules, "tabulate", None)
    res, out, _ = port_region
    want = _load(out, "Region_Results.pickle")
    assert set(want) == {"HM", "Images", "Shadows", "Seasons"}
    assert set(want["Images"]) == {"Summary", "Per_Image"}
    hm = want["HM"]
    j_reports.hm_report(str(tmp_path / "hm"), hm["Before"], hm["After"],
                        hm["Prior"])
    j_reports.image_report(str(tmp_path / "img"), want["Images"]["Summary"])
    j_reports.shadow_report(str(tmp_path / "sh"), want["Shadows"])
    j_reports.season_report(str(tmp_path / "se"),
                            _load(out, "Season_Summary.pickle")["Stability"],
                            want["Seasons"]["Baseline"])
    for mine, theirs in (("HM_scores.txt", "hm"), ("Image_scores.txt", "img"),
                         ("Shadow_scores.txt", "sh"),
                         ("Season_scores.txt", "se")):
        got = open(os.path.join(out, mine)).read()
        ref = (tmp_path / theirs).read_text()
        assert got.startswith(ref), mine
        if mine != "HM_scores.txt":
            assert got == ref, mine
    assert "CI_width_m" in open(os.path.join(out, "HM_scores.txt")).read()


def test_multi_region_merge_crosses_both_ways(port_region, jax_region,
                                              tmp_path, monkeypatch):
    """Either package merges either's region directories; on the same
    directories their tables are byte-equal and their merged pickles
    hold the same values."""
    monkeypatch.setitem(__import__("sys").modules, "tabulate", None)
    dirs = [port_region[1], jax_region[1], str(tmp_path / "empty")]
    os.makedirs(dirs[2])
    for name, merge in (("t", t_regional.multi_region_merge),
                        ("j", j_regional.multi_region_merge)):
        got = merge(dirs, str(tmp_path / name))
        assert set(got["HM"]) == {"Region_T", "Region_J"}
    for f in sorted(MERGED):
        t_bytes = (tmp_path / "t" / f).read_bytes()
        assert t_bytes == (tmp_path / "j" / f).read_bytes() or \
            f.endswith(".pickle"), f
    got = _load(str(tmp_path / "t"), "Merged_Results.pickle")
    want = _load(str(tmp_path / "j"), "Merged_Results.pickle")
    assert dict(_leaves(got)).keys() == dict(_leaves(want)).keys()
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(g, w, path)
    text = (tmp_path / "t" / "All_HM_scores.txt").read_text()
    assert "Region_T" in text and "Region_J" in text


def test_area_overviews_panel_matches_jax_render(model_dir, tmp_path,
                                                 monkeypatch):
    seen = {}
    write = t_regional.write_panels

    def recording(rows, path):
        seen["rows"] = rows
        return write(rows, path)
    monkeypatch.setattr(t_regional, "write_panels", recording)
    out = t_regional.area_overviews([model_dir, model_dir],
                                    str(tmp_path / "ov" / "areas.png"),
                                    out_size=10, device="cpu")
    assert os.path.exists(out)
    want = j_load(model_dir).renderer.render_img((90.0, 0.0), (55.0, 180.0),
                                                 0.5, 10)["Col_Img"]
    assert len(seen["rows"]) == 1 and len(seen["rows"][0]) == 2
    for panel in seen["rows"][0]:
        _close(panel, want, IMG_TOL, "overview")


def test_cli_train_writes_detailed_output(tmp_path):
    """``run_test`` after a short training run writes the file list of
    ``tests/test_cli_e2e.py`` (and every file of ``Detailed_Output/``)."""
    cfg = get_opts(["--site_name", "SYNTH_RT", "--exp_name", "rt",
                    "--IO_Location", str(tmp_path), "--max_train_steps", "3",
                    "--n_samples", "8", "--batch_size", "16",
                    "--fc_units", "32", "--synth_views", "3",
                    "--synth_img_size", "16", "--synth_grid", "16",
                    "--testing_size", "1", "--n_saves", "1",
                    "--compute_dtype", "float32"])
    trainer, analysis = t_cli.run_test(cfg, eval_img_size=(8, 8),
                                       eval_season_size=(8, 8), device="cpu")
    detailed = os.path.join(cfg.logs_dir, "Detailed_Output")
    for f in ("HM_Summary.pickle", "Img_Summary.pickle",
              "Shadow_Scores_Summary.pickle", "Season_Summary.pickle",
              "Image_scores.txt", "Shadow_scores.txt", "Season_scores.txt",
              "Data_Sat_and_Sun_pose.png"):
        assert os.path.exists(os.path.join(detailed, f)), f
    assert set(os.listdir(detailed)) == DETAILED
    res = _load(detailed, "Region_Results.pickle")
    assert np.isfinite(res["HM"]["After"]["RMSE"])
    assert all(np.isfinite(s["Loss"]) for s in res["Shadows"].values())


def test_cli_eval_region_on_a_jax_model_directory(model_dir, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(t_cli, "run_test", functools.partial(
        t_cli.run_test, eval_img_size=(8, 8), eval_season_size=(8, 8)))
    loc = str(tmp_path / "regions" / "Region_A")
    shutil.copytree(model_dir, loc)
    assert t_cli.main(["eval_region", "--Model_Locations", loc, "--full",
                       "--device", "cpu"]) == 0
    out = tmp_path / "regions" / "Full_Summary"
    assert set(os.listdir(out)) == MERGED
    assert set(os.listdir(os.path.join(loc, "Detailed_Output"))) == DETAILED
    assert os.path.exists(os.path.join(loc, "Output", "Image_scores.txt"))
    merged = _load(str(out), "Merged_Results.pickle")
    # a region is named by its directory's last part, as in the JAX
    # package: every Detailed_Output/ merges under one name
    assert set(merged["Seasons"]) == {"Detailed_Output"}
