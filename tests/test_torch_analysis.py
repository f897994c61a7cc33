"""The port's evaluation after training, as a whole, against the JAX
package's on the CPU: ``analyze_model`` + ``write_analysis_outputs`` and
``cli.run_test`` with ``eval_only``, on one model directory the JAX
package wrote (float32, polynomial sine, width 32, four layers, BatchNorm
statistics from a train-mode pass) over a synthetic site (4 views of 24
px, two held out): test renders at 16 x 16, walks at 16 px, 8 samples,
the 24 x 24 ground-truth height map.  Then ``run_test`` training a model
whose ``best_geometry`` selection is not the last step.

Tolerances (float32, the fold re-associating the trunk: ~3e-6 on x_enc):
- rendered images (walks, test renders, ground truth): 1e-4, as
  ``test_torch_render.py``;
- the height maps and their scores: 2e-4 m (the surface's 1e-5 of
  ``test_torch_eval.py`` over the 30 m range), the alignment's shift
  equal;
- per-image scores: the gauntlet's own tolerances of
  ``test_torch_eval.py`` (L2 1e-5, PSNR 1e-4 dB, SSIM 1e-5), EM 2e-5
  relative (the renders differ at the 1e-6 level, which moves the
  signatures' centroids; measured 6e-7); the aligned time equal (the
  candidates' errors part by more than the float32 differences here).
About 30 s on one worker, most of it the JAX package's compiles.
"""

import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from season_nerf_torch import cli as t_cli
from season_nerf_torch.config import Config as TConfig
from season_nerf_torch.config import get_opts
from season_nerf_torch.data import synthetic as t_synth
from season_nerf_torch.eval import regional as t_regional
from season_nerf_torch.render.loading import load_model_dir as t_load
from season_nerf_torch.render.renderer import Renderer as TRenderer
from season_nerf_torch.train import state as t_state
from season_nerf_torch.train.engine import Trainer as TTrainer
from season_nerf_tpu.config import Config as JConfig
from season_nerf_tpu.data import synthetic as j_synth
from season_nerf_tpu.data.ingest import save_world_artifact
from season_nerf_tpu.data.rays import train_test_split
from season_nerf_tpu.eval import regional as j_regional
from season_nerf_tpu.models.tnerf import model_from_config as j_model
from season_nerf_tpu.render.loading import load_model_dir as j_load
from season_nerf_tpu.render.renderer import Renderer as JRenderer
from season_nerf_tpu.train.state import save_model_artifact

torch.set_num_threads(1)

CFG = dict(site_name="SYNTH_AN", fc_units=32, fc_layers=4, n_samples=8,
           chunk=200, compute_dtype="float32", fast_sine=True,
           synth_views=4, synth_img_size=24, synth_grid=24, testing_size=2,
           seed=4)
EVAL = dict(hm_samples=8, img_size=(16, 16), walk_size=16)
OUTPUT_KINDS = {"Height_Maps.png", "HM_scores.txt", "Image_scores.txt",
                "Time_Walk.gif", "Solar_Walk.gif"}
IMG_TOL = 1e-4
HM_TOL_M = 2e-4
SCORE_TOL = {"L2": 1e-5, "PSNR": 1e-4, "SSIM": 1e-5}
EM_RTOL = 2e-5


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
        jax.random.PRNGKey(3), pts[:2], sun[:2], t4[:2], train=False)
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
    return scene, list(test_idx)


@pytest.fixture(scope="module")
def jax_analysis(model_dir, tmp_path_factory):
    """The JAX package's analysis of the model directory -> (analysis,
    its output directory)."""
    out = str(tmp_path_factory.mktemp("jax_analysis"))
    loaded = j_load(model_dir)
    renderer = JRenderer(loaded.model, loaded.variables,
                         n_samples=CFG["n_samples"], chunk=CFG["chunk"])
    scene, test_idx = _site(j_synth)
    analysis = j_regional.analyze_model(
        renderer, loaded.model, loaded.variables, scene.cameras, test_idx,
        scene.hm, (0.0, 30.0), out, **EVAL)
    j_regional.write_analysis_outputs(analysis, os.path.join(out, "Output"))
    return analysis, out


def _key_tree(x):
    if isinstance(x, dict):
        return {k: _key_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_key_tree(v) for v in x]
    return type(x).__name__ if isinstance(x, (str, bool)) else "value"


def _close(got, want, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _compare(got, want):
    hm_g, hm_w = got["HM"], want["HM"]
    for part in ("Before", "After"):
        for k, v in hm_w[part].items():
            if k == "Shift_x_y_deg":
                assert hm_g[part][k] == v
            else:
                assert abs(hm_g[part][k] - v) <= HM_TOL_M, (part, k)
    for k, v in hm_w["Imgs"].items():
        _close(hm_g["Imgs"][k], v, HM_TOL_M, k)
    assert set(got["Images"]) == set(want["Images"])
    for name, e_w in want["Images"].items():
        e_g = got["Images"][name]
        assert set(e_g["Scores"]) == set(e_w["Scores"])
        for variant, s_w in e_w["Scores"].items():
            s_g = e_g["Scores"][variant]
            for i, m in enumerate(("L2", "PSNR", "SSIM")):
                assert abs(s_g[i] - s_w[i]) <= SCORE_TOL[m], (name, variant,
                                                              m)
            assert abs(s_g[3] - s_w[3]) <= EM_RTOL * abs(s_w[3]), (name,
                                                                   variant)
        assert e_g["Aligned_Vals"][2] == e_w["Aligned_Vals"][2], name
        _close(e_g["Aligned_Vals"][0], e_w["Aligned_Vals"][0], 1e-5, name)
        res_g, res_w = e_g["Result"], e_w["Result"]
        _close(res_g["Ground_Truth"], res_w["Ground_Truth"], 1e-5, name)
        for group in ("Images", "Seasonal_Aligned_Imgs"):
            for k in ("Season_Adj_Img", "Base_Img", "Shadow_Adjust"):
                _close(res_g[group][k], res_w[group][k], IMG_TOL,
                       f"{name} {group} {k}")
    for variant, cols in want["Image_Summary"].items():
        for m, stats in cols.items():
            for k, v in stats.items():
                g = got["Image_Summary"][variant][m][k]
                tol = (EM_RTOL * abs(v) if m == "EM" else SCORE_TOL[m])
                assert abs(g - v) <= tol, (variant, m, k)
    for g, w in zip(got["Solar_Walk"], want["Solar_Walk"]):
        _close(g, w, IMG_TOL, "Solar_Walk")
    np.testing.assert_array_equal(got["Season_Walk"]["times"],
                                  want["Season_Walk"]["times"])
    assert len(got["Season_Walk"]["imgs"]) == len(want["Season_Walk"]["imgs"])
    for g, w in zip(got["Season_Walk"]["imgs"], want["Season_Walk"]["imgs"]):
        _close(g, w, IMG_TOL, "Season_Walk")


def _compare_outputs(got_dir, want_dir, test_names):
    with open(os.path.join(got_dir, "Analysis.pickle"), "rb") as f:
        got = pickle.load(f)
    with open(os.path.join(want_dir, "Analysis.pickle"), "rb") as f:
        want = pickle.load(f)
    assert _key_tree(got) == _key_tree(want)
    _compare(got, want)
    names = set(os.listdir(os.path.join(got_dir, "Output")))
    assert names == set(os.listdir(os.path.join(want_dir, "Output")))
    assert names == OUTPUT_KINDS | {f"{n}_comparison.png"
                                    for n in test_names}


def test_analyze_model_matches_jax(model_dir, jax_analysis, tmp_path):
    want, want_dir = jax_analysis
    loaded = t_load(model_dir, device="cpu")
    renderer = TRenderer(loaded.model, n_samples=CFG["n_samples"],
                         chunk=CFG["chunk"])
    scene, test_idx = _site(t_synth)
    got = t_regional.analyze_model(renderer, renderer.model, scene.cameras,
                                   test_idx, scene.hm, (0.0, 30.0),
                                   str(tmp_path), **EVAL)
    t_regional.write_analysis_outputs(got, str(tmp_path / "Output"))
    assert all("Components" in e["Result"] for e in got["Images"].values())
    _compare(got, want)
    _compare_outputs(str(tmp_path), want_dir,
                     [scene.cameras[i].name for i in test_idx])


def test_run_test_eval_only_matches_jax(model_dir, jax_analysis, tmp_path):
    """``run_test(eval_only=True)`` on the JAX package's model directory
    (read by the port's codec) against the JAX ``analyze_model`` of it."""
    want, want_dir = jax_analysis
    logs = str(tmp_path / "model")
    shutil.copytree(model_dir, logs)
    cfg = TConfig.load_json(os.path.join(logs, "opts.json"))
    cfg.logs_dir = logs
    trainer, got = t_cli.run_test(cfg, eval_only=True,
                                  eval_img_size=EVAL["img_size"],
                                  eval_season_size=(8, 8), device="cpu")
    assert trainer is None
    _compare(got, want)
    scene, test_idx = _site(t_synth)
    _compare_outputs(logs, want_dir, [scene.cameras[i].name
                                      for i in test_idx])


def test_run_test_evaluates_the_selected_final_model(tmp_path, monkeypatch):
    """With ``best_geometry`` choosing an earlier save point, ``run_test``
    evaluates ``Final_Model.nn``'s weights, not the last step's."""
    report = TTrainer.validation_report

    def first_is_best(self, *a, **kw):
        # the earliest save point scores best, whatever was trained
        return dict(report(self, *a, **kw), Prior_Height_Error=float(
            self.step))
    monkeypatch.setattr(TTrainer, "validation_report", first_is_best)
    seen = {}
    analyze = t_regional.analyze_model

    def recording(renderer, model, *a, **kw):
        seen["sd"] = {k: v.clone() for k, v in model.state_dict().items()}
        return analyze(renderer, model, *a, **kw)
    monkeypatch.setattr(t_regional, "analyze_model", recording)
    cfg = get_opts(["--site_name", "SYNTH_SEL", "--exp_name", "sel",
                    "--IO_Location", str(tmp_path), "--max_train_steps", "4",
                    "--n_samples", "8", "--batch_size", "16",
                    "--fc_units", "32", "--synth_views", "3",
                    "--synth_img_size", "16", "--synth_grid", "16",
                    "--testing_size", "1", "--n_saves", "2",
                    "--compute_dtype", "float32",
                    "--final_model_selection", "best_geometry"])
    trainer, analysis = t_cli.run_test(cfg, eval_img_size=(8, 8),
                                       device="cpu")
    final, meta = t_state.load_model_artifact(
        os.path.join(cfg.logs_dir, "Final_Model.nn"))
    first = min(trainer.save_steps)
    assert meta["selected_step"] == first < trainer.step
    for k, v in final.items():
        assert torch.equal(seen["sd"][k], v), k
    last = trainer.model.state_dict()
    assert any(not torch.equal(last[k], v) for k, v in final.items())
    assert OUTPUT_KINDS <= set(os.listdir(os.path.join(cfg.logs_dir,
                                                       "Output")))
    assert np.isfinite(analysis["HM"]["After"]["RMSE"])
