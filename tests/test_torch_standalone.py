"""The port stands alone: no module of ``season_nerf_torch``, and not
``chip_smoke.py``, imports JAX, the JAX package, or a package outside the
port's import rule (msgpack, PIL, matplotlib, cv2, imageio, tabulate,
tensorboard; scipy is inside it: the port calls it where the JAX package
does).  Checked statically over every source file, then on the CPU in a
fresh interpreter in which importing any of them raises: by rendering (the
uniform and the depth-guided fast render), by training two steps (and two
with hierarchical sampling), by evaluating a model into ``Analysis.pickle``
and ``Output/``, by ``cli.eval_region`` (``run_test`` with ``eval_only``,
``regional_eval`` into ``Detailed_Output/``, ``multi_region_merge`` into
``Full_Summary/``), and by the tools: a reference checkpoint converted, a
movie made from it, and TensorBoard records written; a render program
exported and loaded back, the fast-render A/B, the concurrent-client bench,
the quality report."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack", "PIL", "matplotlib",
          "cv2", "imageio", "tabulate", "tensorboard", "tensorflow",
          "season_nerf_tpu")
SOURCES = sorted((ROOT / "season_nerf_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_banned_import_in_source(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


BLOCK = textwrap.dedent("""
    import importlib, importlib.abc, importlib.util, pkgutil, sys, tempfile
    import os
    BANNED = set(sys.argv[2].split(","))

    class Refuse(importlib.abc.Loader):
        def create_module(self, spec):
            return None

        def exec_module(self, module):
            raise ImportError(f"blocked import of {module.__name__}")

    class Block(importlib.abc.MetaPathFinder):
        # a banned module is found (torch probes some with find_spec) and
        # refuses to load: importing it raises
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED:
                return importlib.util.spec_from_loader(name, Refuse())
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import season_nerf_torch
    for m in pkgutil.walk_packages(season_nerf_torch.__path__,
                                   "season_nerf_torch."):
        importlib.import_module(m.name)
""")

SCRIPT = BLOCK + textwrap.dedent("""
    from season_nerf_torch.config import Config
    from season_nerf_torch.data.ingest import save_world_artifact
    from season_nerf_torch.models.tnerf import model_from_config
    from season_nerf_torch.render.loading import load_model_dir
    from season_nerf_torch.render.serving import RenderService, png_bytes
    from season_nerf_torch.train.state import save_model_artifact

    d = tempfile.mkdtemp()
    cfg = Config(site_name="standalone", fc_units=32, fc_layers=2,
                 n_samples=8, chunk=40)
    cfg.save_json(os.path.join(d, "opts.json"))
    torch.manual_seed(0)
    save_model_artifact(os.path.join(d, "Final_Model.nn"),
                        model_from_config(cfg).state_dict())
    save_world_artifact(os.path.join(d, "W2C_W2L_H.npy"), None, None,
                        (0.0, 30.0))
    r = load_model_dir(d, device="cpu").renderer
    out = r.render_img((70.0, 30.0), (45.0, 160.0), 0.4, 8,
                       exact_shadow=True)
    assert out["Col_Img"].shape == (8, 8, 3)
    for k in ("Col_Img", "Shadow_Mask", "Exact_Shadow_Mask", "PS_Sum"):
        assert np.isfinite(out[k]).all(), k
    svc = RenderService(d, device="cpu")
    assert png_bytes(svc.render_view((70, 30), (45, 160), 0.4, size=8)
                     )[:8] == b"\\x89PNG\\r\\n\\x1a\\n"
    dsm, units = svc.dsm(8)
    assert dsm.shape == (8, 8) and units == "meters"
    fast = RenderService(d, fast_render=(8, 4), device="cpu")
    assert fast.info()["fast_render"] == [8, 4]
    for exact in (False, True):
        img = fast.render_view((70, 30), (45, 160), 0.4, size=8,
                               exact_shadow=exact)
        assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    loaded = sorted(k for k in sys.modules if k.split(".")[0] in BANNED)
    assert not loaded, loaded
    print("RENDERED")
""")


TRAIN_SCRIPT = BLOCK + textwrap.dedent("""
    from season_nerf_torch.config import Config
    from season_nerf_torch.data.synthetic import make_scene, scene_ray_tables
    from season_nerf_torch.train.engine import Trainer

    scene = make_scene(n_views=3, img_size=16, grid=16, seed=0)
    train_table, _ = scene_ray_tables(scene, testing_size=1)
    cfg = Config(fc_units=32, batch_size=16, n_samples=8,
                 max_train_steps=10, compute_dtype="float32")
    trainer = Trainer(cfg, train_table, prior_hm=scene.prior_hm,
                      device="cpu")
    for _ in range(2):
        loss = trainer.train_step()
        assert all(bool(torch.isfinite(v)) for v in loss.values()), loss
    assert "Alpha_Adjust_ada" in loss
    cfg.n_importance = 4
    trainer = Trainer(cfg, train_table, prior_hm=scene.prior_hm,
                      device="cpu")
    for _ in range(2):
        loss = trainer.train_step()
        assert all(bool(torch.isfinite(v)) for v in loss.values()), loss
    assert trainer.statics.n_importance == 4
    loaded = sorted(k for k in sys.modules if k.split(".")[0] in BANNED)
    assert not loaded, loaded
    print("TRAINED")
""")


ANALYSIS_SCRIPT = BLOCK + textwrap.dedent("""
    from season_nerf_torch.config import Config
    from season_nerf_torch.data.synthetic import make_scene
    from season_nerf_torch.eval.regional import (analyze_model,
                                                 write_analysis_outputs)
    from season_nerf_torch.models.tnerf import model_from_config
    from season_nerf_torch.render.renderer import Renderer

    d = tempfile.mkdtemp()
    scene = make_scene(n_views=3, img_size=16, grid=12, seed=0)
    torch.manual_seed(0)
    r = Renderer(model_from_config(Config(fc_units=32, fc_layers=2)),
                 n_samples=8, chunk=64)
    analysis = analyze_model(r, r.model, scene.cameras, [2], scene.hm,
                             (0.0, 30.0), d, hm_samples=8, img_size=(8, 8),
                             walk_size=8)
    write_analysis_outputs(analysis, os.path.join(d, "Output"))
    assert sorted(os.listdir(os.path.join(d, "Output"))) == [
        "HM_scores.txt", "Height_Maps.png", "Image_scores.txt",
        "Solar_Walk.gif", "Time_Walk.gif", "synth_02_comparison.png"]
    assert os.path.exists(os.path.join(d, "Analysis.pickle"))
    assert np.isfinite(analysis["HM"]["After"]["RMSE"])
    loaded = sorted(k for k in sys.modules if k.split(".")[0] in BANNED)
    assert not loaded, loaded
    print("EVALUATED")
""")


REGIONAL_SCRIPT = BLOCK + textwrap.dedent("""
    import functools
    from season_nerf_torch import cli
    from season_nerf_torch.config import Config
    from season_nerf_torch.data.ingest import save_world_artifact
    from season_nerf_torch.models.tnerf import model_from_config
    from season_nerf_torch.train.state import save_model_artifact

    d = os.path.join(tempfile.mkdtemp(), "Region_S")
    os.makedirs(d)
    cfg = Config(site_name="SYNTH_S", fc_units=32, fc_layers=2, n_samples=8,
                 chunk=64, synth_views=3, synth_img_size=16, synth_grid=12,
                 testing_size=1, compute_dtype="float32")
    cfg.save_json(os.path.join(d, "opts.json"))
    torch.manual_seed(0)
    save_model_artifact(os.path.join(d, "Final_Model.nn"),
                        model_from_config(cfg).state_dict())
    save_world_artifact(os.path.join(d, "W2C_W2L_H.npy"), None, None,
                        (0.0, 30.0))
    # the evaluation at 8 px: its default sizes take minutes on one thread
    cli.run_test = functools.partial(cli.run_test, eval_img_size=(8, 8),
                                     eval_season_size=(8, 8))
    out = cli.eval_region([d], device="cpu")
    assert sorted(os.listdir(out)) == [
        "All_HM_scores.txt", "All_Image_scores.txt", "All_Season_scores.txt",
        "All_Shadow_scores.txt", "Merged_Results.pickle"], os.listdir(out)
    assert "Region_Results.pickle" in os.listdir(
        os.path.join(d, "Detailed_Output"))
    loaded = sorted(k for k in sys.modules if k.split(".")[0] in BANNED)
    assert not loaded, loaded
    print("REGIONAL")
""")


TOOLS_SCRIPT = BLOCK + textwrap.dedent("""
    from season_nerf_torch.config import Config
    from season_nerf_torch.geometry.solar import solar_el_az_utc
    from season_nerf_torch.models.tnerf import TNeRF
    from season_nerf_torch.tools import convert_reference_model, make_movie
    from season_nerf_torch.utils.logging import MetricWriter

    d = tempfile.mkdtemp()
    torch.manual_seed(0)
    ref = TNeRF(layer_width=32, n_classes=2)
    torch.save(ref, os.path.join(d, "module.pt"))
    convert_reference_model.main(
        ["--torch_model", os.path.join(d, "module.pt"), "--fc_units", "32",
         "--n_classes", "2", "--out", os.path.join(d, "Final_Model.nn")])
    cfg = Config(fc_units=32, number_low_frequency_cases=2, n_samples=8,
                 chunk=64)
    cfg.save_json(os.path.join(d, "opts.json"))
    path = make_movie.main(["--Model_Location", d, "--frames", "3",
                            "--size", "8", "--out",
                            os.path.join(d, "movie.mp4"), "--device", "cpu"])
    assert path.endswith("movie.gif") and os.path.getsize(path) > 0
    w = MetricWriter(os.path.join(d, "logs"))
    w.scalar("Testing/Mean_PSNR", 20.5, 3)
    w.image("Testing/render_0", np.full((4, 4, 3), 0.5), 3)
    w.close()
    assert any(f.startswith("events.out.tfevents.")
               for f in os.listdir(os.path.join(d, "logs")))
    el, az = solar_el_az_utc(39.0, -77.0, 2020, 6, 21, 17, 0)
    assert 0 < el < 90 and 0 <= az < 360
    loaded = sorted(k for k in sys.modules if k.split(".")[0] in BANNED)
    assert not loaded, loaded
    print("TOOLS")
""")


RUN_TOOLS_SCRIPT = BLOCK + textwrap.dedent("""
    import json
    from season_nerf_torch.config import Config
    from season_nerf_torch.models.tnerf import model_from_config
    from season_nerf_torch.tools import (bench_serving_concurrent,
                                         export_render, fast_render_ab,
                                         quality_report, time_to_quality)
    from season_nerf_torch.train.state import save_model_artifact

    d = tempfile.mkdtemp()
    cfg = Config(site_name="tools", fc_units=32, fc_layers=2, n_samples=8,
                 chunk=64)
    cfg.save_json(os.path.join(d, "opts.json"))
    torch.manual_seed(0)
    save_model_artifact(os.path.join(d, "Final_Model.nn"),
                        model_from_config(cfg).state_dict())
    out = export_render.main([d, "--check", "--device", "cpu",
                              "--fast_render", "8", "8"])
    assert json.load(open(out + ".json"))["fast_render"] == [8, 8]
    ab = fast_render_ab.main(["--Model_Location", d, "--size", "8",
                              "--views", "1", "--coarse", "8", "--fine",
                              "8", "--device", "cpu"])
    assert len(ab["psnr_fast_vs_exact"]) == 1
    levels = bench_serving_concurrent.main([d, "--size", "8", "--clients",
                                            "1", "--requests", "1",
                                            "--device", "cpu"])["levels"]
    assert levels[0]["errors"] == 0
    assert "Quality report" in quality_report.build_report(d)
    small = time_to_quality.area_resize(np.ones((16, 16)), (12, 12))
    assert np.allclose(small, 1.0)
    loaded = sorted(k for k in sys.modules if k.split(".")[0] in BANNED)
    assert not loaded, loaded
    print("RUN TOOLS")
""")


def _run_blocked(script, word):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-I", "-c", script, str(ROOT), ",".join(BANNED)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith(word)


def test_port_renders_with_jax_and_the_jax_package_blocked():
    _run_blocked(SCRIPT, "RENDERED")


def test_port_trains_with_jax_and_the_jax_package_blocked():
    _run_blocked(TRAIN_SCRIPT, "TRAINED")


def test_port_evaluates_with_jax_and_the_jax_package_blocked():
    _run_blocked(ANALYSIS_SCRIPT, "EVALUATED")


def test_port_evaluates_regions_with_jax_and_the_jax_package_blocked():
    _run_blocked(REGIONAL_SCRIPT, "REGIONAL")


def test_port_tools_run_with_jax_and_imaging_packages_blocked():
    """~10 s on one worker."""
    _run_blocked(TOOLS_SCRIPT, "TOOLS")


def test_port_run_tools_run_with_jax_and_imaging_packages_blocked():
    """The export (and its round-trip check), the fast-render A/B, the
    concurrent-client bench, the quality report and the area resize; ~15 s
    on one worker."""
    _run_blocked(RUN_TOOLS_SCRIPT, "RUN TOOLS")
