"""The port's evaluation tools against their JAX twins on one run
directory that the JAX package wrote: ``select_best_geometry``,
``time_to_quality``, ``fast_render_ab`` and ``failure_analysis``.

The directory is a synthetic site (4 views of 16 px, width 32, float32
with the exact sine) with three full-state JAX checkpoints, each with
weights of its own and BatchNorm statistics from a train-mode pass, the
last also as ``Final_Model.nn``, and a ``metrics.jsonl`` timeline.  Both
packages only read it: the port reads the JAX checkpoints through its own
codec and weight bridge (``train/state.py::load_weights``).

Tolerances: float32 renders of the two packages differ by the fold's
re-association (~3e-6 on x_enc, ``tests/test_torch_render.py`` holds
images to 1e-4).  The tools round what they print (PSNR to 2-3 decimals,
SSIM and agreement shares to 4, meters to 3-4), so a value is held to one
unit of its last printed digit, and a selection (the chosen step) exactly.

About 60 s on one worker, most of it the JAX tools' compiles."""

import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from season_nerf_torch.tools import (failure_analysis, fast_render_ab,
                                     select_best_geometry, time_to_quality)
from season_nerf_tpu import cli as j_cli
from season_nerf_tpu.config import Config as JConfig
from season_nerf_tpu.train import phases as j_phases
from season_nerf_tpu.train import state as j_state
from season_nerf_tpu.train.engine import Trainer as JTrainer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
STEPS = (2, 4, 6)


def _jax_tool(name):
    sys.path.insert(0, str(ROOT))
    try:
        import importlib
        return importlib.import_module(f"tools.{name}")
    finally:
        sys.path.remove(str(ROOT))


def _run_jax(name, argv, monkeypatch, capsys):
    """A JAX tool's ``main()`` (it reads ``sys.argv``) -> its stdout."""
    module = _jax_tool(name)
    monkeypatch.setattr(sys, "argv", [module.__file__] + list(argv))
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    io = tmp_path_factory.mktemp("jax_run")
    cfg = JConfig(site_name="SYNTH_TW", exp_name="tw", IO_Location=str(io),
                  fc_units=32, fc_layers=2, n_samples=8, batch_size=64,
                  max_train_steps=STEPS[-1], n_saves=2, synth_views=4,
                  synth_img_size=16, synth_grid=16, testing_size=1,
                  compute_dtype="float32", fast_sine=False, chunk=256,
                  mesh_shape=1, save_point_val_renders=0)
    cfg.resolve_dirs()
    cfg.save_json()
    _, table, tr_i, te_i, prior, gt, _, _, _ = j_cli._prepare_synthetic(cfg)
    jtr = JTrainer(cfg, table.split(np.array(tr_i)),
                   table.split(np.array(te_i)), prior_hm=prior, gt_dsm=gt)
    model = jtr.model
    init = jax.jit(model.init, static_argnames="train")
    stats = jax.jit(lambda v, *a: model.apply(
        v, *a, train=True, mutable=["batch_stats"])[1])
    pts = jax.random.uniform(jax.random.PRNGKey(9), (512, 3), minval=-1,
                             maxval=1)
    lines = []
    for i, step in enumerate(STEPS):
        v = init(jax.random.PRNGKey(10 + i), jnp.zeros((2, 3)),
                 jnp.zeros((2, 3)), jnp.zeros((2, 4)), train=False)
        upd = stats(v, pts, jnp.ones((512, 3)) / 3 ** 0.5,
                    jnp.ones((512, 4)))
        # the optimizer templates of the phase a resume at ``step`` builds
        jtr._enter_phase(j_phases.phase_at(jtr.phases, step - 1))
        state = jtr.state._replace(params=v["params"],
                                   batch_stats=upd["batch_stats"])
        j_state.save_checkpoint(f"{cfg.logs_dir}/Model_{step}.nn", state,
                                extra={"step": step})
        lines += [{"t": 1000.0 + 40.0 * step + k, "tag": "Testing/Loss",
                   "value": 0.5, "step": step} for k in range(2)]
    j_state.save_model_artifact(f"{cfg.logs_dir}/Final_Model.nn",
                                v["params"], upd["batch_stats"], meta={})
    with open(f"{cfg.logs_dir}/metrics.jsonl", "a") as f:
        f.write("".join(json.dumps(ln) + "\n" for ln in lines))
    return cfg.logs_dir


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+", line)]


def test_select_best_geometry_equals_jax(run_dir, monkeypatch, capsys):
    want = _run_jax("select_best_geometry", [run_dir], monkeypatch, capsys)
    rows = select_best_geometry.main([run_dir, "--device", "cpu"])
    got = capsys.readouterr().out
    assert _json_lines(got) == rows
    jrows = _json_lines(want)
    assert [r["step"] for r in rows] == [r["step"] for r in jrows] == \
        list(STEPS)
    for g, w in zip(rows, jrows):
        for k in ("prior_mae", "gt_mae", "psnr"):
            assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-4), (k, g, w)
    pick = lambda text: re.search(r"step (\d+) \(prior", text).group(1)
    assert pick(got) == pick(want)
    for label in ("best_geometry:", "last (reference protocol):"):
        g = next(ln for ln in got.splitlines() if ln.startswith(label))
        w = next(ln for ln in want.splitlines() if ln.startswith(label))
        np.testing.assert_allclose(_numbers(g), _numbers(w), atol=1e-3,
                                   err_msg=label)


def test_time_to_quality_equals_jax(run_dir, monkeypatch, capsys, tmp_path):
    """At 8 px, 8 samples and a 12-cell height grid (the scene's 16 cells
    shrunk by area at a non-integer ratio: cv2 against the port's own)."""
    args = ["--size", "8", "--samples", "8", "--hm_grid", "12"]
    _run_jax("time_to_quality", [run_dir, "-o", str(tmp_path / "j.json")]
             + args, monkeypatch, capsys)
    want = json.loads((tmp_path / "j.json").read_text())
    got = time_to_quality.main([run_dir, "-o", str(tmp_path / "t.json"),
                                "--device", "cpu"] + args)
    assert json.loads((tmp_path / "t.json").read_text()) == got
    assert got["protocol"] == want["protocol"]
    assert got["run_dir"] == want["run_dir"]
    assert got["bands"] == want["bands"]
    assert len(got["curve"]) == len(want["curve"]) == len(STEPS)
    for g, w in zip(got["curve"], want["curve"]):
        assert set(g) == set(w)
        assert (g["step"], g["wall_minutes"]) == (w["step"],
                                                  w["wall_minutes"])
        for k, unit in (("aligned_psnr", 1e-3), ("aligned_ssim", 1e-4),
                        ("dsm_mae_m", 1e-3), ("dsm_mae_aligned_m", 1e-3),
                        ("dsm_acc_1m", 1e-4)):
            assert abs(g[k] - w[k]) <= unit + 1e-9, (k, g, w)


def test_fast_render_ab_equals_jax(run_dir, monkeypatch, capsys, tmp_path):
    args = ["--Model_Location", run_dir, "--size", "8", "--views", "2",
            "--coarse", "8", "--fine", "8", "--grid"]
    _run_jax("fast_render_ab", args + ["--output", str(tmp_path / "j")],
             monkeypatch, capsys)
    want = json.loads((tmp_path / "j").read_text())
    got = json.loads(json.dumps(fast_render_ab.main(
        args + ["--output", str(tmp_path / "t"), "--device", "cpu"])))
    assert json.loads((tmp_path / "t").read_text()) == got
    assert set(got) == set(want)
    for k in ("metric", "n_frames", "config", "grid"):
        assert got[k] == want[k], k
    for k, unit in (("psnr_fast_vs_exact", 1e-2), ("ssim_fast_vs_exact", 1e-4),
                    ("dsm_mae_m_fast_vs_exact", 1e-4),
                    ("shadow_mask_agreement", 1e-4),
                    ("exact_shadow_mask_agreement", 1e-4)):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=unit + 1e-9, err_msg=k)
    for k in ("min_psnr", "max_dsm_mae_m", "min_shadow_agreement",
              "min_exact_shadow_agreement"):
        assert abs(got["summary"][k] - want["summary"][k]) <= 1e-2, k
    for k in ("exact_rays_per_sec", "fast_rays_per_sec", "speedup"):
        assert got[k] > 0


def test_failure_analysis_equals_jax(run_dir, monkeypatch, capsys,
                                     tmp_path):
    _run_jax("failure_analysis", [run_dir, "--size", "8", "-o",
                                  str(tmp_path / "j.json")],
             monkeypatch, capsys)
    want = json.loads((tmp_path / "j.json").read_text())
    got = failure_analysis.main([run_dir, "--size", "8", "-o",
                                 str(tmp_path / "t.json"), "--device", "cpu"])
    assert json.loads((tmp_path / "t.json").read_text()) == got
    assert (got["run_dir"], got["size"]) == (want["run_dir"], want["size"])
    assert len(got["per_camera"]) == len(want["per_camera"]) == 1
    for g, w in zip(got["per_camera"], want["per_camera"]):
        assert set(g) == set(w)
        for k in w:
            if k.startswith(("mse_", "ssim_")) and w[k] is not None:
                unit = 1e-5 if k.startswith("mse_") else 1e-4
                assert abs(g[k] - w[k]) <= unit + 1e-9, (k, g[k], w[k])
            else:
                assert g[k] == w[k], k
