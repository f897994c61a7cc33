"""The port's configuration helpers and image metrics against the JAX
package's, on the CPU.

- ``Config.adopt_resume_settings`` on the same log directory in the cases
  of ``tests/test_resume.py``: a resumed run (the recorded settings win,
  with the same warning), ``--no-resume``, a directory without
  checkpoints and one with only ``Model_0.nn``;
- ``apply_overrides`` on a table of overrides, the errors included;
- ``lite_defaults()`` field by field; ``get_opts``'s order (the recorded
  settings win before opts.json is written);
- ``cli train`` resumed under other flags keeps the recorded opts.json;
- ``ops/metrics.py``: ``psnr``, ``ssim``, ``ssim_global`` and
  ``pairwise_ssim_global`` against the JAX functions on the same random
  images, float32 on both sides: 1e-5 relative (sums in another order;
  the SSIM's variances are differences of window means), PSNR 1e-5.

About 20 s on one worker.
"""

import dataclasses
import functools
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from season_nerf_torch import cli as t_cli
from season_nerf_torch import config as t_config
from season_nerf_torch.ops import metrics as t_metrics
from season_nerf_tpu import config as j_config
from season_nerf_tpu.ops import metrics as j_metrics

torch.set_num_threads(1)


def _adopt(cls, **kw):
    """-> (the Config after adopt_resume_settings, the warnings' texts)."""
    cfg = cls(**kw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg.adopt_resume_settings()
    return dataclasses.asdict(cfg), [str(w.message) for w in caught]


def _run_dir(tmp_path, name, ckpts, **recorded):
    logs = str(tmp_path / name)
    os.makedirs(logs)
    t_config.Config(logs_dir=logs, **recorded).save_json()
    for step in ckpts:
        open(os.path.join(logs, f"Model_{step}.nn"), "wb").close()
    return logs


RECORDED = dict(compute_dtype="float32", fast_sine=False, fc_units=64,
                max_train_steps=50, lr=1e-3, pallas_trunk=True)


@pytest.mark.parametrize("case", ["resumed", "no_resume", "no_checkpoint",
                                  "only_step_0"])
def test_adopt_resume_settings_matches_jax(tmp_path, case):
    ckpts = {"resumed": [10, 30], "no_resume": [30], "no_checkpoint": [],
             "only_step_0": [0]}[case]
    logs = _run_dir(tmp_path, case, ckpts, **RECORDED)
    kw = dict(logs_dir=logs, max_train_steps=80, resume=case != "no_resume")
    got, got_warn = _adopt(t_config.Config, **kw)
    want, want_warn = _adopt(j_config.Config, **kw)
    assert got == want
    assert got_warn == want_warn
    adopted = case == "resumed"
    assert (got["compute_dtype"] == "float32") == adopted
    assert (got["fc_units"] == 64) == adopted
    assert got["max_train_steps"] == 80       # extending a run is allowed
    assert len(got_warn) == adopted
    if adopted:
        assert "recorded opts.json wins" in got_warn[0]


OVERRIDES = [
    ["fc_units=128", "lr=0.001", "exp_name=run2"],
    ["fast_sine=false", "pallas_trunk=YES", "jump_start=0", "resume=on"],
    ["height_range=none", "mesh_shape=4", "testing_image_names=a.txt"],
    ["mesh_shape=None", "testing_image_names=none"],
    ["max_train_steps=100", "geometry_decay_threshold=0.2"],
    ["final_model_selection=best_geometry", "compute_dtype=float32"],
    # errors
    ["fc_units"],
    ["no_such_field=1"],
    ["fast_sine=maybe"],
    ["lr=none"],
    ["fc_units=wide"],
]


@pytest.mark.parametrize("pairs", OVERRIDES, ids=[",".join(p) for p in
                                                   OVERRIDES])
def test_apply_overrides_matches_jax(pairs):
    def run(mod):
        try:
            return ("ok", dataclasses.asdict(
                mod.apply_overrides(mod.Config(), pairs)))
        except ValueError as e:
            return ("error", str(e))
    got, want = run(t_config), run(j_config)
    assert got == want


def test_lite_defaults_match_jax():
    got = dataclasses.asdict(t_config.lite_defaults())
    want = dataclasses.asdict(j_config.lite_defaults())
    assert got == want
    assert got["img_validation_downscale"] == 8


def test_get_opts_adopts_before_writing_opts_json(tmp_path):
    """A resumed experiment: the recorded settings win, and the opts.json
    written afterwards still holds them; the flags that are free (here
    max_train_steps) take the new values."""
    io = str(tmp_path)
    logs = os.path.join(io, "Logs", "run")
    os.makedirs(logs)
    t_config.Config(logs_dir=logs, **RECORDED).save_json()
    open(os.path.join(logs, "Model_30.nn"), "wb").close()
    with pytest.warns(UserWarning, match="recorded opts.json wins"):
        cfg = t_config.get_opts(["--IO_Location", io, "--exp_name", "run",
                                 "--max_train_steps", "80", "--fc_units",
                                 "32"], seed=5)
    assert (cfg.fc_units, cfg.compute_dtype, cfg.max_train_steps,
            cfg.seed) == (64, "float32", 80, 5)
    with open(os.path.join(logs, "opts.json")) as f:
        on_disk = json.load(f)
    assert on_disk == dataclasses.asdict(cfg)
    # lite defaults under the same entry point
    cfg = t_config.get_opts(["--IO_Location", io, "--exp_name", "lite"],
                            defaults=t_config.lite_defaults())
    assert cfg.img_training_downscale == 4 and cfg.max_train_steps == 5000


def test_get_opts_with_no_flags_keeps_every_default(tmp_path):
    """``get_opts([], defaults=cfg)`` is ``cfg`` with its directories
    resolved: how a program hands its own Config to ``cli.run_train``."""
    cfg = t_config.Config(IO_Location=str(tmp_path), exp_name="own",
                          fc_units=96, height_range=(2.0, 40.0),
                          compute_dtype="float32", jump_start=False)
    got = t_config.get_opts([], defaults=cfg)
    want = dataclasses.asdict(cfg.resolve_dirs())
    assert dataclasses.asdict(got) == want
    assert os.path.exists(os.path.join(got.logs_dir, "opts.json"))


@pytest.fixture
def small_eval(monkeypatch):
    """``cli train``/``lite`` end in ``run_test``'s evaluation, by default
    at 256 x 256 test renders and 128 px walks: a minute and more on one
    CPU thread.  These tests are about the training half, so it runs at
    8 px (``test_torch_analysis.py`` holds the evaluation)."""
    monkeypatch.setattr(t_cli, "run_test", functools.partial(
        t_cli.run_test, eval_img_size=(8, 8)))


def _train(io, *flags):
    return t_cli.main(["train", "--site_name", "SYNTH_R", "--exp_name", "r",
                       "--IO_Location", io, "--n_samples", "8",
                       "--batch_size", "16", "--synth_views", "3",
                       "--synth_img_size", "16", "--synth_grid", "16",
                       "--testing_size", "1", "--n_saves", "1",
                       "--device", "cpu", *flags])


def test_cli_train_resumed_under_other_flags_keeps_its_record(tmp_path,
                                                              small_eval):
    io = str(tmp_path)
    assert _train(io, "--max_train_steps", "2", "--fc_units", "32",
                  "--compute_dtype", "float32") == 0
    logs = os.path.join(io, "Logs", "r")
    with pytest.warns(UserWarning, match="recorded opts.json wins"):
        assert _train(io, "--max_train_steps", "4", "--fc_units", "64",
                      "--compute_dtype", "bfloat16", "--no-fast_sine") == 0
    with open(os.path.join(logs, "opts.json")) as f:
        opts = json.load(f)
    assert (opts["fc_units"], opts["compute_dtype"], opts["fast_sine"],
            opts["max_train_steps"]) == (32, "float32", True, 4)
    assert os.path.exists(os.path.join(logs, "Model_4.nn"))
    # the validation scalars of both runs: every save point and the report
    # after finalize()
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = {r["step"] for r in recs if r["tag"] == "Testing/Mean_PSNR"}
    assert steps == {2, 4}
    assert any(r["tag"] == "Testing/Total" and r["step"] == 4 for r in recs)


def test_lite_subcommand_trains_with_the_lite_defaults(tmp_path,
                                                       small_eval):
    io = str(tmp_path)
    rc = t_cli.main(["lite", "--site_name", "SYNTH_L", "--IO_Location", io,
                     "--max_train_steps", "2", "--n_samples", "8",
                     "--batch_size", "16", "--fc_units", "32",
                     "--synth_views", "3", "--synth_img_size", "16",
                     "--synth_grid", "16", "--testing_size", "1",
                     "--device", "cpu"])
    assert rc == 0
    with open(os.path.join(io, "Logs", "OMA_281_Lite", "opts.json")) as f:
        opts = json.load(f)
    lite = dataclasses.asdict(t_config.lite_defaults())
    for k in ("lr", "n_saves", "img_training_downscale",
              "img_validation_downscale"):
        assert opts[k] == lite[k], k


# --- ops/metrics.py -----------------------------------------------------------
@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, (40, 33, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    mask = rng.uniform(size=(40, 33)) > 0.1
    mask[:6] = False
    return a, b, mask


def _both(fn, *arrays, **kw):
    got = getattr(t_metrics, fn)(*[torch.from_numpy(np.asarray(x))
                                   for x in arrays], **kw)
    want = getattr(j_metrics, fn)(*[jnp.asarray(x) for x in arrays], **kw)
    return np.asarray(got), np.asarray(want)


@pytest.mark.parametrize("masked", [False, True])
def test_psnr_and_ssim_match_jax(images, masked):
    a, b, mask = images
    extra = (mask,) if masked else ()
    for fn in ("psnr", "ssim"):
        got, want = _both(fn, a, b, *extra)
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=fn)
    got, want = _both("ssim", a[..., 0], b[..., 0], *extra, win_size=7)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_global_ssims_match_jax(images):
    a, b, _ = images
    got, want = _both("ssim_global", a, b)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    stack = np.stack([a, b, a[::-1], b * 0.5])
    got, want = _both("pairwise_ssim_global", stack)
    assert got.shape == (4, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
