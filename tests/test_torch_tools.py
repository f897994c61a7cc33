"""The port's run tools (``season_nerf_torch/tools/``) against the JAX
package's (``tools/``), on the same inputs.

- ``quality_report`` and ``report_metrics``: the same markdown and metrics
  as the JAX tools, byte for byte, on a run directory the port wrote
  (``run_regions``' site) and on fabricated tables (host text parsing).
- ``fast_sine_parity``: the same report as the JAX tool over finished arms
  (both only read); an arm trains through ``cli.run_test`` with the JAX
  tool's config (``cli.run_test`` recorded, not run: the port's training
  RNG differs from JAX's by design, so a trained arm is no twin).
- ``time_to_quality``: ``wall_clock_map`` and ``compute_bands`` equal to
  the JAX tool's; the area resize against ``cv2.INTER_AREA`` at integer and
  non-integer ratios (1e-12: float64 against OpenCV's float64 sums of
  float32 weights).
- ``watchdog_train`` as ``tests/test_extras.py`` tests the JAX one: a
  stalled child killed and launched again.
- ``run_regions``: one synthetic site trained 4 steps and evaluated at 8
  px, then merged: the files and tables written (structure: training).
- ``serve_render``: the module answers ``/healthz`` and ``/render`` on the
  CPU; ``bench_serving_concurrent`` at 1 and 2 clients on the CPU (the JAX
  tool's JSON keys, and ``max_s``).
- ``run_flagship.sh``: the command it runs, with a stand-in ``python``.

About 45 s on one worker (``run_regions``' training and evaluation
~20 s, the serving tools ~10 s)."""

import functools
import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from season_nerf_torch import cli as t_cli
from season_nerf_torch.config import Config as TConfig
from season_nerf_torch.models.tnerf import model_from_config
from season_nerf_torch.tools import (bench_serving_concurrent,
                                     fast_sine_parity, quality_report,
                                     report_metrics, run_regions,
                                     serve_render, time_to_quality)
from season_nerf_torch.train.state import save_model_artifact

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _jax_tool(name):
    sys.path.insert(0, str(ROOT))
    try:
        import importlib
        return importlib.import_module(f"tools.{name}")
    finally:
        sys.path.remove(str(ROOT))


def _run_main(module, argv, monkeypatch, capsys):
    """A JAX tool's ``main()`` (it reads ``sys.argv``) -> its stdout."""
    monkeypatch.setattr(sys, "argv", [module.__file__] + list(argv))
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


# --- a site through run_regions: the port's tables ------------------------
@pytest.fixture(scope="module")
def regions(tmp_path_factory):
    io = tmp_path_factory.mktemp("regions")
    mp = pytest.MonkeyPatch()
    mp.setattr(t_cli, "run_test", functools.partial(
        t_cli.run_test, eval_img_size=(8, 8), eval_season_size=(8, 8)))
    try:
        out = run_regions.main([
            "--IO_Location", str(io), "--sites", "SYNTH_RA",
            "--max_train_steps", "4", "--device", "cpu", "--set",
            "fc_units=32", "fc_layers=2", "n_samples=8", "batch_size=64",
            "synth_views=4", "synth_img_size=16", "synth_grid=16",
            "testing_size=1", "n_saves=2", "compute_dtype=float32",
            "chunk=256", "save_point_val_renders=0"])
    finally:
        mp.undo()
    return io, out


def test_run_regions_trains_evaluates_and_merges(regions):
    io, out = regions
    assert out == str(io / "Logs" / "Full_Summary")
    assert sorted(os.listdir(out)) == [
        "All_HM_scores.txt", "All_Image_scores.txt", "All_Season_scores.txt",
        "All_Shadow_scores.txt", "Merged_Results.pickle"]
    run = io / "Logs" / "SYNTH_RA_sweep"
    opts = json.loads((run / "opts.json").read_text())
    assert opts["site_name"] == "SYNTH_RA" and opts["fc_units"] == 32
    assert opts["max_train_steps"] == 4
    for f in ("Final_Model.nn", "Model_4.nn", "metrics.jsonl",
              "Output/Image_scores.txt", "Detailed_Output/HM_scores.txt",
              "Detailed_Output/Region_Results.pickle"):
        assert (run / f).exists(), f


def test_quality_report_equals_jax_on_a_port_run(regions, tmp_path):
    io, _ = regions
    run = str(io / "Logs" / "SYNTH_RA_sweep")
    want = _jax_tool("quality_report").build_report(run)
    assert quality_report.build_report(run) == want
    assert "## Height-map accuracy" in want
    out = tmp_path / "report.md"
    assert quality_report.main([run, "-o", str(out)]) == want
    assert out.read_text() == want
    assert report_metrics.arm_metrics(run) == \
        _jax_tool("report_metrics").arm_metrics(run)


def _fabricated_run(d: Path, psnr: float, mae: float):
    (d / "Output").mkdir(parents=True)
    (d / "Detailed_Output").mkdir()
    (d / "opts.json").write_text(json.dumps(
        {"exp_name": d.name, "max_train_steps": 10, "batch_size": 64,
         "n_samples": 8, "fc_units": 32, "fc_layers": 8,
         "site_name": "SYNTH_X", "synth_views": 4}))
    (d / "metrics.jsonl").write_text("".join(
        json.dumps({"t": 1000.0 + 3.5 * s, "tag": "Training/Loss",
                    "value": 0.1, "step": s}) + "\n" for s in range(0, 40, 2)))
    (d / "Output" / "Image_scores.txt").write_text(
        "Image quality by variant\n\n"
        "Variant               PSNR avg    PSNR best    PSNR worst    SSIM avg    EM avg    L2 avg\n"
        "------------------  ----------  -----------  ------------  ----------  --------  --------\n"
        f"Aligned_Shadow_Img     {psnr:.4f}      19.5000       16.2000      0.7700    0.1200    0.0500\n"
        "\nLaTeX:\nAligned_Shadow_Img & 18.01 \\\\\n")
    (d / "Detailed_Output" / "HM_scores.txt").write_text(
        "Height-map accuracy (meters)\n\n"
        "Variant            MAE    RMSE    Acc<=1m    Median\n"
        "--------------  ------  ------  ---------  --------\n"
        f"NeRF (aligned)  {mae:.4f}  1.6000     0.5600    0.8700\n")
    for name in ("Shadow_scores.txt", "Season_scores.txt"):
        (d / "Detailed_Output" / name).write_text(
            "Scores\n\nVariant    A    B\n-------  ---  ---\nx  0.5  0.25\n")


def test_quality_report_equals_jax_on_fabricated_tables(tmp_path):
    d = tmp_path / "run"
    _fabricated_run(d, 18.01, 1.18)
    want = _jax_tool("quality_report").build_report(str(d))
    assert quality_report.build_report(str(d)) == want
    assert "camera-rays/s" in want and "PSNR 18.01" in want


def test_fast_sine_parity_report_equals_jax_over_finished_arms(
        tmp_path, monkeypatch, capsys):
    io = tmp_path / "fsp"
    for name, psnr, mae in (("exact_sin", 18.01, 1.18),
                            ("fast_sine", 18.25, 1.11)):
        _fabricated_run(io / "Logs" / f"parity_{name}", psnr, mae)
    argv = ["--io", str(io), "--steps", "10", "--arms", "exact_sin",
            "fast_sine"]
    want = _run_main(_jax_tool("fast_sine_parity"), argv, monkeypatch,
                     capsys)
    got = fast_sine_parity.main(argv + ["--device", "cpu"])
    table = lambda text: [ln for ln in text.splitlines()
                          if ln.startswith(("|", "{"))]
    assert table(got) == table(want)[2:]            # the JSON lines first
    assert table(want)[:2] == [json.dumps(
        {n: {**report_metrics.arm_metrics(str(io / "Logs" / f"parity_{n}")),
             "wall_min": float("nan")}}) for n in ("exact_sin", "fast_sine")]


def test_fast_sine_parity_trains_an_arm_through_run_test(tmp_path,
                                                         monkeypatch):
    """An unfinished arm: ``cli.run_test`` gets the JAX tool's config with
    the arm's overrides, on the device asked for."""
    seen = []

    def run_test(cfg, device):
        seen.append((cfg, device))
        _fabricated_run(Path(cfg.logs_dir + "_tables"), 17.5, 1.3)
        for sub in ("Output", "Detailed_Output"):
            os.replace(os.path.join(cfg.logs_dir + "_tables", sub),
                       os.path.join(cfg.logs_dir, sub))

    monkeypatch.setattr(t_cli, "run_test", run_test)
    fast_sine_parity.main(["--io", str(tmp_path), "--steps", "7", "--batch",
                           "64", "--n_samples", "8", "--fc", "32", "--arms",
                           "fast_bf16_s1", "--device", "cpu"])
    (cfg, device), = seen
    assert device == "cpu"
    assert (cfg.exp_name, cfg.site_name) == ("parity_fast_bf16_s1",
                                             "SYNTH_PARITY")
    assert (cfg.fast_sine, cfg.compute_dtype, cfg.seed) == (True, "bfloat16",
                                                            1)
    assert (cfg.max_train_steps, cfg.batch_size, cfg.fc_units, cfg.n_saves,
            cfg.testing_size, cfg.synth_views, cfg.save_point_val_renders,
            cfg.chunk) == (7, 64, 32, 4, 3, 14, 0, 2560)
    assert json.loads((Path(cfg.logs_dir) / "opts.json").read_text())[
        "seed"] == 1
    assert set(fast_sine_parity.ARMS) == set(
        _jax_tool("fast_sine_parity").ARMS)
    for name, arm in fast_sine_parity.ARMS.items():
        assert arm == _jax_tool("fast_sine_parity").ARMS[name]


def test_wall_clock_map_and_bands_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    t = 1000 + np.cumsum(rng.uniform(0.1, 5.0, 60))
    t[30:] += 900.0                                 # a restart's gap
    steps = np.repeat(np.arange(30) * 10, 2)
    (tmp_path / "metrics.jsonl").write_text(
        "".join(json.dumps({"t": float(a), "tag": "Testing/x", "step": int(s),
                            "value": 1.0}) + "\n"
                for a, s in zip(t, steps)) + "not json\n")
    jt = _jax_tool("time_to_quality")
    want = jt.wall_clock_map(str(tmp_path))
    assert time_to_quality.wall_clock_map(str(tmp_path)) == want
    curve = [{"wall_minutes": m, "dsm_mae_m": a, "dsm_mae_aligned_m": b}
             for m, a, b in ((1.0, 2.0, 1.6), (2.0, 1.4, None),
                             (3.5, 1.2, 1.25), (4.0, None, 1.0))]
    for bands in ([1.5, 1.3], [0.5], [2.5, 1.2, 1.0]):
        assert time_to_quality.compute_bands(curve, bands) == \
            jt.compute_bands(curve, bands)


@pytest.mark.parametrize("shape,out", [((96, 96), (48, 48)),
                                       ((96, 96), (40, 40)),
                                       ((97, 64), (30, 17)),
                                       ((16, 16), (12, 12)),
                                       ((33, 33), (33, 33))])
def test_area_resize_matches_cv2_inter_area(shape, out):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(1).normal(size=shape) * 10
    want = cv2.resize(img, (out[1], out[0]), interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(time_to_quality.area_resize(img, out), want,
                               rtol=0, atol=1e-12)


def test_area_resize_refuses_to_enlarge():
    with pytest.raises(ValueError, match="shrinks only"):
        time_to_quality.area_resize(np.zeros((4, 4)), (8, 8))


def test_watchdog_restarts_stalled_run(tmp_path):
    """As ``tests/test_extras.py`` holds the JAX watchdog: a run whose
    heartbeat goes stale is killed and launched again; a second attempt
    that exits 0 ends the loop."""
    fake = tmp_path / "fake.py"
    fake.write_text(
        "import os, sys, time\n"
        "d = sys.argv[1]\n"
        "hb = os.path.join(d, 'heartbeat')\n"
        "m = os.path.join(d, 'attempt')\n"
        "k = int(open(m).read()) if os.path.exists(m) else 0\n"
        "open(m, 'w').write(str(k + 1))\n"
        "if k >= 1:\n"
        "    sys.exit(0)\n"
        "for _ in range(5):\n"
        "    open(hb, 'w').close(); os.utime(hb); time.sleep(0.1)\n"
        "time.sleep(600)\n")
    r = subprocess.run(
        [sys.executable, "-m", "season_nerf_torch.tools.watchdog_train",
         "--logs_dir", str(tmp_path), "--stall_sec", "5", "--grace_sec",
         "30", "--poll_sec", "1", "--", sys.executable, str(fake),
         str(tmp_path)],
        capture_output=True, text=True, timeout=180, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[watchdog] stall" in r.stdout
    assert (tmp_path / "attempt").read_text() == "2"


def test_run_flagship_runs_cli_train_under_the_watchdog(tmp_path):
    """The script's command line, recorded by a stand-in ``python``."""
    log = tmp_path / "argv.txt"
    stub = tmp_path / "bin" / "python"
    stub.parent.mkdir()
    stub.write_text(f'#!/bin/sh\necho "$@" >> {log}\n')
    stub.chmod(0o755)
    env = dict(os.environ, PATH=f"{stub.parent}:{os.environ['PATH']}")
    r = subprocess.run(
        ["bash", str(ROOT / "season_nerf_torch/tools/run_flagship.sh"),
         str(tmp_path / "io"), "3", "--compute_dtype", "float32"],
        capture_output=True, text=True, timeout=60, env=env)
    assert r.returncode == 0, r.stderr
    argv = log.read_text().split()
    cut = argv.index("--")
    assert argv[:2] == ["-m", "season_nerf_torch.tools.watchdog_train"]
    assert argv[2:cut] == ["--logs_dir", f"{tmp_path}/io/Logs/flagship_s3",
                           "--stall_sec", "900", "--grace_sec", "1800",
                           "--max_restarts", "8"]
    train = argv[cut + 1:]
    assert train[:4] == ["python", "-m", "season_nerf_torch.cli", "train"]
    flags = dict(zip(train[4::2], train[5::2]))
    assert flags == {"--site_name": "SYNTH_FLAGSHIP",
                     "--exp_name": "flagship_s3",
                     "--IO_Location": f"{tmp_path}/io",
                     "--max_train_steps": "50000", "--batch_size": "2048",
                     "--n_samples": "96", "--fc_units": "512",
                     "--synth_views": "14", "--testing_size": "3",
                     "--n_saves": "20", "--seed": "3",
                     "--compute_dtype": "float32"}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("served")
    cfg = TConfig(site_name="served", fc_units=32, fc_layers=2, n_samples=8,
                  chunk=64)
    cfg.save_json(str(d / "opts.json"))
    torch.manual_seed(0)
    save_model_artifact(str(d / "Final_Model.nn"),
                        model_from_config(cfg).state_dict())
    return str(d)


def test_serve_render_answers_over_http(model_dir):
    assert serve_render.main.__module__ == "season_nerf_torch.render.serving"
    proc = subprocess.Popen(
        [sys.executable, "-m", "season_nerf_torch.tools.serve_render",
         "--Model_Location", model_dir, "--port", "0", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        line = proc.stdout.readline()
        assert "serving served on http://" in line, proc.stderr.read()
        base = line.split()[-1]
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert r.status == 200
        with urllib.request.urlopen(
                base + "/render?view_el=70&view_az=30&sun_el=45&sun_az=160"
                "&t=0.4&size=8", timeout=120) as r:
            assert r.read()[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        proc.terminate()
        proc.wait(timeout=30)


JAX_ROW_KEYS = {"clients", "requests", "size", "p50_s", "p95_s", "mean_s",
                "frames_per_s", "rays_per_s", "errors"}


def test_bench_serving_concurrent_on_the_cpu(model_dir, tmp_path):
    out = tmp_path / "levels.json"
    t0 = time.perf_counter()
    report = bench_serving_concurrent.main(
        [model_dir, "--size", "8", "--clients", "1", "2", "--requests", "2",
         "--output", str(out), "--device", "cpu"])
    wall = time.perf_counter() - t0
    assert json.loads(out.read_text()) == report
    assert report["fast_render"] is None
    assert [r["clients"] for r in report["levels"]] == [1, 2]
    for row in report["levels"]:
        assert set(row) == JAX_ROW_KEYS | {"max_s"}
        assert row["errors"] == 0 and row["size"] == 8
        assert row["requests"] == 2 * row["clients"]
        assert 0 < row["p50_s"] <= row["p95_s"] <= row["max_s"] < wall
        assert row["frames_per_s"] > 0
        assert row["rays_per_s"] == pytest.approx(row["frames_per_s"] * 64,
                                                  rel=1e-3)
