"""The port's save-point validation and final-model selection against the
JAX package's ``Trainer``, on the CPU.

On ``bench.py``'s synthetic site (6 views of 48 px, one held out), a JAX
``Trainer`` and the port's train 10 float32 steps from the same weights
(``state_dict_from_flax``) and the same draws, with 3 save points (steps 2,
6 and 10; the first in the prior phase).  The port's training draws are the
numbers the JAX trainer draws from its step keys (as in
``test_torch_train_step.py``), and its validation draws the numbers the JAX
``_on_save_point`` draws from its split of the trainer's key
(``engine.py:479-482``, ``losses.py:117``, ``losses.py:80-95``): the
validation batch and the solar rays; eval mode samples without jitter.

Tolerances:
- from the JAX run's state at each save point (weights, running
  statistics, latents), the ``Testing`` losses on the same validation
  batch and solar rays: 1e-4 relative (+1e-7), the rtol of
  ``test_torch_train_step.py::_close_losses``: the solar rays' sines differ
  in the last bit and the omega-30 SIREN layers amplify it (the camera
  pass's ``Color`` agrees to the last bit); and the validation report
  (``Mean_PSNR``, ``Mean_Height_Error``, ``Prior_Height_Error``) to 1e-5
  relative;
- from the same weights, ``render_table_image``: float32 images and
  heights to 1e-5 absolute (the port's eval trunk is the folded one, the
  JAX package's the flax module: the same arithmetic in another order);
  bfloat16 under 1e-2 (the two round at other points, ROADMAP Queue 3);
- each run's own ``Testing`` values and save-point scores, and
  ``finalize``'s scores: 1e-3 relative.  The two runs' weights part by the
  steps' rounding, which Adam amplifies (2e-4 on a weight after 20 steps
  in ``test_torch_train_step.py``); the largest difference measured here
  is 2.6e-4 relative (``Color_ada`` at step 6).

About 45-50 s on one worker, most of it the JAX Trainer's eager init and
its compiles (the module fixture's 31-34 s).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from season_nerf_torch.config import Config as TConfig
from season_nerf_torch.data import synthetic as t_synth
from season_nerf_torch.train import phases as t_phases
from season_nerf_torch.train import state as t_state
from season_nerf_torch.train.engine import StepDraws, Trainer as TTrainer
from season_nerf_torch.train.engine import ValDraws
from season_nerf_torch.utils.convert import state_dict_from_flax
from season_nerf_tpu.config import Config as JConfig
from season_nerf_tpu.data import synthetic as j_synth
from season_nerf_tpu.models.tnerf import model_from_config as \
    j_model_from_config
from season_nerf_tpu.train import phases as j_phases
from season_nerf_tpu.train.engine import Trainer as JTrainer

torch.set_num_threads(1)

SITE = dict(n_views=6, img_size=48, grid=64, seed=0)     # bench.py:95-96
CFG = dict(fc_units=64, batch_size=16, n_samples=8, max_train_steps=10,
           compute_dtype="float32", fast_sine=True, n_saves=3)
R, S = CFG["batch_size"], CFG["n_samples"]
SAVES = [2, 6, 10]
LATENT0 = 0.3       # the Barron latents' start (test_torch_train_step.py)
LOSS_RTOL = 1e-4
REPORT_RTOL = 1e-5
RUN_RTOL = 1e-3
IMG_ATOL = {"float32": 1e-5, "bfloat16": 1e-2}


class Recorder:
    """A metric writer that keeps every scalar: {(prefix, step): values}."""

    def __init__(self):
        self.logged = {}

    def scalars(self, prefix, values, step):
        self.logged.setdefault((prefix, int(step)), {}).update(
            {k: float(v) for k, v in values.items()})

    def image(self, tag, img, step):
        pass

    def flush(self):
        pass


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _solar(key, n):
    """The solar rays' draws of ``make_solar_rays(key, n)``."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return {"solar_az": jax.random.uniform(k1, (n,), minval=-jnp.pi,
                                           maxval=jnp.pi),
            "solar_el": jax.random.uniform(k2, (n,), minval=jnp.deg2rad(1.0),
                                           maxval=jnp.deg2rad(90.0)),
            "solar_xy": jax.random.uniform(k3, (n, 2), minval=-1.0,
                                           maxval=1.0),
            "solar_t": jax.random.uniform(k4, (n, 2), minval=0.0,
                                          maxval=2 * jnp.pi)}


def _as_torch(d):
    out = {k: _t(v) for k, v in jax.device_get(d).items() if k != "idx"}
    out["idx"] = torch.from_numpy(np.array(d["idx"], np.int64))
    return out


def step_draws(key, n_rows):
    """The numbers the JAX training step draws from its step key."""
    k_batch, k_loss = jax.random.split(key)
    k_render, k_solar_rays, k_solar_samp = jax.random.split(k_loss, 3)
    k_coarse, _ = jax.random.split(k_render)
    return _as_torch({"idx": jax.random.randint(k_batch, (R,), 0, n_rows),
                      "jitter": jax.random.uniform(k_coarse, (R, S)),
                      **_solar(k_solar_rays, R),
                      "solar_jitter": jax.random.uniform(k_solar_samp,
                                                         (R, S))})


def val_draws(rng, n_rows):
    """The numbers the JAX ``_on_save_point`` draws from the trainer's key
    ``rng``: the validation batch and the eval loss's solar rays."""
    _, k1, k2 = jax.random.split(rng, 3)
    n = min(R, n_rows)
    _, k_solar_rays, _ = jax.random.split(k2, 3)
    return _as_torch({"idx": jax.random.randint(k1, (n,), 0, n_rows),
                      **_solar(k_solar_rays, n)})


@pytest.fixture(scope="module")
def site():
    js, ts = j_synth.make_scene(**SITE), t_synth.make_scene(**SITE)
    jt, jv = j_synth.scene_ray_tables(js, testing_size=1)
    tt, tv = t_synth.scene_ray_tables(ts, testing_size=1)
    np.testing.assert_allclose(tv.rows, jv.rows, rtol=0, atol=1e-6)
    return js, jt, jv, tt, tv


@pytest.fixture(scope="module")
def runs(site, tmp_path_factory):
    """The JAX run (its loop with one step a dispatch, as ``Trainer.run``
    with ``scan_chunk=1``) and the port's, each writing its checkpoints."""
    js, jt, jv, tt, tv = site
    jdir = str(tmp_path_factory.mktemp("jax_run"))
    tdir = str(tmp_path_factory.mktemp("port_run"))
    jrec, trec = Recorder(), Recorder()
    jtr = JTrainer(JConfig(**CFG, mesh_shape=1, logs_dir=jdir), jt, jv,
                   prior_hm=js.prior_hm, gt_dsm=js.hm, writer=jrec)
    v0 = jax.device_get(jtr.variables_template)
    draws, vdraws, states = {}, {}, {}
    while jtr.step < CFG["max_train_steps"]:
        phase = j_phases.phase_at(jtr.phases, jtr.step)
        if jtr._phase is None or phase.index != jtr._phase.index:
            jtr._enter_phase(phase)
            if jtr.step == 0:
                jtr.state = jtr.state._replace(ada_params=jax.tree_util.
                                               tree_map(lambda a: a + LATENT0,
                                                        jtr.state.ada_params))
        jtr.rng, k = jax.random.split(jtr.rng)
        draws[jtr.step] = step_draws(k, len(jt))
        jtr.state, _ = jtr._step_fn(jtr.state, k)
        jtr.step += 1
        if jtr.step in jtr.save_steps:
            vdraws[jtr.step] = val_draws(jtr.rng, len(jv))
            states[jtr.step] = (jax.device_get(jtr.state),
                                (jtr._carry_alpha, jtr._carry_scale))
            jtr._on_save_point()
    assert sorted(jtr.save_steps) == SAVES

    ttr = TTrainer(TConfig(**CFG, logs_dir=tdir), tt, tv,
                   prior_hm=js.prior_hm, gt_dsm=js.hm, writer=trec,
                   device="cpu", draws=draws.__getitem__,
                   val_draws=vdraws.__getitem__)
    ttr.model.load_weights(state_dict_from_flax(v0["params"],
                                                v0["batch_stats"]))
    ttr._enter_phase(ttr.phases[0])
    with torch.no_grad():
        for t in ttr._ada_leaves():
            t.add_(LATENT0)
    ttr.run()
    return jtr, ttr, jrec.logged, trec.logged, vdraws, states


def _close(got, want, rtol, atol=0.0, what=""):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def _port_at(site, runs, step):
    """A port trainer holding the JAX run's state at the save point
    ``step``: its weights, running statistics and Barron latents, in its
    phase (the colour latents' carried alpha and scale included)."""
    js, _, _, tt, tv = site
    vdraws, states = runs[4], runs[5]
    state, carry = states[step]
    tr = TTrainer(TConfig(**CFG), tt, tv, prior_hm=js.prior_hm,
                  gt_dsm=js.hm, writer=Recorder(), device="cpu",
                  val_draws=vdraws.__getitem__)
    tr._carry_alpha, tr._carry_scale = carry
    tr.step = step
    tr._enter_phase(t_phases.phase_at(tr.phases, step - 1))
    tr.model.load_weights(state_dict_from_flax(state.params,
                                               state.batch_stats))
    with torch.no_grad():
        for g, lat in tr.ada_params.items():
            for k, t in lat.items():
                t.copy_(_t(state.ada_params[g][k]))
    return tr


REPORT = ("Mean_PSNR", "Mean_Height_Error", "Prior_Height_Error")


@pytest.mark.parametrize("step", SAVES)
def test_testing_losses_match_jax(site, runs, step):
    """From the JAX run's state at the save point: the eval losses on the
    same validation batch and solar rays, and the validation report."""
    jlog = runs[2]
    want = dict(jlog[("Testing", step)])
    tr = _port_at(site, runs, step)
    _close(tr.validation_report(), {k: want.pop(k) for k in REPORT},
           REPORT_RTOL, what=f"report, step {step}")
    _close(tr.eval_losses(), want, LOSS_RTOL, 1e-7, f"step {step}")
    assert ("Alpha_Adjust_ada" in want) == (step == 2)   # the prior phase


@pytest.mark.parametrize("step", SAVES)
def test_the_runs_log_the_same_testing_values(runs, step):
    """Each run's own ``Testing`` scalars at the save point."""
    jlog, tlog = runs[2], runs[3]
    _close(tlog[("Testing", step)], jlog[("Testing", step)], RUN_RTOL, 1e-7,
           f"step {step}")


def test_save_geometry_matches_jax(runs):
    jtr, ttr = runs[:2]
    assert [s for s, _ in ttr._save_geometry] == SAVES
    assert [s for s, _ in jtr._save_geometry] == SAVES
    np.testing.assert_allclose([m for _, m in ttr._save_geometry],
                               [m for _, m in jtr._save_geometry],
                               rtol=RUN_RTOL)


def _same_weights(site, runs, dtype):
    """A JAX trainer and a port trainer in ``dtype`` holding the JAX run's
    last weights."""
    js, _, _, tt, tv = site
    jtr = runs[0]
    if dtype != "float32":
        # the run's trainer with the network in ``dtype`` (the same
        # parameters; a second JAX Trainer would initialize them again)
        jtr = copy.copy(jtr)
        jtr.cfg = JConfig(**{**CFG, "compute_dtype": dtype})
        jtr.model = j_model_from_config(jtr.cfg)
        jtr._render_chunk_cache = None
    ttr = TTrainer(TConfig(**{**CFG, "compute_dtype": dtype}), tt, tv,
                   prior_hm=js.prior_hm, gt_dsm=js.hm, writer=Recorder(),
                   device="cpu")
    ttr.model.load_weights(state_dict_from_flax(
        jax.device_get(jtr.state.params),
        jax.device_get(jtr.state.batch_stats)))
    return jtr, ttr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_table_image_matches_jax(site, runs, dtype):
    _, _, jv, _, tv = site
    jtr, ttr = _same_weights(site, runs, dtype)
    want = jtr.render_table_image(jv, 0)
    got = ttr.render_table_image(tv, 0)
    np.testing.assert_array_equal(got[3], want[3])            # the mask
    np.testing.assert_array_equal(got[1], want[1])            # the GT
    seen = want[3]
    assert seen.sum() > 500
    for g, w, what in ((got[0], want[0], "image"),
                       (got[2], want[2], "height")):
        assert g.shape == w.shape
        assert np.isfinite(g[seen]).all()
        err = float(np.abs(g[seen] - w[seen]).max())
        assert err < IMG_ATOL[dtype], (what, err)
    assert np.isnan(got[2][~seen]).all()
    if dtype == "float32":
        _close(ttr.validation_report(), jtr.validation_report(), 1e-5,
               what="report")


def test_render_in_chunks_equals_one_chunk(site, runs):
    """A chunk smaller than the image: full chunks and a ragged last one
    render what one chunk renders."""
    _, _, _, _, tv = site
    _, ttr = _same_weights(site, runs, "float32")
    whole = ttr.render_table_image(tv, 0)
    parts = ttr.render_table_image(tv, 0, chunk=300)
    for a, b in zip(whole, parts):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["best_geometry", "on_decay_below",
                                  "on_decay_above"])
def test_finalize_selects_as_jax(runs, case):
    """``best_geometry`` on the runs' own scores; ``best_geometry_on_decay``
    on the same scores with the last one set to 5 % (below the 10 %
    threshold: the last step's weights) or 50 % (above: the best save
    point's) over the best of the others."""
    jtr, ttr = runs[:2]
    j_geom, t_geom = list(jtr._save_geometry), list(ttr._save_geometry)
    mode = "best_geometry"
    if case != "best_geometry":
        mode = "best_geometry_on_decay"
        over = 1.05 if case == "on_decay_below" else 1.5
        best = min(m for _, m in t_geom[:-1])
        t_geom[-1] = j_geom[-1] = (SAVES[-1], best * over)
    metas = []
    for tr, geom in ((jtr, j_geom), (ttr, t_geom)):
        kept = tr._save_geometry
        tr._save_geometry = geom
        tr.cfg.final_model_selection = mode
        try:
            tr.finalize()
        finally:
            tr._save_geometry = kept
        path = f"{tr.cfg.logs_dir}/Final_Model.nn"
        metas.append(t_state.load_model_artifact(path)[1])
    jmeta, tmeta = metas
    assert tmeta["selection"] == jmeta["selection"] == mode
    assert tmeta["selected_step"] == jmeta["selected_step"]
    assert tmeta["steps"] == jmeta["steps"] == tmeta["selected_step"]
    floats = ["prior_height_mae"] + (["geometry_drift", "decay_threshold"]
                                     if case != "best_geometry" else [])
    _close({k: tmeta[k] for k in floats}, {k: jmeta[k] for k in floats},
           RUN_RTOL, 1e-6, case)
    if case == "on_decay_below":
        assert tmeta["selected_step"] == ttr.step
    if case == "on_decay_above":
        assert tmeta["selected_step"] < ttr.step
    # the artifact holds the selected save point's weights
    sd, _ = t_state.load_model_artifact(f"{ttr.cfg.logs_dir}/Final_Model.nn")
    ck = t_state.load_checkpoint(
        f"{ttr.cfg.logs_dir}/Model_{tmeta['selected_step']}.nn")["model"]
    for k, v in sd.items():
        assert torch.equal(v, ck[k].to(v.dtype)), k


def test_resume_keeps_save_geometry(site, runs):
    js, _, _, tt, tv = site
    ttr = runs[1]
    for i, step in enumerate(SAVES):
        again = TTrainer(ttr.cfg, tt, tv, prior_hm=js.prior_hm, device="cpu",
                         writer=Recorder())
        again.resume(f"{ttr.cfg.logs_dir}/Model_{step}.nn")
        assert again.step == step
        assert again._save_geometry == ttr._save_geometry[:i + 1]


def test_eval_after_a_training_step_equals_a_fresh_fold(site):
    """The folded inference trunk follows the weights that Adam updates in
    place: the second evaluation sees the step between the two."""
    js, _, _, tt, tv = site
    cfg = TConfig(**CFG)
    tr = TTrainer(cfg, tt, tv, prior_hm=js.prior_hm, device="cpu",
                  writer=Recorder())
    tr.train_step()
    first = tr.render_table_image(tv, 0)[0]
    tr.train_step()
    second = tr.render_table_image(tv, 0)[0]
    fresh = TTrainer(cfg, tt, tv, device="cpu", writer=Recorder())
    fresh.model.load_state_dict(tr.model.state_dict())
    np.testing.assert_array_equal(second, fresh.render_table_image(tv, 0)[0])
    assert not np.array_equal(first, second)


def test_validation_reads_and_keeps_the_running_statistics(site):
    js, _, _, tt, tv = site
    tr = TTrainer(TConfig(**CFG), tt, tv, prior_hm=js.prior_hm,
                  gt_dsm=js.hm, device="cpu", writer=Recorder())
    tr.train_step()
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr._on_save_point()
    after = tr.model.state_dict()
    assert tr.model.training
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
    assert ("Testing", 1) in tr.writer.logged


def test_val_draws_are_keyed_by_step_and_apart_from_training():
    v = ValDraws(seed=0, n_rows=1000, batch_size=R, device="cpu")
    s = StepDraws(seed=0, n_rows=1000, batch_size=R, n_samples=S,
                  device="cpu")
    a, b, c = v(4), v(4), v(5)
    assert set(a) == {"idx", "solar_az", "solar_el", "solar_xy", "solar_t"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["idx"], c["idx"])
    assert not torch.equal(a["idx"], s(4)["idx"])
