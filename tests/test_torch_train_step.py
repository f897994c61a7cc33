"""The port's training step against the JAX package's, on the CPU.

- ``season_nerf_loss``, its gradients and the BatchNorm running statistics
  it leaves, with the prior on and off, through the default trunk
  (full-batch BatchNorm) and the fused one (ghost BatchNorm; the JAX side
  runs its Pallas kernels in interpret mode, the port its plain versions),
  fed the same draws;
- a 20-step float32 ``Trainer`` run across the phase 1 -> 4 boundary: the
  port's draws are the numbers the JAX trainer draws from its key splits
  (``engine.py:293-299``, ``losses.py:117``, ``rendering.py:103-105``,
  ``losses.py:80-95``); every step's loss dict and the final weights and
  running statistics are compared;
- resume (port only): a run split at a checkpoint equals the run that was
  not split;
- ``cli train`` on the CPU writes a model directory the port renders.

Tolerances (float32 throughout):
- one loss evaluation: 1e-4 relative on each loss.  The two packages'
  sines and cosines of the sun angles differ in the last bit, and a solar
  ray's end divides by the sun's z (1 / sin(1 deg) = 57 at the lowest
  sun), so solar sample positions differ by up to 2e-6; the trunk's x_enc
  agrees to 2e-5 and the SIREN layers after it (omega 30) take that to
  2e-4 on the visibility.  Each gradient to 2e-3 of its largest value (it
  carries the same amplification), and the BatchNorm layers' linear
  biases, whose gradient is zero up to rounding, to 1e-5 of the largest
  gradient of all;
- 20 steps: the differences grow through the updates; losses to 1e-4
  relative, weights to 2e-4 absolute (about 20 % of one step of Adam at
  the peak learning rate, 1.4e-5 a step).  The linear biases of the
  BatchNorm layers are left out of the weight comparison: their gradient
  is zero up to rounding, and Adam turns that rounding noise into steps of
  the full learning rate whose sign differs between the packages; the
  BatchNorm that follows cancels them.  The running means, which follow
  those biases times omega (30), to 2e-3 (measured 6.5e-4).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from season_nerf_torch import cli as t_cli
from season_nerf_torch.config import Config as TConfig
from season_nerf_torch.data import synthetic as t_synth
from season_nerf_torch.ops import fused_train as ftr
from season_nerf_torch.ops import robust_loss as t_rl
from season_nerf_torch.train import losses as t_losses
from season_nerf_torch.train.engine import Trainer as TTrainer
from season_nerf_torch.utils.convert import state_dict_from_flax
from season_nerf_tpu.config import Config as JConfig
from season_nerf_tpu.data import synthetic as j_synth
from season_nerf_tpu.data.rays import decode_batch
from season_nerf_tpu.ops import pallas_train as pt
from season_nerf_tpu.ops import robust_loss as j_rl
from season_nerf_tpu.train import losses as j_losses
from season_nerf_tpu.train import phases as j_phases
from season_nerf_tpu.train.engine import Trainer as JTrainer

torch.set_num_threads(1)

SITE = dict(n_views=4, img_size=16, grid=24, seed=3)
CFG = dict(fc_units=32, batch_size=16, n_samples=8, max_train_steps=20,
           compute_dtype="float32", fast_sine=True, n_saves=0, logs_dir="")
R, S = CFG["batch_size"], CFG["n_samples"]
# the linear biases of the BatchNorm layers: their gradient is zero up to
# rounding (BatchNorm subtracts the batch mean right after them)
BN_BIAS = {f"G_NeRF_net.fc{i}.linear.bias" for i in range(2, 10)}
# the Barron latents both trainers start from (see _start_latents)
LATENT0 = 0.3


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def jax_draws(key, n_rows):
    """The numbers the JAX training step draws from its step key."""
    k_batch, k_loss = jax.random.split(key)
    idx = jax.random.randint(k_batch, (R,), 0, n_rows)
    k_render, k_solar_rays, k_solar_samp = jax.random.split(k_loss, 3)
    k_coarse, _ = jax.random.split(k_render)
    k1, k2, k3, k4 = jax.random.split(k_solar_rays, 4)
    d = {"idx": idx,
         "jitter": jax.random.uniform(k_coarse, (R, S)),
         "solar_az": jax.random.uniform(k1, (R,), minval=-jnp.pi,
                                        maxval=jnp.pi),
         "solar_el": jax.random.uniform(k2, (R,), minval=jnp.deg2rad(1.0),
                                        maxval=jnp.deg2rad(90.0)),
         "solar_xy": jax.random.uniform(k3, (R, 2), minval=-1.0, maxval=1.0),
         "solar_t": jax.random.uniform(k4, (R, 2), minval=0.0,
                                       maxval=2 * jnp.pi),
         "solar_jitter": jax.random.uniform(k_solar_samp, (R, S))}
    out = {k: _t(v) for k, v in jax.device_get(d).items()}
    out["idx"] = torch.from_numpy(np.array(d["idx"], np.int64))
    return out


@pytest.fixture(scope="module")
def site():
    js = j_synth.make_scene(**SITE)
    ts = t_synth.make_scene(**SITE)
    jt, _ = j_synth.scene_ray_tables(js, testing_size=1)
    tt, _ = t_synth.scene_ray_tables(ts, testing_size=1)
    return js, ts, jt, tt


def test_synthetic_site_matches_jax(site):
    js, ts, jt, tt = site
    np.testing.assert_array_equal(ts.prior_hm, js.prior_hm)
    np.testing.assert_array_equal(tt.img_ids, jt.img_ids)
    np.testing.assert_allclose(tt.rows, jt.rows, rtol=0, atol=1e-6)


# --- one loss evaluation -----------------------------------------------------
def _close_losses(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k][0].detach()),
                                   float(want[k][0]),
                                   rtol=rtol, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(float(got[k][1]), float(want[k][1]),
                                   rtol=rtol, err_msg=k + " weight")


@pytest.fixture(scope="module")
def loss_setup(site):
    js, _, jt, _ = site
    cfg = JConfig(**CFG, mesh_shape=1)
    jtr = JTrainer(cfg, jt, None, prior_hm=js.prior_hm)
    v = jax.device_get(jtr.variables_template)
    rng = np.random.default_rng(11)
    ada = {"color": {"latent_alpha": rng.normal(0, .3, (1, 3)),
                     "latent_scale": rng.normal(0, .3, (1, 3))},
           "alpha": {"latent_alpha": rng.normal(0, .3, (1, 1)),
                     "latent_scale": rng.normal(0, .3, (1, 1))}}
    ada = {g: {k: np.float32(a) for k, a in d.items()} for g, d in ada.items()}
    key = jax.random.PRNGKey(4)
    return jtr, v, ada, key


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused"])
@pytest.mark.parametrize("use_prior", [True, False], ids=["prior", "no_prior"])
def test_loss_and_gradients_match_jax(site, loss_setup, use_prior, fused):
    js, _, jt, tt = site
    jtr, v, ada, key = loss_setup
    kw = dict(widths=(32,) * 8 + (16,), skip_idx=4, tile=64, fast_sine=True,
              grad_dtype="float32", act_dtype="float32")
    c_cfg = j_rl.AdaptiveCfg(n_channels=3, alpha_init=1.5, scale_init=0.05)
    a_cfg = j_rl.AdaptiveCfg(n_channels=1, scale_lo=0.05, scale_init=0.5)
    common = dict(n_samples=S, use_prior=use_prior,
                  use_solar=True, classic_solar=False, use_mse_loss=False,
                  sc_lambda=0.03, phase_len=10,
                  alpha_cfg=a_cfg if use_prior else None)
    j_stat = j_losses.LossStatics(n_importance=0, color_cfg=c_cfg,
                                  pallas_spec=pt.TrunkSpec(**kw) if fused
                                  else None, **common)
    t_stat = t_losses.LossStatics(
        color_cfg=t_rl.AdaptiveCfg(*c_cfg),
        trunk_spec=ftr.TrunkSpec(**kw) if fused else None,
        **{**common, "alpha_cfg": t_rl.AdaptiveCfg(*a_cfg) if use_prior
           else None})
    j_ada = {g: d for g, d in ada.items() if use_prior or g == "color"}
    draws = jax_draws(key, len(jt))
    step = 3
    j_batch = decode_batch(jnp.asarray(jt.rows[draws["idx"].numpy()]))
    prior = jnp.asarray(js.prior_hm)

    k_loss = jax.random.split(key)[1]      # the loss's key within a step

    def loss_fn(params, ada_p):
        total, (losses, upd) = j_losses.season_nerf_loss(
            jtr.model, {**v, "params": params}, ada_p, j_stat, j_batch, k_loss,
            jnp.asarray(step), train=True, prior_hm=prior, mutable=True)
        return total, (losses, upd)

    (j_total, (j_l, j_upd)), (j_g, j_ga) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(v["params"], j_ada)

    tm = TTrainer(TConfig(**CFG), tt, device="cpu").model
    tm.load_weights(state_dict_from_flax(v["params"], v["batch_stats"]))
    t_ada = {g: {k: _t(a).requires_grad_() for k, a in d.items()}
             for g, d in j_ada.items()}
    batch = {k: torch.as_tensor(np.array(a)) for k, a in
             jax.device_get(j_batch).items()}
    total, losses = t_losses.season_nerf_loss(
        tm, t_ada, t_stat, batch, draws, step, prior_hm=_t(js.prior_hm))
    total.backward()

    rtol = 1e-4
    np.testing.assert_allclose(float(total.detach()), float(j_total),
                               rtol=rtol)
    _close_losses(losses, j_l, rtol)
    jg = state_dict_from_flax(jax.device_get(j_g), {})
    top = max(float(np.abs(g.numpy()).max()) for g in jg.values())
    for name, p in tm.named_parameters():
        if name in jg:
            want = jg[name].numpy()
            got = p.grad.numpy() if p.grad is not None else 0 * want
            atol = (1e-5 * top if name in BN_BIAS
                    else 2e-3 * max(np.abs(want).max(), 1e-3))
            np.testing.assert_allclose(got, want, atol=atol, err_msg=name)
    for g, d in t_ada.items():
        for k, t in d.items():
            want = np.asarray(j_ga[g][k])
            np.testing.assert_allclose(t.grad.numpy(), want, atol=2e-3 * max(
                np.abs(want).max(), 1e-3), err_msg=f"{g}.{k}")
    # the running statistics after the camera and solar passes
    ref = state_dict_from_flax({}, jax.device_get(j_upd["batch_stats"]))
    sd = tm.state_dict()
    for k, want in ref.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


# --- 20 steps of the Trainer -------------------------------------------------
def _start_latents(trainer):
    """Enter the first phase with the Barron latents at LATENT0, not 0.  At
    latent 0, alpha is 2 and b = |alpha - 2| + eps is eps alone; there the
    JAX package's own jitted step and its op-by-op evaluation differ by 5 %
    in the adaptive NLL (the port agrees with the op-by-op one), and the
    sign of the latents' first gradient, which Adam turns into a full step,
    is noise."""
    trainer._enter_phase(trainer.phases[0])
    with torch.no_grad():
        for t in trainer._ada_leaves():
            t.add_(LATENT0)


@pytest.fixture(scope="module")
def runs(site):
    js, _, jt, tt = site
    jtr = JTrainer(JConfig(**CFG, mesh_shape=1), jt, None,
                   prior_hm=js.prior_hm)
    v = jax.device_get(jtr.variables_template)
    j_scalars, draws = [], {}
    while jtr.step < CFG["max_train_steps"]:
        phase = j_phases.phase_at(jtr.phases, jtr.step)
        if jtr._phase is None or phase.index != jtr._phase.index:
            jtr._enter_phase(phase)
            if jtr.step == 0:
                jtr.state = jtr.state._replace(ada_params=jax.tree_util.
                                               tree_map(lambda a: a + LATENT0,
                                                        jtr.state.ada_params))
        jtr.rng, k = jax.random.split(jtr.rng)
        draws[jtr.step] = jax_draws(k, len(jt))
        jtr.state, sc = jtr._step_fn(jtr.state, k)
        j_scalars.append({n: float(x) for n, x in jax.device_get(sc).items()})
        jtr.step += 1
    ttr = TTrainer(TConfig(**CFG), tt, prior_hm=js.prior_hm, device="cpu",
                   draws=draws.__getitem__)
    ttr.model.load_weights(state_dict_from_flax(v["params"],
                                                v["batch_stats"]))
    _start_latents(ttr)
    t_scalars = []
    while ttr.step < CFG["max_train_steps"]:
        t_scalars.append({n: float(x) for n, x in ttr.train_step().items()})
    return jtr, ttr, j_scalars, t_scalars


def test_trainer_losses_match_jax_every_step(runs):
    jtr, ttr, j_scalars, t_scalars = runs
    assert [p.index for p in ttr.phases] == [1, 4]
    assert "Alpha_Adjust_ada" in t_scalars[0]
    assert "Alpha_Adjust_ada" not in t_scalars[-1]
    for i, (g, w) in enumerate(zip(t_scalars, j_scalars)):
        assert set(g) == set(w), i
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")


def test_trainer_weights_match_jax_after_the_run(runs):
    jtr, ttr, _, _ = runs
    ref = state_dict_from_flax(jax.device_get(jtr.state.params),
                               jax.device_get(jtr.state.batch_stats))
    sd = ttr.model.state_dict()
    moved = 0
    for k, want in ref.items():
        if k in BN_BIAS or k.endswith("num_batches_tracked"):
            continue
        # a running mean follows its layer's linear bias (times omega, 30)
        atol = 2e-3 if k.endswith("running_mean") else 2e-4
        np.testing.assert_allclose(sd[k].numpy(), want.numpy(), atol=atol,
                                   rtol=0, err_msg=k)
        moved += not torch.equal(sd[k], want)
    assert moved > 0
    # the carried Barron latents of the last phase
    for g, lat in ttr.ada_params.items():
        for k, t in lat.items():
            np.testing.assert_allclose(
                t.detach().numpy(),
                np.asarray(jtr.state.ada_params[g][k]), atol=2e-3,
                err_msg=f"{g}.{k}")


# --- resume (port only) -----------------------------------------------------
@pytest.mark.parametrize("split", [4, 9], ids=["at_phase_boundary",
                                               "mid_phase"])
def test_resume_equals_the_unsplit_run(site, tmp_path, split):
    js, _, _, tt = site
    cfg = TConfig(**{**CFG, "max_train_steps": 12})
    whole = TTrainer(cfg, tt, prior_hm=js.prior_hm, device="cpu")
    whole.run()
    first = TTrainer(cfg, tt, prior_hm=js.prior_hm, device="cpu")
    first.run(n_steps=split)
    path = str(tmp_path / f"Model_{split}.nn")
    first.save_checkpoint(path)
    second = TTrainer(cfg, tt, prior_hm=js.prior_hm, device="cpu")
    second.resume(path)
    assert second.step == split
    second.run()
    assert second.step == whole.step == 12
    a, b = whole.model.state_dict(), second.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for g, lat in whole.ada_params.items():
        for k, t in lat.items():
            assert torch.equal(t, second.ada_params[g][k]), (g, k)


def test_step_draws_are_keyed_by_step():
    from season_nerf_torch.train.engine import StepDraws
    d = StepDraws(seed=0, n_rows=100, batch_size=R, n_samples=S,
                  device="cpu")
    a, b, c = d(5), d(5), d(6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["jitter"], c["jitter"])
    assert a["idx"].max() < 100 and a["jitter"].shape == (R, S)
    assert float(a["solar_el"].min()) >= math.radians(1.0)


# --- the command line -------------------------------------------------------
def test_cli_train_writes_a_model_dir_the_port_renders(tmp_path,
                                                       monkeypatch):
    from season_nerf_torch.render.loading import load_model_dir
    # the evaluation that ends cli train at 8 px, not its default 256 x 256
    # test renders and 128 px walks (test_torch_analysis.py holds it)
    monkeypatch.setattr(t_cli, "run_test", functools.partial(
        t_cli.run_test, eval_img_size=(8, 8)))
    rc = t_cli.main(["train", "--site_name", "SYNTH_T", "--exp_name", "e",
                     "--IO_Location", str(tmp_path), "--max_train_steps",
                     "4", "--n_samples", "8", "--batch_size", "16",
                     "--fc_units", "32", "--synth_views", "3",
                     "--synth_img_size", "16", "--synth_grid", "16",
                     "--testing_size", "1", "--n_saves", "1",
                     "--device", "cpu"])
    assert rc == 0
    d = tmp_path / "Logs" / "e"
    for name in ("Final_Model.nn", "opts.json", "W2C_W2L_H.npy",
                 "Model_4.nn", "metrics.jsonl", "Analysis.pickle",
                 "Output/Image_scores.txt", "Output/Time_Walk.gif"):
        assert (d / name).exists(), name
    loaded = load_model_dir(str(d), device="cpu")
    assert loaded.cfg.fc_units == 32
    out = loaded.renderer.render_img((70.0, 30.0), (45.0, 160.0), 0.4, 8)
    assert out["Col_Img"].shape == (8, 8, 3)
    assert np.isfinite(out["Col_Img"]).all()
