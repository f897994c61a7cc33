"""Hierarchical sampling (``n_importance``) in the port against the JAX
package: ``sample_fine`` fed the draws JAX derives from its key,
``eval_rays`` in training and eval mode, one ``Trainer`` step's losses,
gradients and running statistics against the JAX Trainer's loss on the
same weights and draws, and the draws and switches around them.

Tolerances (float32 throughout, as ``test_torch_train_step.py``):
- ``sample_fine``: 1e-6 absolute.  The same gathers and lerps on the same
  float32 inputs; the CDF's cumulative sum may round differently in its
  last bit, which moves no bin at these draws.
- ``eval_rays``: points and steps 1e-6; densities and colors 1e-4.  The
  coarse pass runs through the port's folded inference trunk (~3e-6 on
  x_enc against flax's), which moves a fine sample only where a draw falls
  within that of a CDF step, none at these draws.
- the step: each loss 1e-4 relative, each gradient 2e-3 of its largest
  value, the BatchNorm-fed linear biases 1e-5 of the largest gradient, the
  running statistics 1e-5 relative: ``test_torch_train_step.py``'s, for
  its reasons.

Seconds on one worker: about 45, most of them the JAX loss's compile.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from season_nerf_torch.config import Config as TConfig
from season_nerf_torch.data import synthetic as t_synth
from season_nerf_torch.models.tnerf import model_from_config
from season_nerf_torch.ops import rendering as t_rendering
from season_nerf_torch.ops import sampling as t_sampling
from season_nerf_torch.train.engine import StepDraws, ValDraws
from season_nerf_torch.train.engine import Trainer as TTrainer
from season_nerf_torch.train.engine import fused_trunk_spec
from season_nerf_torch.utils.convert import state_dict_from_flax
from season_nerf_tpu.config import Config as JConfig
from season_nerf_tpu.data import synthetic as j_synth
from season_nerf_tpu.data.rays import decode_batch
from season_nerf_tpu.ops import rendering as j_rendering
from season_nerf_tpu.ops import sampling as j_sampling
from season_nerf_tpu.train import losses as j_losses
from season_nerf_tpu.train.engine import Trainer as JTrainer

torch.set_num_threads(1)

SITE = dict(n_views=4, img_size=16, grid=24, seed=3)
CFG = dict(fc_units=32, batch_size=16, n_samples=8, n_importance=4,
           max_train_steps=10, compute_dtype="float32", fast_sine=True,
           n_saves=0, logs_dir="")
R, S, NI = CFG["batch_size"], CFG["n_samples"], CFG["n_importance"]
BN_BIAS = {f"G_NeRF_net.fc{i}.linear.bias" for i in range(2, 10)}
LATENT0 = 0.3        # the Barron latents' start (test_torch_train_step.py)


def _np(a):
    return np.array(jax.device_get(a), np.float32)


def _t(a):
    return torch.from_numpy(_np(a))


def fine_draws(k_fine, n):
    """The importance samples' draws JAX's ``sample_fine`` takes from its
    key (``ops/sampling.py:54``, ``:58``, ``:66``)."""
    k_idx, k_shift = jax.random.split(k_fine)
    return (jax.random.uniform(k_idx, (n, NI)),
            jax.random.uniform(k_shift, (n, NI, 1)))


def jax_step_draws(key, n_rows):
    """Every number the JAX training step draws from its step key, under
    the port's names (``engine.py:293-299``, ``losses.py:117``,
    ``rendering.py:103-105``, ``sampling.py:54-66``, ``losses.py:80-95``)."""
    k_batch, k_loss = jax.random.split(key)
    k_render, k_solar_rays, k_solar_samp = jax.random.split(k_loss, 3)
    k_coarse, k_fine = jax.random.split(k_render)
    k1, k2, k3, k4 = jax.random.split(k_solar_rays, 4)
    u, shift = fine_draws(k_fine, R)
    d = {"jitter": jax.random.uniform(k_coarse, (R, S)),
         "solar_az": jax.random.uniform(k1, (R,), minval=-jnp.pi,
                                        maxval=jnp.pi),
         "solar_el": jax.random.uniform(k2, (R,), minval=jnp.deg2rad(1.0),
                                        maxval=jnp.deg2rad(90.0)),
         "solar_xy": jax.random.uniform(k3, (R, 2), minval=-1.0, maxval=1.0),
         "solar_t": jax.random.uniform(k4, (R, 2), minval=0.0,
                                       maxval=2 * jnp.pi),
         "solar_jitter": jax.random.uniform(k_solar_samp, (R, S)),
         "fine_u": u, "fine_shift": shift}
    out = {k: _t(v) for k, v in d.items()}
    out["idx"] = torch.from_numpy(np.array(jax.random.randint(
        k_batch, (R,), 0, n_rows), np.int64))
    return out


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2))
    tilt = rng.uniform(-0.2, 0.2, (n, 2))
    tops = np.concatenate([xy, np.ones((n, 1))], 1)
    bots = np.concatenate([np.clip(xy + tilt, -1, 1), -np.ones((n, 1))], 1)
    sun = np.broadcast_to([0.2, 0.1, 0.97], (n, 3))
    t4 = np.broadcast_to([0.3, 0.95, 1.0, 0.0], (n, 4))
    return [np.ascontiguousarray(a, np.float32) for a in (tops, bots, sun, t4)]


@pytest.fixture(scope="module")
def site():
    js = j_synth.make_scene(**SITE)
    ts = t_synth.make_scene(**SITE)
    jt, _ = j_synth.scene_ray_tables(js, testing_size=1)
    tt, _ = t_synth.scene_ray_tables(ts, testing_size=1)
    return js, jt, tt


@pytest.fixture(scope="module")
def jax_trainer(site):
    """A JAX Trainer in its first phase, its Barron latents at LATENT0 and
    its BatchNorm statistics from a train-mode pass (so that the coarse
    pass's running statistics are not the trivial ones)."""
    js, jt, _ = site
    jtr = JTrainer(JConfig(**CFG, mesh_shape=1), jt, None,
                   prior_hm=js.prior_hm)
    jtr._enter_phase(jtr.phases[0])
    v = jax.device_get(jtr.variables_template)
    pts, _, sun, t4 = _rays(256, 1)
    _, upd = jax.jit(lambda v, *a: jtr.model.apply(
        v, *a, train=True, mutable=["batch_stats"]))(v, pts, sun, t4)
    v = {"params": v["params"],
         "batch_stats": jax.device_get(upd["batch_stats"])}
    ada = jax.tree_util.tree_map(lambda a: a + LATENT0, jtr.state.ada_params)
    return jtr, v, ada


def _port_model(v):
    return model_from_config(TConfig(**CFG)).load_weights(
        state_dict_from_flax(v["params"], v["batch_stats"]))


# --- sample_fine ---------------------------------------------------------------
def test_sample_fine_matches_jax():
    tops, bots, _, _ = _rays(12, 2)
    rng = np.random.default_rng(3)
    jitter = rng.random((12, S)).astype(np.float32)
    base, _ = t_sampling.sample_coarse(torch.from_numpy(tops),
                                       torch.from_numpy(bots), S,
                                       jitter=torch.from_numpy(jitter))
    w = rng.random((12, S)).astype(np.float32) ** 4
    w[:4] = 0.0                     # rays with no evidence: uniform bins
    w[4, 3] = 50.0                  # a spike
    key = jax.random.PRNGKey(9)
    want_pts, want_d = j_sampling.sample_fine(
        key, jnp.asarray(tops), jnp.asarray(bots), jnp.asarray(base.numpy()),
        jnp.asarray(w), NI)
    u, shift = fine_draws(key, 12)
    got_pts, got_d = t_sampling.sample_fine(
        torch.from_numpy(tops), torch.from_numpy(bots), base,
        torch.from_numpy(w), NI, _t(u), _t(shift))
    assert got_pts.shape == (12, S + NI, 3) and got_d.shape == (12, S + NI, 1)
    np.testing.assert_allclose(got_pts.numpy(), _np(want_pts), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got_d.numpy(), _np(want_d), atol=1e-6, rtol=0)
    # sorted along the ray; the steps tile the ray from top to bottom
    d2 = ((got_pts - torch.from_numpy(tops)[:, None]) ** 2).sum(-1)
    assert (d2[:, 1:] >= d2[:, :-1]).all()
    np.testing.assert_allclose(got_d.sum((1, 2)).numpy(),
                               np.linalg.norm(tops - bots, axis=1),
                               rtol=1e-5)


def test_sample_fine_ties_keep_the_coarse_point_first():
    """A fine point at the distance of a coarse one (bin 0 with shift 0 is
    the ray's top, where the unjittered first sample lies): the stable sort
    keeps both, the coarse one first, and their shared step is split as the
    midpoints say (zero for the second)."""
    tops = torch.tensor([[0.1, 0.2, 1.0]])
    bots = torch.tensor([[0.1, 0.2, -1.0]])
    base, _ = t_sampling.sample_coarse(tops, bots, 4)
    w = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    pts, d = t_sampling.sample_fine(tops, bots, base, w, 2,
                                    torch.tensor([[0.1, 0.2]]),
                                    torch.zeros(1, 2, 1))
    assert torch.equal(pts[0, :3], tops.expand(3, 3))
    assert torch.equal(pts[0, 3:], base[0, 1:])
    np.testing.assert_allclose(d[0, :, 0].numpy(),
                               [0.0, 0.0, 0.25, 0.5, 0.5, 0.75], atol=1e-7)


# --- eval_rays ---------------------------------------------------------------
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_eval_rays_with_importance(jax_trainer, train):
    jtr, v, _ = jax_trainer
    tops, bots, sun, t4 = _rays(R, 4)
    key = jax.random.PRNGKey(5)
    k_coarse, k_fine = jax.random.split(key)
    want, upd = jax.jit(lambda v, *a: j_rendering.eval_rays(
        jtr.model, v, key, *a, n_samples=S, n_importance=NI, train=train,
        mutable=train))(v, tops, bots, sun, t4)
    u, shift = fine_draws(k_fine, R)
    tm = _port_model(v).train(train)
    before = {k: t.clone() for k, t in tm.state_dict().items()
              if "running" in k}
    got = t_rendering.eval_rays(
        tm, *map(torch.from_numpy, (tops, bots, sun, t4)), n_samples=S,
        n_importance=NI, fine_u=_t(u), fine_shift=_t(shift),
        jitter=_t(jax.random.uniform(k_coarse, (R, S))) if train else None)
    assert got["rho"].shape == (R, S + NI, 1)
    for k, tol in (("pts", 1e-6), ("deltas", 1e-6), ("rho", 1e-4),
                   ("col", 1e-4), ("vis", 1e-4), ("rendered", 1e-4)):
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]),
                                   atol=tol, rtol=tol, err_msg=k)
    z = got["pts"][..., 2]
    assert (z[:, 1:] <= z[:, :-1]).all()        # top (z = 1) to bottom
    # every submodule keeps its mode; the coarse pass reads the running
    # statistics and updates none: in eval mode they stay, in training
    # mode they are the full pass's update alone, as in JAX
    assert all(m.training == train for m in tm.modules())
    assert tm.G_NeRF_net._fused is None or not train
    sd = tm.state_dict()
    if train:
        ref = state_dict_from_flax({}, jax.device_get(upd["batch_stats"]))
        for k in before:
            np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    else:
        for k, t in before.items():
            assert torch.equal(sd[k], t), k


def test_coarse_pass_runs_the_trunk_in_eval_mode(jax_trainer, monkeypatch):
    """In a training step the coarse pass goes through the folded inference
    trunk (K3 on the card) once, over batch x n_samples points, and the
    fold it built is dropped when training resumes."""
    from season_nerf_torch.ops import fused_trunk
    _, v, _ = jax_trainer
    calls = []
    real = fused_trunk.trunk_apply

    def spy(pe, folded, fast_sine=False):
        calls.append(pe.shape[0])
        return real(pe, folded, fast_sine)

    monkeypatch.setattr(fused_trunk, "trunk_apply", spy)
    tm = _port_model(v).train()
    tops, bots, sun, t4 = map(torch.from_numpy, _rays(R, 6))
    g = torch.Generator().manual_seed(0)
    t_rendering.eval_rays(tm, tops, bots, sun, t4, n_samples=S,
                          n_importance=NI, jitter=torch.rand(R, S,
                                                             generator=g),
                          fine_u=torch.rand(R, NI, generator=g),
                          fine_shift=torch.rand(R, NI, 1, generator=g))
    assert calls == [R * S]
    assert tm.training and tm.G_NeRF_net._fused is None


# --- the Trainer -------------------------------------------------------------
def test_trainer_step_matches_jax(site, jax_trainer):
    js, jt, tt = site
    jtr, v, ada = jax_trainer
    key = jax.random.PRNGKey(6)
    draws = jax_step_draws(key, len(jt))
    k_loss = jax.random.split(key)[1]
    batch = decode_batch(jnp.asarray(jt.rows[draws["idx"].numpy()]))
    statics = jtr._phase_statics
    assert statics.n_importance == NI

    def loss_fn(params, ada_p):
        total, (losses, upd) = j_losses.season_nerf_loss(
            jtr.model, {**v, "params": params}, ada_p, statics, batch, k_loss,
            jnp.asarray(0), train=True, prior_hm=jnp.asarray(js.prior_hm),
            mutable=True)
        return total, (losses, upd)

    (j_total, (j_l, j_upd)), (j_g, j_ga) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(v["params"], ada)

    ttr = TTrainer(TConfig(**CFG), tt, prior_hm=js.prior_hm, device="cpu",
                   draws={0: draws}.__getitem__)
    ttr.model.load_weights(state_dict_from_flax(v["params"],
                                                v["batch_stats"]))
    ttr._enter_phase(ttr.phases[0])
    with torch.no_grad():
        for t in ttr._ada_leaves():
            t.add_(LATENT0)
    assert ttr.statics.n_importance == NI
    scalars = ttr.train_step()
    assert set(scalars) == set(j_l) | {"Total"}
    np.testing.assert_allclose(float(scalars["Total"]), float(j_total),
                               rtol=1e-4)
    for k, (val, _) in j_l.items():
        np.testing.assert_allclose(float(scalars[k]), float(val), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    jg = state_dict_from_flax(jax.device_get(j_g), {})
    top = max(float(np.abs(g.numpy()).max()) for g in jg.values())
    for name, p in ttr.model.named_parameters():
        if name in jg:
            want = jg[name].numpy()
            got = p.grad.numpy() if p.grad is not None else 0 * want
            atol = (1e-5 * top if name in BN_BIAS
                    else 2e-3 * max(np.abs(want).max(), 1e-3))
            np.testing.assert_allclose(got, want, atol=atol, err_msg=name)
    for g, d in ttr.ada_params.items():
        for k, t in d.items():
            want = np.asarray(j_ga[g][k])
            np.testing.assert_allclose(t.grad.numpy(), want, atol=2e-3 * max(
                np.abs(want).max(), 1e-3), err_msg=f"{g}.{k}")
    ref = state_dict_from_flax({}, jax.device_get(j_upd["batch_stats"]))
    sd = ttr.model.state_dict()
    for k, want in ref.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_pallas_trunk_with_importance_warns_on_the_cpu(site):
    js, _, tt = site
    cfg = TConfig(**{**CFG, "max_train_steps": 2, "pallas_trunk": True})
    tr = TTrainer(cfg, tt, prior_hm=js.prior_hm, device="cpu")
    with pytest.warns(UserWarning, match="hierarchical sampling"):
        scalars = tr.train_step()
    assert tr.statics.trunk_spec is None and tr.statics.n_importance == NI
    assert all(torch.isfinite(v) for v in scalars.values())
    # on a CUDA device the same request raises (no card needed to decide)
    with pytest.raises(ValueError, match="hierarchical sampling"):
        fused_trunk_spec(tr.model, R * S, "cuda", n_importance=NI)


# --- the draws ----------------------------------------------------------------------
def _digest(*sources):
    h = hashlib.sha256()
    for src, steps in sources:
        for step in steps:
            out = src(step)
            for k in sorted(out):
                h.update(k.encode())
                h.update(out[k].numpy().tobytes())
    return h.hexdigest()


def test_draws_without_importance_are_unchanged():
    """At n_importance 0 the draws are bit for bit those the port drew
    before hierarchical sampling existed (the digest of its StepDraws,
    uniform and weighted, and ValDraws at these arguments); with it, the
    fine draws come after all of those, which stay as they were."""
    step = [StepDraws(seed=7, n_rows=1000, batch_size=16, n_samples=8,
                      device="cpu", weighted=w) for w in (False, True)]
    val = ValDraws(seed=7, n_rows=300, batch_size=16, device="cpu")
    assert _digest((step[0], (0, 5)), (step[1], (0, 5)), (val, (3, 9))) == \
        "1c70ccda96199bb77207dc472610a146711324ecd316080d2a584e9eaea81fc9"
    for plain, fine in ((step[0], StepDraws(7, 1000, 16, 8, "cpu",
                                             n_importance=NI)),
                        (val, ValDraws(7, 300, 16, "cpu", n_importance=NI))):
        a, b = plain(4), fine(4)
        assert set(b) == set(a) | {"fine_u", "fine_shift"}
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert b["fine_u"].shape == (16, NI)
        assert b["fine_shift"].shape == (16, NI, 1)
        assert 0 <= float(b["fine_u"].min()) and float(b["fine_u"].max()) < 1


def test_eval_losses_with_importance(site):
    """The save point's Testing losses place importance samples too (JAX
    passes them an rng): finite, and the same for the same step."""
    js, _, tt = site
    ts = t_synth.make_scene(**SITE)
    _, vt = t_synth.scene_ray_tables(ts, testing_size=1)
    tr = TTrainer(TConfig(**CFG), tt, val_table=vt, prior_hm=js.prior_hm,
                  device="cpu")
    tr.train_step()
    a, b = tr.eval_losses(), tr.eval_losses()
    assert a == b and all(np.isfinite(x) for x in a.values())
    assert "fine_u" in tr.val_draws(tr.step)
