"""The port's training-mode building blocks against the JAX package, on the
CPU: the network in training mode (batch statistics, the running-statistic
update), the sine's gradient, the Barron loss, the schedule and phases,
the prior's density, the jittered samples and the synthetic sun rays.

Tolerances: f32 network outputs to 3e-4, as ``test_torch_model.py``
(SIREN layers with omega 30 amplify last-bit differences; measured
~2e-5); bf16 loosely, as there (flax stores z in bf16, and one rounding
flip propagates).  Running statistics: the same sums in f32, 1e-5
relative.  Elementwise functions: a few float32 ulps.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from season_nerf_torch.models.siren import SineLayer as TSine
from season_nerf_torch.models.tnerf import model_from_config as t_model
from season_nerf_torch.models.tnerf import supervised_sigma as t_sup
from season_nerf_torch.ops import fast_math as t_fm
from season_nerf_torch.ops import robust_loss as t_rl
from season_nerf_torch.ops.sampling import sample_coarse as t_sample
from season_nerf_torch.train import losses as t_losses
from season_nerf_torch.train import phases as t_phases
from season_nerf_torch.train import state as t_state
from season_nerf_torch.utils.convert import state_dict_from_flax
from season_nerf_tpu.config import Config
from season_nerf_tpu.models.siren import SineLayer as JSine
from season_nerf_tpu.models.tnerf import model_from_config as j_model
from season_nerf_tpu.models.tnerf import supervised_sigma as j_sup
from season_nerf_tpu.ops import fast_math as j_fm
from season_nerf_tpu.ops import robust_loss as j_rl
from season_nerf_tpu.ops.sampling import sample_coarse as j_sample
from season_nerf_tpu.train import losses as j_losses
from season_nerf_tpu.train import phases as j_phases
from season_nerf_tpu.train import state as j_state

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(jnp.asarray(a).astype(jnp.float32))


# --- the network in training mode --------------------------------------------
N = 200
TOL = {"float32": 3e-4, "bfloat16": 1.5e-1}


@pytest.fixture(scope="module", params=[("float32", False),
                                        ("float32", True),
                                        ("bfloat16", True)],
                ids=["f32-sin", "f32-fast_sin", "bf16-fast_sin"])
def trained_pair(request):
    """One training-mode forward of both networks from the same weights
    and running statistics."""
    dtype, fast_sine = request.param
    cfg = Config(fc_units=64, fc_layers=8, number_low_frequency_cases=4,
                 compute_dtype=dtype, fast_sine=fast_sine)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    sun = rng.normal(size=(N, 3)).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    yf = rng.uniform(0, 1, N)
    t4 = np.stack([np.cos(2 * np.pi * yf), np.sin(2 * np.pi * yf),
                   np.ones(N), np.zeros(N)], 1).astype(np.float32)
    jm = j_model(cfg)
    v = jax.device_get(jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(3), jnp.zeros((2, 3)), jnp.zeros((2, 3)),
        jnp.zeros((2, 4)), train=False))
    want, upd = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=True, mutable=["batch_stats"]))(v, x, sun, t4)
    tm = t_model(cfg).load_weights(
        state_dict_from_flax(v["params"], v["batch_stats"])).train()
    got = tm(_t(x), _t(sun), _t(t4))
    ref = state_dict_from_flax({}, jax.device_get(upd["batch_stats"]))
    return dtype, tm, got, jax.device_get(want), ref


def test_train_forward_matches_flax(trained_pair):
    dtype, _, got, want, _ = trained_pair
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]),
                                   atol=TOL[dtype], err_msg=k)


def test_train_forward_updates_running_stats_as_flax(trained_pair):
    """Biased batch variance, momentum 0.99, and BatchNorm1d's own update
    (unbiased variance, its counter) never runs."""
    dtype, tm, _, _, ref = trained_pair
    sd = tm.state_dict()
    keys = [k for k in ref if "running" in k]
    assert len(keys) == 2 * 8          # fc2..fc8 and fc9, mean and var
    rtol = 1e-5 if dtype == "float32" else 2e-2
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(), rtol=rtol,
                                   atol=rtol * 1e-2, err_msg=k)
    assert int(sd["G_NeRF_net.fc2.norm.num_batches_tracked"]) == 0


def test_sine_layer_bn_uses_the_fast_biased_variance():
    """flax normalises with the biased variance max(0, E[z^2] - E[z]^2) and
    keeps it in the running statistics; the unbiased one (BatchNorm1d's
    running update) is 64/63 of it."""
    rng = np.random.default_rng(4)
    x = (2.0 + 0.3 * rng.standard_normal((64, 8))).astype(np.float32)
    jl = JSine(8, use_norm=True, omega_0=30.0)
    v = jax.device_get(jl.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               train=False))
    want, upd = jl.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    tl = TSine(8, 8, use_norm=True)
    with torch.no_grad():
        tl.linear.weight.copy_(_t(v["params"]["linear"]["kernel"]).t())
        tl.linear.bias.copy_(_t(v["params"]["linear"]["bias"]))
    tl.train()
    got = tl(_t(x))
    # z reaches ~100 here (inputs offset by 2, omega 30): an ulp of z is
    # ~1e-5 before the mean is taken out, and the sine carries it
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-3)
    np.testing.assert_allclose(tl.norm.running_var.numpy(),
                               _np(upd["batch_stats"]["norm"]["var"]),
                               rtol=1e-5)
    w, b = tl.linear.weight.detach(), tl.linear.bias.detach()
    z = 30.0 * (_t(x).double() @ w.t().double() + b.double())
    fast = ((z * z).mean(0) - z.mean(0) ** 2).numpy()
    batch_var = (tl.norm.running_var.double().numpy() - 0.99) / 0.01
    np.testing.assert_allclose(batch_var, fast, rtol=1e-3)
    assert not np.allclose(batch_var, z.var(0).numpy(), rtol=1e-2)


# --- fast sine's gradient ----------------------------------------------------
def test_fast_sin_and_cos_gradients_are_each_other():
    x = np.linspace(-40.0, 40.0, 1001, dtype=np.float32)
    for tf, jf in ((t_fm.fast_sin, j_fm.fast_sin),
                   (t_fm.fast_cos, j_fm.fast_cos)):
        xt = _t(x).requires_grad_()
        tf(xt).sum().backward()
        want = jax.grad(lambda a: jnp.sum(jf(a)))(jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), _np(want), atol=2e-6)
        # second order through the autograd functions
        xt2 = _t(x).requires_grad_()
        (g,) = torch.autograd.grad(tf(xt2).sum(), xt2, create_graph=True)
        g.sum().backward()
        want2 = jax.grad(lambda a: jnp.sum(jax.grad(
            lambda b: jnp.sum(jf(b)))(a)))(jnp.asarray(x))
        np.testing.assert_allclose(xt2.grad.numpy(), _np(want2), atol=2e-6)


# --- the Barron loss ---------------------------------------------------------
@pytest.mark.parametrize("alpha", [0.005, 0.5, 1.0, 1.7, 2.5, 2.99])
def test_nll_and_its_alpha_and_scale_gradients(alpha):
    x = np.random.default_rng(5).uniform(-0.8, 0.8, (257, 3)).astype(
        np.float32)
    scale = np.float32(0.07)

    def jf(a, s):
        return jnp.mean(j_rl.nll(jnp.asarray(x), a, s))

    jv, (ja, js) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.float32(alpha), scale)
    a = torch.tensor(alpha, dtype=torch.float32, requires_grad=True)
    s = torch.tensor(float(scale), requires_grad=True)
    tv = t_rl.nll(_t(x), a, s).mean()
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=2e-6)
    np.testing.assert_allclose(float(a.grad), float(ja), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(s.grad), float(js), rtol=1e-5)
    np.testing.assert_allclose(
        _np(t_rl.general_loss(_t(x), a, s)),
        _np(j_rl.general_loss(jnp.asarray(x), jnp.float32(alpha), scale)),
        rtol=2e-6, atol=1e-7)


def test_log_partition_interpolates_like_jnp_interp():
    """Values and the piecewise-linear slope, at knots and between them,
    and clipped outside the table."""
    # the table's two ends are left out: there jnp.clip passes half the
    # slope (a tie in jnp.maximum), torch.clamp all of it
    alphas = np.concatenate([np.linspace(-0.5, 3.5, 98),
                             j_rl._table()[0][[1, 50, 200, -2]]])
    alphas = alphas.astype(np.float32)
    jv = j_rl.log_partition(jnp.asarray(alphas))
    jg = jax.vmap(jax.grad(j_rl.log_partition))(jnp.asarray(alphas))
    a = _t(alphas).requires_grad_()
    tv = t_rl.log_partition(a)
    tv.sum().backward()
    np.testing.assert_allclose(tv.detach().numpy(), _np(jv), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(a.grad.numpy(), _np(jg), rtol=1e-4,
                               atol=1e-4)


def test_latents_and_carry_over():
    cfg = j_rl.AdaptiveCfg(n_channels=3, alpha_init=1.2, scale_init=0.04)
    lat = {"latent_alpha": np.float32([[0.3, -0.2, 1.1]]),
           "latent_scale": np.float32([[-0.5, 0.1, 0.7]])}
    jl = {k: jnp.asarray(v) for k, v in lat.items()}
    tl = {k: _t(v) for k, v in lat.items()}
    tcfg = t_rl.AdaptiveCfg(*cfg)
    np.testing.assert_allclose(_np(t_rl.alpha_of(tl, tcfg)),
                               _np(j_rl.alpha_of(jl, cfg)), rtol=1e-6)
    np.testing.assert_allclose(_np(t_rl.scale_of(tl, tcfg)),
                               _np(j_rl.scale_of(jl, cfg)), rtol=1e-6)
    new = j_rl.AdaptiveCfg(n_channels=3)
    (jz, jc), (tz, tc) = (j_rl.carry_over(jl, cfg, new),
                          t_rl.carry_over(tl, tcfg, t_rl.AdaptiveCfg(*new)))
    np.testing.assert_allclose(tuple(tc), tuple(jc), rtol=1e-6)
    assert all(float(t.abs().max()) == 0 for t in tz.values())


# --- schedule and phases -----------------------------------------------------
@pytest.mark.parametrize("total", [1, 2, 7, 40, 1000])
def test_onecycle_matches_jax(total):
    js = j_state.onecycle(3e-4, total)
    ts = t_state.onecycle(3e-4, total)
    for c in sorted({0, 1, total // 3, total // 2, total - 1, total,
                     total + 5}):
        # the JAX schedule runs in float32, the port's in float64
        np.testing.assert_allclose(ts(c), float(js(c)), rtol=1e-5,
                                   atol=1e-6 * 3e-4, err_msg=str(c))


@pytest.mark.parametrize("steps,saves,jump", [(20, 0, True), (10, 2, True),
                                              (50_000, 20, True),
                                              (1000, 5, False)])
def test_phases_and_save_points_match_jax(steps, saves, jump):
    jp, tp = j_phases.build_phases(steps, jump), t_phases.build_phases(
        steps, jump)
    assert [(p.index, p.start, p.end, p.use_prior) for p in tp] == \
        [(p.index, p.start, p.end, p.use_prior) for p in jp]
    assert t_phases.save_points(tp, saves, steps) == \
        j_phases.save_points(jp, saves, steps)
    for s in (0, steps // 5, steps - 1):
        assert t_phases.phase_at(tp, s).index == j_phases.phase_at(jp,
                                                                  s).index


# --- cameras, prior density, samples, sun rays ------------------------------
def test_camera_projection_round_trip_and_rays_match_jax():
    from season_nerf_torch.data.synthetic import make_projective_camera as tc
    from season_nerf_tpu.data.synthetic import make_projective_camera as jc
    t, j = tc("v", 78.0, 140.0, img_size=20), jc("v", 78.0, 140.0,
                                                   img_size=20)
    np.testing.assert_array_equal(t.P, j.P)
    rows, cols = np.meshgrid(np.arange(20.0), np.arange(20.0))
    for h in (-0.7, 0.4):
        x, y, z = t.backproject(rows, cols, h)
        np.testing.assert_allclose(np.stack(t.project(x, y, z)),
                                   np.stack([rows, cols]), atol=1e-9)
        np.testing.assert_allclose(np.stack(t.backproject(rows, cols, h)),
                                   np.stack(j.backproject(rows, cols, h)),
                                   rtol=0, atol=1e-12)
    for a, b in zip(t.pixel_rays(), j.pixel_rays()):
        np.testing.assert_array_equal(a, b)



def test_supervised_sigma_with_nan_cells():
    rng = np.random.default_rng(6)
    hm = rng.uniform(-0.8, 0.8, (9, 11)).astype(np.float32)
    hm[rng.random(hm.shape) < 0.3] = np.nan
    pts = rng.uniform(-1.1, 1.1, (500, 3)).astype(np.float32)
    pts[:4, :2] = [[-1, -1], [1, 1], [-1, 1], [1, -1]]      # the corners
    delta = rng.uniform(0.01, 0.05, (500, 1)).astype(np.float32)
    want = j_sup(jnp.asarray(hm), jnp.asarray(pts), jnp.asarray(delta))
    got = t_sup(_t(hm), _t(pts), _t(delta))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert (got == 0).any() and (got > 0).any()


def test_jittered_samples_match_jax():
    rng = np.random.default_rng(7)
    tops = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    bots = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    for include_end in (False, True):
        jp, jd = j_sample(key, jnp.asarray(tops), jnp.asarray(bots), 12,
                          train=True, include_end=include_end)
        jitter = _t(jax.random.uniform(key, (6, 12)))
        tp, td = t_sample(_t(tops), _t(bots), 12, include_end=include_end,
                          jitter=jitter)
        np.testing.assert_allclose(tp.numpy(), _np(jp), atol=1e-6)
        np.testing.assert_allclose(td.numpy(), _np(jd), rtol=1e-6)


@pytest.mark.parametrize("frame", [False, True], ids=["enu", "site_frame"])
def test_solar_rays_from_injected_draws(frame):
    key = jax.random.PRNGKey(12)
    n = 64
    sun_frame = None
    if frame:
        q, _ = np.linalg.qr(np.random.default_rng(8).normal(size=(3, 3)))
        sun_frame = (q * [1.0, 1.0, np.sign(np.linalg.det(q))]).astype(
            np.float32) + np.eye(3, dtype=np.float32)
    want = j_losses.make_solar_rays(
        key, n, None if sun_frame is None else jnp.asarray(sun_frame))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = [jax.random.uniform(k1, (n,), minval=-jnp.pi, maxval=jnp.pi),
             jax.random.uniform(k2, (n,), minval=jnp.deg2rad(1.0),
                                maxval=jnp.deg2rad(90.0)),
             jax.random.uniform(k3, (n, 2), minval=-1.0, maxval=1.0),
             jax.random.uniform(k4, (n, 2), minval=0.0, maxval=2 * jnp.pi)]
    got = t_losses.make_solar_rays(
        *[_t(d) for d in draws],
        None if sun_frame is None else _t(sun_frame))
    # ends divide by the sun's z: up to 1/sin(1 deg) = 57 times an ulp
    for g, w, tol in zip(got, want, (1e-6, 1e-4, 1e-6, 1e-6)):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=tol)
    assert float(got[0][:, 2].min()) == 1.0
    np.testing.assert_allclose(got[1][:, 2].numpy(), -1.0, atol=1e-5)
    assert math.isclose(float(torch.linalg.norm(got[2], dim=1).max()), 1.0,
                        rel_tol=1e-5)
