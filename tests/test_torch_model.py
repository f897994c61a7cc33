"""The port's T-NeRF in eval mode against the flax module: the weight bridge
``state_dict_from_flax``, then every eval forward mode on the same inputs,
with BatchNorm running statistics from a train-mode pass (so that the fold
meets statistics that are not trivial).

The port's trunk runs through the folded fused trunk (``ops/fused_trunk``),
whose plain version re-associates the BatchNorm affine into the weights:
f32 agrees to the ``3e-4`` on x_enc that ``tests/test_pallas_mlp.py``
accepts for the same fold, and the heads carry that forward.  Under bf16 the
two round in different places (flax stores z in bf16 before BatchNorm; the
fold rounds W' and the activations), so bf16 is held loosely."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from season_nerf_torch.models.tnerf import model_from_config as t_model
from season_nerf_torch.utils.convert import state_dict_from_flax
from season_nerf_tpu.config import Config
from season_nerf_tpu.models.tnerf import model_from_config as j_model

torch.set_num_threads(1)


def _init_with_batch_stats(model, seed, pts, sun, t4):
    """Initialise ``model`` and give its BatchNorms running statistics that
    are not trivial, from one train-mode pass (both jitted: one compile
    costs less than flax's op-by-op dispatch)."""
    v = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((2, 3)), jnp.zeros((2, 3)),
        jnp.zeros((2, 4)), train=False)
    _, upd = jax.jit(lambda v, *a: model.apply(
        v, *a, train=True, mutable=["batch_stats"]))(v, pts, sun, t4)
    return {"params": v["params"], "batch_stats": upd["batch_stats"]}


N = 200
# (x_enc, every other output) max absolute differences; the mean absolute
# difference must stay under a quarter of each.  f32 measures ~3e-6.  bf16:
# flax rounds z to bf16 before BatchNorm, which at |z| ~ 8 is 0.0625, and the
# fold rounds elsewhere (measured: x_enc max 0.083, mean 0.0097; heads max
# 0.03)
TOL = {"float32": (3e-4, 3e-4), "bfloat16": (1.5e-1, 6e-2)}


@pytest.fixture(scope="module", params=[("float32", False),
                                        ("float32", True),
                                        ("bfloat16", True)],
                ids=["f32-sin", "f32-fast_sin", "bf16-fast_sin"])
def pair(request):
    dtype, fast_sine = request.param
    cfg = Config(fc_units=64, fc_layers=8, number_low_frequency_cases=4,
                 compute_dtype=dtype, fast_sine=fast_sine)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    sun = rng.normal(size=(N, 3)).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    yf = rng.uniform(0, 1, N)
    t4 = np.stack([np.cos(2 * np.pi * yf), np.sin(2 * np.pi * yf),
                   np.ones(N), np.zeros(N)], 1).astype(np.float32)
    jm = j_model(cfg)
    v = jax.device_get(_init_with_batch_stats(
        jm, 1, jnp.asarray(x), jnp.asarray(sun), jnp.asarray(t4)))
    tm = t_model(cfg).load_weights(state_dict_from_flax(v["params"],
                                                        v["batch_stats"]))
    return cfg, jm, v, tm, (x, sun, t4), TOL[dtype]


def _close(got, want, atol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)
    assert np.mean(np.abs(got - want)) <= atol / 4, what


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_bridge_loads_every_parameter(pair):
    cfg, _, v, tm, _, _ = pair
    assert not tm.training
    sd = tm.state_dict()
    np.testing.assert_array_equal(
        sd["G_NeRF_net.fc5.linear.weight"].numpy(),
        np.asarray(v["params"]["gnerf"]["fc5"]["linear"]["kernel"]).T)
    np.testing.assert_array_equal(
        sd["G_NeRF_net.fc9.norm.running_mean"].numpy(),
        np.asarray(v["batch_stats"]["gnerf"]["fc9"]["norm"]["mean"]))
    assert tm.G_NeRF_net.fc5.linear.in_features == 64 + 63   # the skip


def test_x_enc(pair):
    _, jm, v, tm, (x, _, _), (tol_enc, _) = pair
    want = jm.apply(v, jnp.asarray(x), train=False,
                    method=lambda m, a, train: m.gnerf.encode_x(a, train))
    _close(tm.G_NeRF_net.encode_x(_t(x)), want, tol_enc, "x_enc")


def test_full_forward(pair):
    _, jm, v, tm, (x, sun, t4), (_, tol) = pair
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(sun), jnp.asarray(t4),
                    train=False)
    with torch.no_grad():
        got = tm(_t(x), _t(sun), _t(t4))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], tol, k)


def test_forward_separate(pair):
    _, jm, v, tm, (x, sun, t4), (_, tol) = pair
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(sun), jnp.asarray(t4),
                    train=False, method="forward_separate")
    with torch.no_grad():
        got = tm.forward_separate(_t(x), _t(sun), _t(t4))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], tol, k)


def test_ray_consts_broadcast_forward(pair):
    """The eval_rays path: ray-constant branches once per ray, broadcast to
    the samples, no sun or time per point."""
    _, jm, v, tm, (x, sun, t4), (_, tol) = pair
    R = 8
    jp, js, jk = jm.apply(v, jnp.asarray(sun[:R]), jnp.asarray(t4[:R]),
                          train=False, method="ray_consts")
    with torch.no_grad():
        tp, ts, tk = tm.ray_consts(_t(sun[:R]), _t(t4[:R]))
    for g, w, k in ((tp, jp, "probs"), (ts, js, "sun_pe"), (tk, jk, "sky")):
        _close(g, w, tol, k)
    S = N // R
    rep = lambda a: np.repeat(np.asarray(a, np.float32), S, 0)
    want = jm.apply(v, jnp.asarray(x), None, None, probs=rep(jp),
                    sun_pe=rep(js), sky_raw=rep(jk), train=False)
    with torch.no_grad():
        got = tm(_t(x), None, None, probs=_t(rep(tp)), sun_pe=_t(rep(ts)),
                 sky_raw=_t(rep(tk)))
    for k in want:
        _close(got[k], want[k], tol, k)


def test_sigma_only_and_class_only(pair):
    _, jm, v, tm, (x, _, t4), (_, tol) = pair
    with torch.no_grad():
        _close(tm.sigma_only(_t(x)),
               jm.apply(v, jnp.asarray(x), train=False, method="sigma_only"),
               tol, "sigma_only")
        _close(tm.class_only(_t(t4)),
               jm.apply(v, jnp.asarray(t4), train=False, method="class_only"),
               tol, "class_only")


def test_training_mode_is_refused(pair):
    """The folded inference trunk (K3) is refused in training mode, where
    BatchNorm normalises with batch statistics."""
    _, _, _, tm, _, _ = pair
    tm.train()
    try:
        with pytest.raises(RuntimeError, match="eval mode"):
            tm.G_NeRF_net.fused()
    finally:
        tm.eval()
