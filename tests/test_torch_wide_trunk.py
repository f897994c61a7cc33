"""K3 for every trunk the JAX model builds.

K3 takes padded widths up to 1024 in both dtypes and up to 17 layers
(``fc_layers`` <= 16); what it cannot take is refused by one pure function
of the model's shape, ``fused_trunk.k3_refusal``, which ``Trainer``,
``load_model_dir`` and the CLI's site preparation ask on a card before they
build anything.  Here, on the CPU: the refusal's cases and the entry points
refusing on ``device="cuda"`` (the refusal comes before any tensor reaches
the card, so no card is needed to see it); the plans of the wide and deep
trunks (the skip layer at ``fc_layers // 2 + 1``); the port against the
JAX ``TNeRF`` at ``fc_units=640`` (f32, ``TOL[float32]``); and that neither
package builds a trunk deeper than 8 layers (the JAX model's fc9 is the
half-width layer, so a ninth trunk layer cannot take its name), so K3's
11- and 17-layer plans are held on trunks built layer by layer
(``chip_smoke.deep_trunk_layers``).  The kernels themselves at these
shapes run on the card: ``tests/test_torch_cuda.py``.

About 25 s on one worker, most of it the JAX model's init and compile at
width 640."""

import os

import flax.errors
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL, deep_trunk_layers
from season_nerf_torch import cli
from season_nerf_torch.config import Config
from season_nerf_torch.data.synthetic import make_scene, scene_ray_tables
from season_nerf_torch.models.tnerf import TNeRF as TTNeRF
from season_nerf_torch.ops import fused_trunk as ft
from season_nerf_torch.render.loading import load_model_dir
from season_nerf_torch.train.engine import Trainer
from season_nerf_torch.utils import trace
from season_nerf_torch.utils.convert import state_dict_from_flax
from season_nerf_tpu.models.tnerf import GNeRF, TNeRF

torch.set_num_threads(1)


# (fc_units, fc_layers, compute_dtype, the limit the refusal names or None)
REFUSALS = [
    (1024, 8, "bfloat16", None), (1024, 8, "float32", None),
    (1024, 8, None, None),                      # a legacy directory: f32
    (1000, 8, "bfloat16", None),                # pads to 1024
    (1025, 8, "bfloat16", "padded widths up to 1024"),
    (1152, 8, "float32", "padded widths up to 1024"),
    (1152, 8, None, "padded widths up to 1024"),
    (512, 16, "bfloat16", None), (512, 16, "float32", None),
    (512, 17, "bfloat16", "up to 17 layers (fc_layers <= 16)"),
    (512, 17, "float32", "up to 17 layers (fc_layers <= 16)"),
    (32, 1, "bfloat16", None),
]


@pytest.mark.parametrize("units,layers,dtype,limit", REFUSALS)
def test_k3_refusal_names_the_limit(units, layers, dtype, limit):
    why = ft.k3_refusal(units, layers, dtype)
    if limit is None:
        assert why is None
        return
    kernel = "bf16" if dtype == "bfloat16" else "f32"
    assert why is not None and limit in why and f"the {kernel} trunk" in why
    assert f"fc_units {units}, fc_layers {layers}" in why


def test_the_cpu_is_never_refused():
    """The plain version takes every shape: on the CPU nothing is asked."""
    for units, layers in ((1152, 8), (4096, 8), (512, 17)):
        ft.refuse_on_card(Config(fc_units=units, fc_layers=layers), "cpu")
    with pytest.raises(ValueError, match="padded widths up to 1024"):
        ft.refuse_on_card(Config(fc_units=1152), "cuda")


@pytest.fixture(scope="module")
def table():
    scene = make_scene(n_views=3, img_size=8, grid=8, seed=0)
    return scene_ray_tables(scene, testing_size=1)[0]


@pytest.mark.parametrize("units,layers,limit", [
    (1152, 8, "padded widths up to 1024"),
    (512, 17, "up to 17 layers (fc_layers <= 16)")])
def test_trainer_refuses_on_the_card_before_building(table, units, layers,
                                                     limit):
    """On ``cuda`` the Trainer refuses before its model, its table on the
    device or a step: here, with no card, anything built there would
    raise another error first."""
    before = trace.counters()
    cfg = Config(fc_units=units, fc_layers=layers, batch_size=8, n_samples=4,
                 max_train_steps=2)
    with pytest.raises(ValueError, match=limit.replace("(", r"\(")
                       .replace(")", r"\)")):
        Trainer(cfg, table, device="cuda")
    assert trace.counters() == before


def test_run_train_refuses_before_preparing_the_site(tmp_path):
    cfg = Config(site_name="SYNTH_W", fc_units=1152,
                 IO_Location=str(tmp_path), exp_name="wide")
    with pytest.raises(ValueError, match="padded widths up to 1024"):
        cli.run_train(cfg, device="cuda")
    assert not os.listdir(tmp_path)                 # nothing prepared


@pytest.mark.parametrize("units,layers,limit", [
    (1152, 8, "padded widths up to 1024"),
    (512, 17, "up to 17 layers")])
def test_load_model_dir_refuses_on_the_card_before_the_weights(
        tmp_path, units, layers, limit):
    """The refusal comes from opts.json alone: the weights are not read
    (this Final_Model.nn is no artifact), nothing is folded or launched."""
    Config(fc_units=units, fc_layers=layers).save_json(
        str(tmp_path / "opts.json"))
    (tmp_path / "Final_Model.nn").write_bytes(b"not read")
    before = trace.counters()
    with pytest.raises(ValueError, match=limit):
        load_model_dir(str(tmp_path), device="cuda")
    assert trace.counters() == before
    with pytest.raises(Exception) as e:             # the CPU reads on
        load_model_dir(str(tmp_path), device="cpu")
    assert "padded widths" not in str(e.value)


@pytest.mark.parametrize("fc_layers", [10, 16])
def test_deep_plans_place_the_skip_layer(fc_layers):
    """11 and 17 kernel layers: fc1 reads the PE, the skip layer (fc_layers
    // 2 + 1: fc6, fc9) reads [h | PE], every other layer h; in both
    kernels' plans.  And the walk of the f32 plan gives the plain
    version."""
    layers = deep_trunk_layers(64, fc_layers)
    skip = fc_layers // 2 + 1
    assert [k for _, k in layers] == (["pe"] + ["h"] * (skip - 2) + ["h+pe"]
                                      + ["h"] * (fc_layers - skip + 1))
    bf = ft.fold_layers(layers, torch.bfloat16)
    plan = bf.launch_plan().tolist()
    assert len(plan) == fc_layers + 1 <= ft.MAX_LAYERS
    want_k = [64] + [128] * (skip - 2) + [192] + [128] * (fc_layers - skip)
    want_k += [128]
    assert [r[2] for r in plan] == want_k
    assert [r[7] for r in plan] == [0 if i == 0 else 2 if i == skip - 1
                                    else -1 for i in range(fc_layers + 1)]
    f32 = ft.fold_layers(layers)
    fplan = f32.f32_plan().tolist()
    assert [r[1] for r in fplan] == want_k
    assert [r[5] for r in fplan] == [0 if i == 0 else 128 if i == skip - 1
                                     else -1 for i in range(fc_layers + 1)]
    # the kernel's walk, as tests/test_torch_trunk.py emulates it
    pe = ft.encode_points(torch.from_numpy(np.random.default_rng(fc_layers)
                          .uniform(-1, 1, (7, 3)).astype(np.float32)))
    act = np.zeros((128 + 64, 7))
    act[128:] = pe.double().numpy().T
    ring = f32.ring_weights.double().numpy()
    for l, (_, k, n, in_k, w_off, _) in enumerate(fplan):
        w = ring[w_off:w_off + k * n].reshape(k, n)
        act[:n] = np.sin(f32.biases[l].double().numpy()[:, None]
                         + w.T @ act[in_k:in_k + k])
    # the walk in float64 against the plain version's float32: its
    # rounding grows with depth (1.8e-5 at 17 layers), TOL[float32] holds
    err = np.abs(act[:f32.out_features].T
                 - ft.trunk_apply_reference(pe, f32).double().numpy())
    tol_max, tol_mean = TOL[torch.float32]
    assert err.max() <= tol_max and err.mean() <= tol_mean


@pytest.mark.parametrize("units", [640, 1024])
def test_wide_plans_stay_inside_the_limits(units):
    g = TTNeRF(layer_width=units, n_layers=3, n_classes=2).eval().G_NeRF_net
    for dtype in (torch.bfloat16, torch.float32):
        folded = ft.fold_trunk(g, dtype=dtype)
        assert folded.width_pad == units <= ft.MAX_WIDTH
        plan = (folded.launch_plan() if dtype == torch.bfloat16
                else folded.f32_plan()).tolist()
        ns = [r[3] if dtype == torch.bfloat16 else r[2] for r in plan]
        assert ns == [units] * 3 + [-(-(units // 2) // 128) * 128]
    assert ft.k3_refusal(units, 3, "bfloat16") is None


def test_no_package_builds_a_trunk_deeper_than_8():
    """A trunk of fc_layers 10 is no model of either package:
    the JAX model's trunk layer fc9 would take the half-width layer's name,
    and the port's model refuses it in the same terms."""
    with pytest.raises(flax.errors.NameInUseError, match="fc9"):
        GNeRF(layer_width=32, n_layers=10).init(
            jax.random.PRNGKey(0), jnp.zeros((2, 3)),
            method=GNeRF.encode_x)
    with pytest.raises(ValueError, match="fc9 must not collide"):
        TTNeRF(layer_width=32, n_layers=10)


@pytest.mark.parametrize("fast_sine", [False, True])
def test_width_640_matches_jax(fast_sine):
    """The port's eval trunk (the fold and K3's plain version, padded to
    640) and heads against the flax model at fc_units=640, f32, 300 points,
    BatchNorm statistics from a train-mode pass: within TOL[float32]."""
    model = TNeRF(layer_width=640, n_layers=8, n_classes=2,
                  fast_sine=fast_sine)
    rng = np.random.default_rng(640)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    v = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(1), jnp.zeros((2, 3)), jnp.zeros((2, 3)),
        jnp.zeros((2, 4)), train=False)
    _, upd = jax.jit(lambda v, *a: model.apply(
        v, *a, train=True, mutable=["batch_stats"]))(
            v, jnp.asarray(pts), jnp.ones((300, 3)) / 3 ** 0.5,
            jnp.ones((300, 4)))
    v = jax.device_get({"params": v["params"],
                        "batch_stats": upd["batch_stats"]})
    want = np.asarray(jax.jit(lambda v, x: model.apply(
        v, x, train=False,
        method=lambda m, x, train: m.gnerf.position(x, train)))(
            v, jnp.asarray(pts))[0])
    port = TTNeRF(layer_width=640, n_layers=8, n_classes=2,
                  fast_sine=fast_sine).load_weights(
        state_dict_from_flax(v["params"], v["batch_stats"])).eval()
    with torch.no_grad():
        got = port.G_NeRF_net.encode_x(torch.from_numpy(pts)).numpy()
    assert port.G_NeRF_net.fused().folded.width_pad == 640
    assert got.shape == want.shape == (300, 320)
    err = np.abs(got - want)
    tol_max, tol_mean = TOL[torch.float32]
    assert err.max() <= tol_max and err.mean() <= tol_mean, (err.max(),
                                                             err.mean())
