"""The port's data-parallel mesh (``parallel/mesh.py``) on the CPU: gloo
ranks in processes of their own, against one process and against the
JAX package's 8-device virtual mesh.

- the training step (``train/engine.train_steps``) on 2 and 4 ranks
  against the port's one-process step from the same weights and draws
  (float32, so that only the order of reduction differs), and the ranks
  bit-identical at the end;
- the step of ``tests/test_parallel.py::_train``'s config (3 steps) on 2
  and 4 ranks against the JAX package's 8-device mesh, the JAX draws
  replayed, at that test's tolerances.  Two changes to the config, on
  both sides: float32, since in bf16 the two packages round in other
  places (a loss of the sky's thresholded square, ``Sky_Color_Var``,
  differs by 1.7 % after 3 steps, on one device as on a mesh); and the
  Barron latents start at ``LATENT0``, not 0 (at 0 alpha is 2, where the
  JAX package's jitted NLL and its op-by-op one differ by 5 %: see
  ``test_torch_train_step._start_latents``);
- the global BatchNorm statistics and the global albedo minimum, forward
  and gradient, on 2 ranks against one process on the whole batch;
- the render mesh: 3 replicas on the CPU at chunk 300 against one device
  and against the JAX 8-device ``Renderer``, exact and fast;
- ``make_mesh``'s refusal, and the batch and replicated placements.

About 60 s on one worker: each launch spawns its ranks (about 5 s), the
JAX mesh step compiles (about 10 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from season_nerf_torch.config import Config as TConfig
from season_nerf_torch.data import synthetic as t_synth
from season_nerf_torch.models.tnerf import TNeRF as TTNeRF
from season_nerf_torch.parallel.mesh import (backend_for, batch_sharding,
                                             launch, make_mesh,
                                             replicated_sharding, shard_batch)
from season_nerf_torch.render.renderer import Renderer as TRenderer
from season_nerf_torch.train.engine import train_steps
from season_nerf_torch.utils.convert import state_dict_from_flax
from season_nerf_tpu.config import Config as JConfig
from season_nerf_tpu.data import synthetic as j_synth
from season_nerf_tpu.models.tnerf import TNeRF as JTNeRF
from season_nerf_tpu.parallel.mesh import make_mesh as j_make_mesh
from season_nerf_tpu.render.renderer import Renderer as JRenderer
from season_nerf_tpu.train import phases as j_phases
from season_nerf_tpu.train.engine import Trainer as JTrainer

import torch_mesh_ranks

torch.set_num_threads(1)

SITE = dict(n_views=4, img_size=20, grid=24, seed=9)      # test_parallel's
# test_parallel._train's config; mesh_shape=1 keeps the one-process
# reference on one device
CFG = dict(max_train_steps=16, n_samples=8, batch_size=64, fc_units=32,
           n_saves=0, logs_dir="", jump_start=True, mesh_shape=1)
R, S = CFG["batch_size"], CFG["n_samples"]
STEPS = 3
LATENT0 = 0.3
RANKS = [2, 4]
CPU = lambda n: make_mesh(devices=["cpu"] * n)
# the linear biases that feed a BatchNorm: their gradient is zero up to
# rounding, and Adam turns that noise into steps of the full learning
# rate whose sign is noise (test_torch_train_step.BN_BIAS)
BN_BIAS = {f"G_NeRF_net.fc{i}.linear.bias" for i in range(2, 10)}


@pytest.fixture(scope="module")
def site():
    js = j_synth.make_scene(**SITE)
    ts = t_synth.make_scene(**SITE)
    jt, _ = j_synth.scene_ray_tables(js, testing_size=1)
    tt, _ = t_synth.scene_ray_tables(ts, testing_size=1)
    return js, ts, jt, tt


# --- the step against the port's one-process step ---------------------------
@pytest.fixture(scope="module")
def own_runs(site):
    """float32 runs of the port's own draws from the config's seed: one
    process, then 2 and 4 ranks."""
    _, ts, _, tt = site
    cfg = TConfig(**CFG, compute_dtype="float32")
    runs = {1: [train_steps(None, cfg, tt, STEPS, ts.prior_hm,
                            device="cpu")]}
    for n in RANKS:
        runs[n] = launch(train_steps, CPU(n), cfg, tt, STEPS, ts.prior_hm)
    return runs


@pytest.mark.parametrize("n", RANKS)
def test_mesh_step_matches_one_process(own_runs, n):
    """Every loss of every step to 1e-5 relative (measured 3.5e-7: the
    order of the sums alone differs), the weights after the run to 1e-6
    (measured below 1e-6), the BatchNorm-fed linear biases to twice the
    learning rates' sum (Adam's sign noise, measured 4.1e-5), the running
    statistics to 1e-4: the means follow those biases times omega (30),
    0.01 of it a pass, two passes a step (measured 1.7e-5)."""
    one, mesh = own_runs[1][0], own_runs[n][0]
    assert len(mesh["scalars"]) == STEPS
    for i, (a, b) in enumerate(zip(one["scalars"], mesh["scalars"])):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    lr_sum = STEPS * 10 ** -4.86
    for k, want in one["state_dict"].items():
        atol = (2 * lr_sum if k in BN_BIAS else
                1e-4 if "running" in k else 1e-6)
        np.testing.assert_allclose(mesh["state_dict"][k].numpy(),
                                   want.numpy(), rtol=0, atol=atol,
                                   err_msg=k)
    for g, lat in one["ada"].items():
        for k, t in lat.items():
            np.testing.assert_allclose(mesh["ada"][g][k].numpy(), t.numpy(),
                                       rtol=0, atol=1e-6, err_msg=f"{g}.{k}")


@pytest.mark.parametrize("n", RANKS)
def test_ranks_end_bit_identical(own_runs, n):
    ranks = own_runs[n]
    assert len(set(ranks[0]["checksums"])) == 1
    assert all(r["checksums"] == ranks[0]["checksums"] for r in ranks)
    for r in ranks[1:]:
        for k, t in ranks[0]["state_dict"].items():
            assert torch.equal(r["state_dict"][k], t), k
        for g, lat in ranks[0]["ada"].items():
            for k, t in lat.items():
                assert torch.equal(r["ada"][g][k], t), (g, k)


# --- the step against the JAX package's mesh ---------------------------------
def jax_draws(key, n_rows):
    """The numbers the JAX training step draws from its step key
    (``test_torch_train_step.jax_draws`` at this batch)."""
    k_batch, k_loss = jax.random.split(key)
    idx = jax.random.randint(k_batch, (R,), 0, n_rows)
    k_render, k_solar_rays, k_solar_samp = jax.random.split(k_loss, 3)
    k_coarse, _ = jax.random.split(k_render)
    k1, k2, k3, k4 = jax.random.split(k_solar_rays, 4)
    d = {"jitter": jax.random.uniform(k_coarse, (R, S)),
         "solar_az": jax.random.uniform(k1, (R,), minval=-jnp.pi,
                                        maxval=jnp.pi),
         "solar_el": jax.random.uniform(k2, (R,), minval=jnp.deg2rad(1.0),
                                        maxval=jnp.deg2rad(90.0)),
         "solar_xy": jax.random.uniform(k3, (R, 2), minval=-1.0, maxval=1.0),
         "solar_t": jax.random.uniform(k4, (R, 2), minval=0.0,
                                       maxval=2 * jnp.pi),
         "solar_jitter": jax.random.uniform(k_solar_samp, (R, S))}
    out = {k: torch.from_numpy(np.array(v, np.float32))
           for k, v in jax.device_get(d).items()}
    out["idx"] = torch.from_numpy(np.array(idx, np.int64))
    return out


@pytest.fixture(scope="module")
def jax_runs(site):
    """test_parallel._train on the JAX 8-device mesh (latents at LATENT0),
    and the port's 2 and 4 ranks from its initial weights and its draws."""
    js, ts, jt, tt = site
    assert len(jax.devices()) >= 8, "conftest forces an 8-device CPU mesh"
    cfg = JConfig(**{**CFG, "mesh_shape": None}, compute_dtype="float32")
    jtr = JTrainer(cfg, jt, None, prior_hm=js.prior_hm, mesh=j_make_mesh(8))
    v = jax.device_get(jtr.variables_template)
    jtr._enter_phase(j_phases.phase_at(jtr.phases, 0))
    jtr.state = jtr.state._replace(ada_params=jax.tree_util.tree_map(
        lambda a: a + LATENT0, jtr.state.ada_params))
    ada0 = jax.device_get(jtr.state.ada_params)
    draws, j_scalars = {}, []
    for step in range(STEPS):
        jtr.rng, k = jax.random.split(jtr.rng)
        draws[step] = jax_draws(k, len(jt))
        jtr.state, sc = jtr._step_fn(jtr.state, k)
        j_scalars.append({n: float(x) for n, x in jax.device_get(sc).items()})
    sd = state_dict_from_flax(v["params"], v["batch_stats"])
    ada = {g: {k: torch.from_numpy(np.array(a, np.float32))
               for k, a in d.items()} for g, d in ada0.items()}
    runs = {n: launch(train_steps, CPU(n),
                      TConfig(**CFG, compute_dtype="float32"), tt, STEPS,
                      ts.prior_hm, sd, ada, draws.__getitem__)
            for n in RANKS}
    want = state_dict_from_flax(jax.device_get(jtr.state.params), {})
    return j_scalars, want, runs


@pytest.mark.parametrize("n", RANKS)
def test_mesh_step_matches_the_jax_mesh(jax_runs, n):
    """test_parallel's tolerances: every loss at rtol 2e-3 (atol 1e-5),
    the weights at rtol 2e-3, atol 2e-4 (Adam turns the differences of
    near-zero gradients into full steps)."""
    j_scalars, want, runs = jax_runs
    got = runs[n][0]
    for i, (a, b) in enumerate(zip(j_scalars, got["scalars"])):
        assert set(a) == set(b), i
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=2e-3, atol=1e-5,
                                       err_msg=f"step {i} {k}")
    for k, w in want.items():
        np.testing.assert_allclose(got["state_dict"][k].numpy(), w.numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=k)
    assert len(set(got["checksums"])) == 1


# --- the collectives alone ---------------------------------------------------
def test_global_batchnorm_and_minimum_match_one_process():
    """2 ranks of a BatchNorm SIREN layer and the global albedo minimum
    against one process on the whole batch: the layer's output, its
    gradients, the running statistics and the minimum's gradient to 1e-5
    (float32; only the order of the sums differs), each gradient to 1e-5
    of its own largest value (BatchNorm's backward subtracts the batch
    means, so an element's rounding is that of the largest: measured
    4.5e-6 on an element of 2.4 beside others of 17).  The linear bias
    feeds the BatchNorm, so its gradient is zero up to rounding (measured
    6e-6 of it): held below 1e-5 of the layer's largest gradient.  The minimum
    of each channel lies on another rank, so its gradient reaches one
    rank and is counted once."""
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
    n, c_in, c = 64, 8, 16
    x, g, w = t(n, c_in), t(n, c), t(3)
    albedo = torch.rand(n, 3, generator=torch.Generator().manual_seed(1))
    albedo[5, 0], albedo[40, 1], albedo[63, 2] = -1.0, -2.0, -3.0
    layer = torch_mesh_ranks.SineLayer(c_in, c, use_norm=True)
    with torch.no_grad():
        layer.norm.running_mean.uniform_(-1, 1)
        layer.norm.weight.uniform_(0.5, 1.5)
    state = layer.state_dict()
    one = torch_mesh_ranks.bn_and_min(None, state, x, g, albedo, w)
    ranks = launch(torch_mesh_ranks.bn_and_min, CPU(2), state, x, g, albedo,
                   w)
    close = lambda a, b, m: np.testing.assert_allclose(
        a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6, err_msg=m)
    close(torch.cat([r["y"] for r in ranks]), one["y"], "y")
    close(torch.cat([r["albedo_grad"] for r in ranks]), one["albedo_grad"],
          "albedo grad")
    assert torch.count_nonzero(one["albedo_grad"]) == 3
    top = max(float(v.abs().max()) for v in one["grads"].values())
    for r in ranks:
        close(r["min"], one["min"], "min")
        for k, v in one["grads"].items():
            if k == "linear.bias":
                assert float(r["grads"][k].abs().max()) < 1e-5 * top
                assert float(v.abs().max()) < 1e-5 * top
            else:
                np.testing.assert_allclose(
                    r["grads"][k].numpy(), v.numpy(), rtol=0,
                    atol=1e-5 * float(v.abs().max()), err_msg=k)
        for k, v in one["running"].items():
            close(r["running"][k], v, k)


# --- the render mesh ---------------------------------------------------------
@pytest.fixture(scope="module")
def render_models():
    jm = JTNeRF(layer_width=32, n_classes=4)
    v = jm.init(jax.random.PRNGKey(3), jnp.zeros((2, 3)), jnp.zeros((2, 3)),
                jnp.zeros((2, 4)), train=False)
    tm = TTNeRF(layer_width=32, n_classes=4).load_weights(
        state_dict_from_flax(jax.device_get(v["params"]),
                             jax.device_get(v["batch_stats"])))
    return jm, v, tm.eval()


@pytest.mark.parametrize("fast", [None, (8, 8)], ids=["exact", "fast"])
def test_mesh_render_matches_one_device_and_the_jax_mesh(render_models,
                                                         fast):
    """3 replicas at chunk 300 (not a multiple of 3: rounded up to 300,
    ragged parts) against one device at 1e-5, and against the JAX
    package's 8-device Renderer (``test_mesh_render_matches_single_device``)
    at 1e-5: float32 and the exact sine on both sides."""
    jm, v, tm = render_models
    kw = dict(n_samples=8, chunk=300, fast_render=fast)
    one = TRenderer(tm, **kw)
    mesh = TRenderer(tm, mesh=CPU(3), **kw)
    assert mesh.chunk == 300 and len(mesh.replicas) == 3
    assert mesh.replicas[0][0] is tm
    assert all(r is not tm for r, _ in mesh.replicas[1:])
    jr = JRenderer(jm, v, mesh=j_make_mesh(8), **kw)
    args = ((70.0, 40.0), (45.0, 180.0), 0.5, 24)
    want, got = one.render_img(*args), mesh.render_img(*args)
    j = jr.render_img(*args)
    for k in ("Col_Img", "Shadow_Mask", "Height"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], np.asarray(j[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=f"jax {k}")
    # the component path and the exact-shadow points split too
    cw = one.component_render_by_dir((70.0, 40.0), (45.0, 180.0), 0.5,
                                     (10, 10), exact_solar=True)
    cg = mesh.component_render_by_dir((70.0, 40.0), (45.0, 180.0), 0.5,
                                      (10, 10), exact_solar=True)
    for k in ("rho", "col_raw", "vis", "exact_solar"):
        np.testing.assert_allclose(cg[k], cw[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_mesh_chunk_rounds_up_to_the_devices(render_models):
    _, _, tm = render_models
    r = TRenderer(tm, n_samples=8, chunk=301, mesh=CPU(3))
    assert r.chunk == 303
    assert TRenderer(tm, chunk=301, mesh=CPU(1)).mesh is None


# --- make_mesh and the placements --------------------------------------------
def test_make_mesh_refuses_oversubscription():
    """One CPU is visible: a mesh of 2 is refused, as the JAX package
    refuses more devices than it sees; a mesh named device by device may
    repeat one."""
    with pytest.raises(ValueError, match="refusing to silently build a "
                                         "smaller mesh"):
        make_mesh(2)
    with pytest.raises(ValueError, match="asked for 3 devices but only 2"):
        make_mesh(3, devices=["cpu", "cpu"])
    assert make_mesh().size == 1
    assert make_mesh(2, devices=["cpu"] * 4).size == 2


def test_shard_batch_layout():
    """Each rank takes its contiguous rows (test_parallel's 64 x 22 over
    8); a replicated tensor stays whole on the rank's device."""
    mesh = CPU(8)
    mesh.rank = 3
    x = torch.arange(64 * 22.0).reshape(64, 22)
    assert batch_sharding(mesh, 64) == slice(24, 32)
    got = shard_batch({"rows": x, "idx": torch.arange(64)}, mesh)
    assert got["rows"].shape == (8, 22)
    assert torch.equal(got["rows"], x[24:32])
    assert torch.equal(got["idx"], torch.arange(24, 32))
    assert x.to(replicated_sharding(mesh)).shape == (64, 22)
    with pytest.raises(ValueError, match="does not split"):
        batch_sharding(mesh, 65)


def test_backend_follows_the_devices():
    """NCCL where the ranks hold distinct cards, gloo where they share one
    (NCCL takes one rank a card) or run on the CPU."""
    assert backend_for(make_mesh(devices=["cuda:0", "cuda:1"])) == "nccl"
    assert backend_for(make_mesh(devices=["cuda:0"])) == "nccl"
    assert backend_for(make_mesh(devices=["cuda:0", "cuda:0"])) == "gloo"
    assert backend_for(CPU(2)) == "gloo"
