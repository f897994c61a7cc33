"""The training BatchNorm of a ``SineLayer`` on the card
(``ops/batchnorm_train.py``: ``csrc/batchnorm_train.cu`` and the folded
launches of ``csrc/fast_sine.cu``): the kernels against the plain version
on the card at a flagship step's shapes (393,216 rows x 512 and x 256,
bf16) and at widths that take the scalar path or a second slab of columns,
two runs bit for bit, the unfolded sine instances unchanged, the mesh's
branch at world size 1, a default training step's launches and a ghost
step's.

Tolerances, each against the plain version's value on the card.  The
kernels sum the statistics in double, the plain version in float32
(torch's reductions), whose fast variance E[z^2] - E[z]^2 loses about
log2(kappa) bits to cancellation, kappa = E[z^2] / var of the column: these
inputs keep kappa below 100 (a trained layer's columns spread about as far
as their means lie from 0), so that the plain version's rstd holds about
1e-5 relative:

- the running mean and variance: 2e-6 of their largest (measured up to
  4.9e-7 on three seeds a width, NVIDIA H100 80GB HBM3);
- ``y``: the sine's argument moves by |xhat| times rstd's difference, and
  the polynomial's FMA chain against the plain chain adds 2e-6
  (``test_torch_fast_sine_cuda.py``): 3e-5 beyond the two casts' half
  steps (measured 6.6e-6);
- ``dz``, the scale's and the shift's gradients: the same difference in
  the argument moves du, and the column sums over 393,216 rows run in
  another order: 2e-5 of each's largest (measured 3.9e-6), beyond the two
  casts of ``dz``.

Where kappa is large the plain version departs from the batch's exact
statistics and the kernels do not: the high-kappa test holds the kernels
to the same arithmetic in double at the tolerances above, and the plain
version to the kernels within what its own float32 statistics move the
sine's argument.

Every test here needs a CUDA card and skips without one:

    python -m pytest -m gpu --noconftest tests/test_torch_batchnorm_cuda.py -q
"""

import copy

import pytest
import torch

from season_nerf_torch.models.siren import SineLayer
from season_nerf_torch.ops import batchnorm_train as bt
from season_nerf_torch.ops import fast_math as fm
from season_nerf_torch.utils import trace

import sine_instances
import torch_mesh_ranks

pytestmark = pytest.mark.gpu

ROWS = 4096 * 96
Y_ATOL = 3e-5
STATS_RTOL = 2e-6
GRAD_RTOL = 2e-5
KAPPA = 100


@pytest.fixture(scope="module")
def cuda():
    """The card; every test of this file skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with -m gpu on a machine with "
                    "one (see the module docstring)")
    return torch.device("cuda")


def _inputs(cuda, c, seed, rows=ROWS, means=None, spreads=(2.0, 10.0)):
    """A layer's bf16 z (column means 5 N(0, 1), or uniform in +-``means``;
    spreads uniform in ``spreads``), a constant column (its variance 0 in
    both sums: 0.75 times any count up to 2^22 is exact), a bf16 gradient,
    and a BatchNorm."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if means is None:
        mean = torch.randn(c, generator=gen, device=cuda) * 5
    else:
        mean = (torch.rand(c, generator=gen, device=cuda) * 2 - 1) * means
    lo, hi = spreads
    std = torch.rand(c, generator=gen, device=cuda) * (hi - lo) + lo
    z = (torch.randn(rows, c, generator=gen, device=cuda) * std
         + mean).to(torch.bfloat16)
    z[:, 3] = 0.75
    g = torch.randn(rows, c, generator=gen, device=cuda).to(torch.bfloat16)
    norm = torch.nn.BatchNorm1d(c).to(cuda)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5, generator=gen)
        norm.bias.uniform_(-0.5, 0.5, generator=gen)
        norm.running_mean.normal_(generator=gen)
        norm.running_var.uniform_(0.5, 1.5, generator=gen)
    return z, g, norm


def _run(z, g, norm, plain):
    n = copy.deepcopy(norm)
    zr = z.clone().requires_grad_()
    y = bt.batchnorm_sine(zr, n, None, plain)
    y.backward(g)
    return {"y": y, "dz": zr.grad, "dscale": n.weight.grad,
            "dshift": n.bias.grad, "running_mean": n.running_mean,
            "running_var": n.running_var}


def _launched(before):
    """(column-sum and dz launches, sine launches) since ``before``."""
    after = trace.counters()
    return tuple(after[k] - before[k]
                 for k in ("batchnorm.launches", "fast_sine.launches"))


def _gap(got, want, rtol_of_max=0.0, casts=False):
    """The largest excess of |got - want| over the casts' half steps, as a
    share of want's largest where ``rtol_of_max`` (else absolute)."""
    a, b = got.detach().float(), want.detach().float()
    d = (a - b).abs()
    if casts:       # bf16 casts of float32 values apart by the gap
        d = (d - 2.0 ** -8 * (a.abs() + b.abs())).clamp_min(0)
    return float(d.max() / (b.abs().max() if rtol_of_max else 1.0))


TOL = dict(running_mean=STATS_RTOL, running_var=STATS_RTOL,
           dscale=GRAD_RTOL, dshift=GRAD_RTOL, y=Y_ATOL, dz=GRAD_RTOL)


def _gaps(got, want):
    """Each output's gap, as TOL measures it."""
    gaps = {k: _gap(got[k], want[k], True)
            for k in ("running_mean", "running_var", "dscale", "dshift")}
    gaps["y"] = _gap(got["y"], want["y"], casts=True)
    gaps["dz"] = _gap(got["dz"], want["dz"], True, casts=True)
    return gaps


def _kappa_below(z, bound):
    zf = z.float()
    var = zf.var(0, unbiased=False)
    kappa = (zf * zf).mean(0) / var
    return float(kappa[var > 0].max()) < bound


@pytest.mark.parametrize("width", [512, 256])
def test_kernels_match_the_plain_version(cuda, width):
    z, g, norm = _inputs(cuda, width, 11 + width)
    assert _kappa_below(z, KAPPA)
    before = trace.counters()
    got = _run(z, g, norm, plain=False)
    torch.cuda.synchronize(cuda)
    assert _launched(before) == (2, 2)
    want = _run(z, g, norm, plain=True)
    gaps = _gaps(got, want)
    assert all(gaps[k] <= TOL[k] for k in TOL), gaps


@pytest.mark.parametrize("width", [100, 300, 2056])
def test_kernels_take_every_width(cuda, width):
    """A width that is no multiple of 8 takes one column a thread (100; 300
    in two slabs of 256 and 44 columns), one above 2,048 a second slab of
    vector columns (2,056: 2,048 and 8), held to the plain version at the
    flagship's tolerances on 20,011 rows."""
    z, g, norm = _inputs(cuda, width, 7 + width, rows=20011)
    assert _kappa_below(z, KAPPA)
    got = _run(z, g, norm, plain=False)
    want = _run(z, g, norm, plain=True)
    gaps = _gaps(got, want)
    assert all(gaps[k] <= TOL[k] for k in TOL), gaps


@pytest.mark.parametrize("width", [100, 2056])
def test_a_training_layer_of_any_width_takes_the_kernels(cuda, width):
    """A bf16 training SineLayer with BatchNorm and the polynomial sine
    runs the kernels at any width: two BatchNorm launches (column sums,
    dz) and two of the sine, whatever the width."""
    layer = SineLayer(16, width, use_norm=True, dtype=torch.bfloat16,
                      fast_sine=True).to(cuda).train()
    x = torch.randn(4099, 16, device=cuda)
    before = trace.counters()
    layer(x).float().sum().backward()
    torch.cuda.synchronize(cuda)
    assert _launched(before) == (2, 2)
    assert torch.isfinite(layer.norm.weight.grad).all()


def _double(z, g, norm, stats):
    """The batch's statistics in double, and the kernels' arithmetic in
    double from the statistics they store (``stats``: mean, rstd and mul =
    rstd * scale in float32): the sine (torch's, which the polynomial
    follows to 2e-6), du, its sums and dz."""
    zd = z.double()
    shift = norm.bias.detach().double()
    n = zd.shape[0]
    mean = zd.mean(0)
    d = (zd * zd).mean(0) - mean * mean
    var = d.clamp_min(0)
    mean_f, rstd_f, mul_f = stats[:3].double()
    xhat = (zd - mean_f) * rstd_f
    arg = (zd - mean_f) * mul_f + shift
    du = torch.cos(arg) * g.double()
    a, b = du.sum(0), (du * xhat).sum(0)
    dz = mul_f * (du - a / n - torch.where(d >= 0, xhat, 0.0) * b / n)
    keep = bt.BN_MOMENTUM
    return {"y": torch.sin(arg), "dz": dz, "dscale": b, "dshift": a,
            "running_mean": keep * norm.running_mean.double()
            + (1 - keep) * mean,
            "running_var": keep * norm.running_var.double()
            + (1 - keep) * var,
            "mean": mean, "rstd": torch.rsqrt(var + bt.BN_EPS),
            "kappa": (zd * zd).mean(0) / var}


def test_kernels_hold_to_double_where_the_variance_cancels(cuda):
    """Column means to +-15 and spreads down to 0.1 (kappa to about 1.4e4):
    the fast variance E[z^2] - E[z]^2 cancels.  The kernels' statistics:
    the running ones within the tolerance above of the batch's in double,
    and rstd within the float32 cancellation bound of their sums.  A
    thread sums m rows in float32, its block the lanes' sums, and the merge
    adds the blocks in double, so E[z^2] and E|z| carry at most (m + lanes)
    2^-24 relative; the fast variance turns that into 3 (m + lanes) 2^-24
    kappa of var, and rstd into half of it, plus its own rounding, 2^-24
    (measured up to 1.4e-5 relative, at kappa 8,400).  From those statistics their outputs hold to the same arithmetic in
    double at the tolerances above.  The plain version, whose float32
    reductions round many more terms, is held to the kernels within what
    its own float32 statistics move the sine's argument, scale * (max |z -
    mean| * |rstd32 - rstd| + |mean32 - mean| * rstd32) of each column
    (exact, |sin'| <= 1), and its own float32 steps' 3e-5."""
    z, g, norm = _inputs(cuda, 512, 3, means=15.0, spreads=(0.1, 1.0))
    assert not _kappa_below(z, 1e3)
    got = _run(z, g, norm, plain=False)
    _, stats = bt._kernel_stats(z, norm.weight.detach(),
                                norm.running_mean.clone(),
                                norm.running_var.clone(), None)
    exact = _double(z, g, norm, stats)
    kappa = exact["kappa"]
    live = torch.isfinite(kappa)
    blocks = bt._blocks(bt.LIB, "bn_stats_blocks", z)
    lanes = 256 // (z.shape[1] // 8)
    terms = -(-z.shape[0] // (blocks * lanes)) + lanes
    bound = 1.5 * terms * 2.0 ** -24 * kappa + 2.0 ** -24
    err = (stats[1].double() / exact["rstd"] - 1).abs()
    assert bool((err <= bound)[live].all()), float((err / bound)[live].max())
    gaps = _gaps(got, exact)
    assert all(gaps[k] <= TOL[k] for k in TOL), gaps

    zf = z.float()
    mean32 = zf.mean(0)
    var32 = (torch.mean(zf * zf, 0) - mean32 * mean32).clamp_min(0)
    rstd32 = torch.rsqrt(var32 + bt.BN_EPS).double()
    mean, rstd = exact["mean"], exact["rstd"]
    reach = (z.double() - mean).abs().amax(0)
    moved = norm.weight.detach().double().abs() * (
        reach * (rstd32 - rstd).abs() + (mean32.double() - mean).abs()
        * rstd32)
    assert float(moved.max()) > Y_ATOL      # the plain version departs
    plain = _run(z, g, norm, plain=True)
    a, b = plain["y"].double(), got["y"].double()
    excess = (a - b).abs() - 2.0 ** -8 * (a.abs() + b.abs())
    assert bool((excess <= 2 * Y_ATOL + moved).all()), \
        float((excess - moved).max())


def test_two_runs_are_bitwise_equal(cuda):
    z, g, norm = _inputs(cuda, 512, 5)
    a, b = _run(z, g, norm, False), _run(z, g, norm, False)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_the_unfolded_sine_instances_are_unchanged(cuda):
    """The launches of the branch layers, the ghost step and the renderer
    give the bits they gave before the folded variants were written."""
    if fm.DEGREE != 11:
        pytest.skip("recorded at FAST_SIN_DEGREE 11")
    assert sine_instances.checksums(fm, cuda) == sine_instances.RECORDED


def test_refuses_what_the_kernels_do_not_take(cuda):
    norm = torch.nn.BatchNorm1d(12).to(cuda)
    before = trace.counters()
    for z in (torch.ones(64, 12, device=cuda),
              torch.ones(4, 16, 12, device=cuda, dtype=torch.bfloat16),
              torch.ones(0, 12, device=cuda, dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="BatchNorm kernels"):
            bt.batchnorm_sine(z, norm)
    z = torch.ones(64, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="parameters"):
        bt.batchnorm_sine(z, norm)          # 12 columns of statistics
    assert trace.counters() == before


def test_the_mesh_branch_at_world_size_1_matches_the_no_mesh_launch(cuda):
    """On a mesh of the card over NCCL at world size 1 the kernels take
    their mesh branch (the sums written in double, all-reduced, then the
    finish launch; the backward's sums all-reduced): with one rank every
    all-reduce gives back its input, so each output equals the no-mesh
    launch's bit for bit."""
    from season_nerf_torch.parallel.mesh import (backend_for, launch,
                                                 make_mesh)
    z, g, norm = _inputs(cuda, 512, 21, rows=65536)
    state = {k: v.cpu() for k, v in norm.state_dict().items()}
    one = torch_mesh_ranks.bn_sine(None, state, z, g, False)
    mesh = make_mesh(devices=[cuda])
    assert backend_for(mesh) == "nccl"
    rank, = launch(torch_mesh_ranks.bn_sine, mesh, state, z.cpu(), g.cpu(),
                   False)
    assert all(torch.equal(rank[k], one[k]) for k in one), \
        [k for k in one if not torch.equal(rank[k], one[k])]


def _trainer(cuda, **kw):
    from season_nerf_torch.config import Config
    from season_nerf_torch.data.synthetic import make_scene, scene_ray_tables
    from season_nerf_torch.train.engine import Trainer
    scene = make_scene(n_views=3, img_size=16, grid=16, seed=0)
    table, _ = scene_ray_tables(scene, testing_size=1)
    cfg = Config(fc_units=256, batch_size=64, n_samples=32,
                 max_train_steps=10, compute_dtype="bfloat16",
                 fast_sine=True, **kw)
    return Trainer(cfg, table, prior_hm=scene.prior_hm, device=cuda)


@pytest.mark.parametrize("pallas_trunk,sines,norms",
                         [(False, 49, 24), (True, 22, 0)],
                         ids=["default", "ghost"])
def test_a_train_step_launches(cuda, pallas_trunk, sines, norms):
    """A default step: the sine's 49 launches (the trunk's folded among
    them) and 16 column-sum and 8 dz launches (fc2..fc9, camera and solar
    pass forward, the camera pass backward); a ghost step (K1/K2
    normalise): 22 and none; the new dz span on autograd's thread, inside
    ``train.backward``."""
    tr = _trainer(cuda, pallas_trunk=pallas_trunk)
    tr.train_step()
    before = trace.counters()
    trace.drain()
    trace.enable()
    try:
        tr.train_step()
        torch.cuda.synchronize(cuda)
    finally:
        trace.disable()
    spans = trace.drain()
    after = trace.counters()
    assert after["fast_sine.launches"] - before["fast_sine.launches"] == sines
    assert after["batchnorm.launches"] - before["batchnorm.launches"] == norms
    dz = [s for s in spans if s.name == "siren.batchnorm_bwd"]
    assert len(dz) == norms // 3
    if dz:
        back, = [s for s in spans if s.name == "train.backward"]
        ids = {s.id: s for s in spans}
        for s in dz:
            assert back.start <= s.start <= s.end <= back.end
            p = s.parent
            while p is not None:
                assert ids[p].name not in ("siren.sine", "siren.batchnorm")
                p = ids[p].parent
