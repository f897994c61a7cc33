"""The training BatchNorm of a ``SineLayer`` as one autograd Function
(``ops/batchnorm_train.py``) on the CPU: its plain version, the arithmetic
the card's kernels are held to, against autograd of ``SineLayer.bn_train``
followed by the plain sine and the cast to bf16, which the CPU's training
path still runs; on one process and on a 2-rank gloo mesh.  No JAX.

The forward is ``bn_train``'s own arithmetic, so the activation and the
running statistics are equal bit for bit.  The backward is the explicit
``dz = mul * (du - a / N - xhat * b / N)`` against autograd's replay of
the forward's passes: in float32 they agree to 1e-6 of the largest |dz|
(measured 1e-7: the order of the sums and autograd's separate paths through
the mean and the variance), and each bf16 dz is the cast of one of two such
values.  The scale's gradient ``sum du * xhat`` against autograd's ``rstd *
sum du * (z - mean)``: 1e-6 of its largest (measured 2.4e-7); the shift's
``sum du`` is the same sum.

About 15 s on one worker, most of it the mesh's two spawned ranks.
"""

import copy

import pytest
import torch

from season_nerf_torch.models.siren import SineLayer
from season_nerf_torch.ops import batchnorm_train as bt
from season_nerf_torch.ops import fast_math as fm
from season_nerf_torch.parallel.mesh import launch, make_mesh
from season_nerf_torch.utils import trace

import torch_mesh_ranks

torch.set_num_threads(1)

ROWS = 3007             # no multiple of a block's rows or lanes
DZ_RTOL = 1e-6
GRAD_RTOL = 1e-6
MESH_RTOL = 1e-4
# bf16 values that may sit in a constant column; with ROWS rows some make
# torch's float32 E[z^2] - E[z]^2 negative, so the fast variance clamps
CONSTANTS = [float(torch.tensor(0.0371 * i).bfloat16()) for i in range(1, 60)]


def _layer(width, seed):
    """A bf16 BatchNorm SineLayer and a z [ROWS, width] with a trained
    layer's spread (column means to +-15, spreads 0.5-3.5), one column
    constant at a value whose fast variance
    clamps, and a bf16 gradient for the layer's output."""
    gen = torch.Generator().manual_seed(seed)
    layer = SineLayer(8, width, use_norm=True, dtype=torch.bfloat16,
                      fast_sine=True).train()
    with torch.no_grad():
        layer.norm.weight.uniform_(0.5, 1.5, generator=gen)
        layer.norm.bias.uniform_(-0.5, 0.5, generator=gen)
        layer.norm.running_mean.normal_(generator=gen)
    z = (torch.randn(ROWS, width, generator=gen)
         * (torch.rand(width, generator=gen) * 3 + 0.5)
         + torch.randn(width, generator=gen) * 5)
    for v in CONSTANTS:
        z[:, 5] = v
        zf = z.bfloat16().float()
        m = zf.mean(0)
        if float(torch.mean(zf * zf, 0)[5] - m[5] * m[5]) < 0:
            break
    else:
        pytest.fail("no constant column clamps")
    g = torch.randn(ROWS, width, generator=gen).bfloat16()
    return layer, z.bfloat16(), g


def _within_casts(got, want, tol):
    """bf16 casts of float32 values ``tol`` apart."""
    a, b = got.float(), want.float()
    return bool(((a - b).abs() <= tol + 2.0 ** -8 * (a.abs() + b.abs()))
                .all())


@pytest.mark.parametrize("width", [512, 256])
def test_plain_version_matches_autograd_of_bn_train(width):
    layer, z, g = _layer(width, width)
    ours = copy.deepcopy(layer.norm)
    before = trace.counters()

    zr = z.clone().requires_grad_()
    want = fm.fast_sin(layer.bn_train(zr.float()), torch.bfloat16)
    want.backward(g)

    zp = z.clone().requires_grad_()
    got = bt.batchnorm_sine(zp, ours, None, plain=True)
    got.backward(g)

    _, stats = bt._plain_stats(z, ours.weight, ours.running_mean.clone(),
                               ours.running_var.clone(), None)
    assert int((stats[3] == 0).sum()) == 1      # the clamped column
    assert torch.equal(got, want)
    assert torch.equal(ours.running_mean, layer.norm.running_mean)
    assert torch.equal(ours.running_var, layer.norm.running_var)
    top = float(zr.grad.float().abs().max())
    assert _within_casts(zp.grad, zr.grad, DZ_RTOL * top)
    for p, q in ((ours.weight, layer.norm.weight),
                 (ours.bias, layer.norm.bias)):
        assert float((p.grad - q.grad).abs().max()) \
            <= GRAD_RTOL * float(q.grad.abs().max())
    assert trace.counters() == before       # the CPU launches nothing


@pytest.fixture(scope="module")
def mesh_runs():
    """Both widths on one process and on 2 gloo ranks."""
    out = {}
    for width in (512, 256):
        layer, z, g = _layer(width, 3 * width)
        state = layer.norm.state_dict()
        z, g = z[:ROWS - 1], g[:ROWS - 1]
        one = torch_mesh_ranks.bn_sine(None, state, z, g)
        ranks = launch(torch_mesh_ranks.bn_sine,
                       make_mesh(devices=["cpu"] * 2), state, z, g)
        out[width] = one, ranks
    return out


@pytest.mark.parametrize("width", [512, 256])
def test_plain_version_on_a_2_rank_mesh_matches_one_process(mesh_runs,
                                                            width):
    """The global batch on 2 ranks of 1,503 rows against one process on
    3,006.  The statistics differ in their last bits (float32 sums
    all-reduced against one process's means: the running statistics to
    1e-6 of their largest, measured 3.2e-7), and the fast variance
    magnifies that in rstd by E[z^2] / var, up to about 100 here, so the
    sine's argument moves by up to 1e-4 (measured 1.6e-5), and with it du:
    the scale's and shift's gradients to 1e-4 of their largest (measured
    1.2e-5).  Those are the one process's after ``all_reduce_grads``, so
    each rank's own share is counted once, not once per rank; dz to 1e-6
    of its largest (measured 1e-7)."""
    one, ranks = mesh_runs[width]
    top = float(one["dz"].float().abs().max())
    assert _within_casts(torch.cat([r["y"] for r in ranks]), one["y"],
                         MESH_RTOL)
    assert _within_casts(torch.cat([r["dz"] for r in ranks]), one["dz"],
                         DZ_RTOL * top)
    for r in ranks:
        for k, rtol in (("dscale", MESH_RTOL), ("dshift", MESH_RTOL),
                        ("running_mean", 1e-6), ("running_var", 1e-6)):
            assert float((r[k] - one[k]).abs().max()) \
                <= rtol * float(one[k].abs().max()), k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_cpu_training_layer_keeps_bn_train(monkeypatch, dtype):
    """The CPU's training path is ``bn_train`` and autograd: only a bf16 z
    on a card goes to the Function."""
    def refuse(*a, **k):
        raise AssertionError("the CPU took the kernels' Function")
    monkeypatch.setattr(bt, "batchnorm_sine", refuse)
    layer = SineLayer(8, 16, use_norm=True, dtype=dtype,
                      fast_sine=True).train()
    x = torch.randn(32, 8)
    layer(x).float().sum().backward()
    assert layer.norm.weight.grad is not None
