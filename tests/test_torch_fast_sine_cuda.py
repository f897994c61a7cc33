"""The polynomial sine's kernel (``csrc/fast_sine.cu``) on the card,
through the operators ``season_nerf::fast_sine`` and
``season_nerf::fast_sine_grad`` (``ops/fast_math.py``): both directions,
sine and cosine, float32 and bf16, against the plain chain at one SIREN
layer's activations of a flagship step (393,216 x 512, x in +-1e3); the
bf16 store bit for bit the kernel's own float32 result cast (the plain
chain cast differs where the two float32 values round apart); the degrees 9 and
7 (one child process each, the library named by the build digest); the
2^31 refusal; non-contiguous, misaligned and ragged inputs; a SineLayer's
one launch a direction, counted by ``fast_sine.launches``, and an
exported SineLayer calling the kernel.

Tolerance: 2e-6 absolute against the plain chain.  The kernel runs K0's
Horner chain with fused multiply-adds; the plain chain rounds after every
product and sum.  The reduction is the same in both (rounded products, so
y is bit-equal), so the two differ by a few ulps of values of magnitude
at most 1 (1.2e-7 an ulp near 1).

Every test here needs a CUDA card and skips without one:

    python -m pytest -m gpu --noconftest tests/test_torch_fast_sine_cuda.py -q
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from season_nerf_torch.models.siren import SineLayer
from season_nerf_torch.ops import cuda_build
from season_nerf_torch.ops import fast_math as fm
from season_nerf_torch.utils import trace

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = (4096 * 96, 512)     # one SIREN layer's z in a flagship step
ATOL = 2e-6


def launched() -> int:
    """The sine kernel's launches so far (``fast_sine.launches``)."""
    return trace.counters()["fast_sine.launches"]


@pytest.fixture(scope="module")
def cuda():
    """The card; every test of this file skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with -m gpu on a machine with "
                    "one (see the module docstring)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def flagship_x(cuda):
    gen = torch.Generator(device=cuda).manual_seed(17)
    return (torch.rand(FLAGSHIP, generator=gen, device=cuda) * 2 - 1) * 1e3


def _plain(x, cosine):
    return fm.plain_cos(x) if cosine else fm.plain_sin(x)


def _within_the_casts(got, want):
    """bf16 values that are casts of float32 values ATOL apart: apart by at
    most ATOL and half a bf16 step (2^-8 of the value) for each cast.  Near
    the sine's zeros the polynomial cancels, so the f32 values may differ
    by far more than an ulp of their own there, though not beyond ATOL."""
    a, b = got.float(), want.float()
    return bool(((a - b).abs() <= ATOL + 2.0 ** -8 * (a.abs() + b.abs()))
                .all())


@pytest.mark.parametrize("cosine", [False, True], ids=["sin", "cos"])
def test_forward_matches_the_plain_chain(cuda, flagship_x, cosine):
    x = flagship_x
    n0 = launched()
    y = fm.sine_op(x, cosine, False)
    yb = fm.sine_op(x, cosine, True)
    assert launched() - n0 == 2
    assert (y.dtype, yb.dtype) == (torch.float32, torch.bfloat16)
    assert y.shape == yb.shape == x.shape
    want = _plain(x, cosine)
    assert float((y - want).abs().max()) <= ATOL
    # the cast in the store is sine-then-cast, bit for bit
    assert torch.equal(yb, y.to(torch.bfloat16))
    # against the plain chain cast: only where the f32 values differ, and
    # no further than the two casts of values ATOL apart
    wantb = want.to(torch.bfloat16)
    assert not ((yb != wantb) & (y == want)).any()
    assert _within_the_casts(yb, wantb)


@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16],
                         ids=["g_f32", "g_bf16"])
@pytest.mark.parametrize("cosine", [False, True], ids=["sin", "cos"])
def test_backward_matches_the_plain_chain(cuda, flagship_x, cosine, gdtype):
    x = flagship_x
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = (torch.rand(FLAGSHIP, generator=gen, device=cuda) * 2 - 1).to(gdtype)
    n0 = launched()
    dx = fm.sine_grad_op(x, g, cosine)
    assert launched() - n0 == 1
    assert dx.dtype == torch.float32 and dx.shape == x.shape
    want = (-fm.plain_sin(x) if cosine else fm.plain_cos(x)) * g.float()
    assert float((dx - want).abs().max()) <= ATOL
    if gdtype == torch.bfloat16:        # the load's cast is exact
        assert torch.equal(dx, fm.sine_grad_op(x, g.float(), cosine))


DEGREE_CHILD = r"""
import json, math, torch
from season_nerf_torch.ops import cuda_build, fast_math as fm
from season_nerf_torch.utils import trace
x = (torch.rand(4099, 515, device="cuda") * 2 - 1) * 1e3
near = (torch.rand(4099, 515, device="cuda") * 2 - 1) * math.pi
g = torch.rand(4099, 515, device="cuda") * 2 - 1
err = lambda a, b: float((a - b).abs().max())
print(json.dumps({
    "degree": fm.DEGREE, "library": cuda_build.library_path(fm.KERNEL).name,
    "sin": err(fm.fast_sin(x), fm.plain_sin(x)),
    "cos": err(fm.fast_cos(x), fm.plain_cos(x)),
    "grad": err(fm.sine_grad_op(x, g, False), fm.plain_cos(x) * g),
    "against_sin": err(fm.fast_sin(near), torch.sin(near.double()).float()),
    "launches": trace.counters()["fast_sine.launches"]}))
"""

# the polynomial's own error against sin on [-pi, pi]
# (tests/test_torch_fast_sine_degree.py): at least this, and at most
DEGREE_ERR = {9: (2e-6, 1.5e-5), 7: (1e-4, 6e-4)}


@pytest.mark.parametrize("degree", sorted(DEGREE_ERR))
def test_kernel_at_lower_sine_degrees(cuda, degree):
    """Built with -DFAST_SIN_DEGREE in a child process (the degree is read
    at import): another library by its digest, the plain chain's value at
    that degree, and the degree's own error against sin."""
    proc = subprocess.run([sys.executable, "-c", DEGREE_CHILD], cwd=ROOT,
                          env={**os.environ, "FAST_SIN_DEGREE": str(degree),
                               "PYTHONPATH": ROOT},
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["degree"] == degree
    assert res["library"] != cuda_build.library_path(fm.KERNEL).name
    assert max(res["sin"], res["cos"], res["grad"]) <= ATOL, res
    lo, hi = DEGREE_ERR[degree]
    assert lo <= res["against_sin"] <= hi, res
    assert res["launches"] == 4


def test_refuses_2_31_elements_and_other_dtypes(cuda):
    big = torch.zeros(1, device=cuda).expand(2 ** 31)   # nothing allocated
    n0 = launched()
    with pytest.raises(ValueError, match=r"2\^31"):
        fm.sine_op(big, False, False)
    with pytest.raises(ValueError, match=r"2\^31"):
        fm.sine_grad_op(big, big, True)
    x = torch.ones(16, device=cuda)
    with pytest.raises(ValueError, match="float32 x"):
        fm.sine_op(x.double(), False, False)
    with pytest.raises(ValueError, match="gradient"):
        fm.sine_grad_op(x, x.half(), False)
    with pytest.raises(ValueError, match="gradient"):
        fm.sine_grad_op(x, x[:8], False)
    assert launched() == n0


def test_non_contiguous_misaligned_and_ragged_inputs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.rand(1001, 517, generator=gen, device=cuda) * 2 - 1) * 300
    for cosine in (False, True):
        full = fm.sine_op(x, cosine, False)
        assert float((full - _plain(x, cosine)).abs().max()) <= ATOL
        # transposed: the same values, laid out contiguously
        t = fm.sine_op(x.t(), cosine, False)
        assert t.is_contiguous() and torch.equal(t, full.t())
        # a 4-byte offset (the scalar path) and a ragged tail
        flat = x.reshape(-1)
        assert torch.equal(fm.sine_op(flat[1:], cosine, True),
                           full.reshape(-1)[1:].to(torch.bfloat16))
        assert torch.equal(fm.sine_op(flat[:8 * 1000 + 5], cosine, False),
                           full.reshape(-1)[:8005])
    # the gradient of a sum arrives expanded (stride 0)
    xr = x.t().clone().requires_grad_()
    fm.fast_sin(xr).sum().backward()
    assert torch.equal(xr.grad, fm.sine_op(x.t(), True, False))
    assert fm.sine_op(x[:0], False, False).shape == (0, 517)


def test_sine_layer_launches_once_a_direction(cuda):
    """A bf16 SineLayer with fast_sine: one launch forward (the cast in its
    store), one backward; its activation is sine-then-cast bit for bit;
    second order still runs on the card."""
    torch.manual_seed(0)
    layer = SineLayer(64, 256, use_norm=True, dtype=torch.bfloat16,
                      fast_sine=True).to(cuda)
    x = torch.randn(4096, 64, device=cuda, requires_grad=True)
    n0 = launched()
    y = layer(x)
    assert launched() - n0 == 1 and y.dtype == torch.bfloat16
    (y.float() ** 2).sum().backward()
    assert launched() - n0 == 2
    layer.eval()
    with torch.no_grad():
        y = layer(x)
        z = layer.bn_eval((layer.omega_0 * layer.linear(
            x, None, layer.dtype)).float())
        assert torch.equal(y, fm.sine_op(z, False, False).to(torch.bfloat16))
    xr = (torch.rand(1000, device=cuda) * 2 - 1) * 50
    xr.requires_grad_()
    (g1,) = torch.autograd.grad(fm.fast_sin(xr).sum(), xr, create_graph=True)
    (g2,) = torch.autograd.grad(g1.sum(), xr)
    assert float((g2 + fm.plain_sin(xr.detach())).abs().max()) <= ATOL


def test_exported_sine_layer_calls_the_kernel(cuda):
    layer = SineLayer(32, 64, use_norm=True, dtype=torch.bfloat16,
                      fast_sine=True).to(cuda).eval()
    x = torch.randn(513, 32, device=cuda)
    ep = torch.export.export(layer, (x,))
    assert any("season_nerf.fast_sine" in str(n.target)
               for n in ep.graph.nodes)
    n0 = launched()
    got = ep.module()(x)
    assert launched() - n0 == 1
    assert torch.equal(got, layer(x))
