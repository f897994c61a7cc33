"""The operators the polynomial sine goes through (``ops/fast_math.py``:
``season_nerf::fast_sine``, ``season_nerf::fast_sine_grad``) on the CPU:
registered, with fakes that give shape and dtype (``opcheck``: schema,
fake, autograd registration, dispatch); the CPU implementation bit for
bit the chain of passes the port ran before the operators existed
(written out below), in both directions, with the bf16 cast folded in; a
bf16 SineLayer bit for bit the same layer on that chain; ``torch.export``
and ``torch.compile(fullgraph=True)`` through them; derivatives of every
order following d fast_sin = fast_cos, d fast_cos = -fast_sin.  The
kernel itself runs only on a card: ``tests/test_torch_fast_sine_cuda.py``.
No JAX (``tests/test_torch_train_model.py`` holds the first and second
order against the JAX package).  A few seconds on one worker.
"""

import pytest
import torch

from season_nerf_torch.models.siren import SineLayer
from season_nerf_torch.ops import fast_math as fm


# --- the chain of passes the port ran before the operators ------------------
def _chain_sin(x):
    y = x - fm.TWO_PI * torch.round(x * fm.INV_TWO_PI)
    t = y * y
    p = torch.full_like(t, fm.POLY[0])
    for c in fm.POLY[1:]:
        p.mul_(t).add_(c)
    return y * p


def _chain_cos(x):
    return _chain_sin(x + fm.HALF_PI)


class _ChainSin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _chain_sin(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _chain_cos(x) * g


def _x(n=4099, seed=0, scale=1e3):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(n, generator=gen) * 2 - 1) * scale


# --- registration and fakes --------------------------------------------------
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("cosine", [False, True], ids=["sin", "cos"])
def test_sine_operator_passes_opcheck(cosine, bf16):
    x = _x(63).reshape(7, 9).requires_grad_()
    torch.library.opcheck(fm.sine_op, (x, cosine, bf16))


@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16],
                         ids=["g_f32", "g_bf16"])
@pytest.mark.parametrize("cosine", [False, True], ids=["sin", "cos"])
def test_sine_grad_operator_passes_opcheck(cosine, gdtype):
    x = _x(63).reshape(7, 9).requires_grad_()
    g = _x(63, seed=1, scale=1.0).reshape(7, 9).to(gdtype).requires_grad_()
    torch.library.opcheck(fm.sine_grad_op, (x, g, cosine))


def test_operators_are_registered_in_the_namespace():
    ops = torch.ops.season_nerf
    assert ops.fast_sine.default._schema.arguments[0].name == "x"
    assert [a.name for a in ops.fast_sine_grad.default._schema.arguments] \
        == ["x", "g", "cosine"]


@pytest.mark.parametrize("shape", [(5,), (3, 4, 6), (0, 512)])
def test_fakes_give_shape_and_dtype(shape):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty(shape)
        for bf16, dt in ((False, torch.float32), (True, torch.bfloat16)):
            y = fm.sine_op(x, False, bf16)
            assert (y.shape, y.dtype) == (x.shape, dt)
        dx = fm.sine_grad_op(x, torch.empty(shape, dtype=torch.bfloat16),
                             True)
        assert (dx.shape, dx.dtype) == (x.shape, torch.float32)


# --- the CPU implementation is the old chain ---------------------------------
@pytest.mark.parametrize("cosine", [False, True], ids=["sin", "cos"])
def test_cpu_operators_are_the_old_chain_bit_for_bit(cosine):
    x = _x()
    chain = _chain_cos(x) if cosine else _chain_sin(x)
    assert torch.equal(fm.sine_op(x, cosine, False), chain)
    assert torch.equal(fm.sine_op(x, cosine, True), chain.to(torch.bfloat16))
    assert torch.equal((fm.fast_cos if cosine else fm.fast_sin)(x), chain)
    slope = -_chain_sin(x) if cosine else _chain_cos(x)
    g = _x(seed=2, scale=1.0)
    for gd in (torch.float32, torch.bfloat16):
        gg = g.to(gd)
        # before: the bf16 output's gradient cast to f32, then the product
        assert torch.equal(fm.sine_grad_op(x, gg, cosine), slope * gg.float())


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_bf16_sine_layer_is_the_old_layer_bit_for_bit(training):
    """The cast folded into the operator: the activation, the input's and
    every parameter's gradient as the chain, then the cast, gave them."""
    torch.manual_seed(0)
    new = SineLayer(24, 40, use_norm=True, dtype=torch.bfloat16,
                    fast_sine=True).train(training)
    old = SineLayer(24, 40, use_norm=True, dtype=torch.bfloat16,
                    fast_sine=False).train(training)
    old.load_state_dict(new.state_dict())
    x = torch.randn(96, 24)
    outs = []
    for layer, sine in ((new, None), (old, _ChainSin.apply)):
        xi = x.clone().requires_grad_()
        if sine is None:
            y = layer(xi)
        else:
            z = (layer.omega_0 * layer.linear(xi, None, layer.dtype)).float()
            z = layer.bn_train(z) if training else layer.bn_eval(z)
            y = sine(z).to(layer.dtype)
        (y.float() * torch.linspace(-1, 1, y.numel()).view_as(y)).sum() \
            .backward()
        outs.append((y, xi.grad,
                     [p.grad for p in layer.parameters()]))
    (y1, g1, p1), (y0, g0, p0) = outs
    assert y1.dtype == torch.bfloat16 and torch.equal(y1, y0)
    assert torch.equal(g1, g0)
    assert all(torch.equal(a, b) for a, b in zip(p1, p0))


# --- export, compile, higher orders ------------------------------------------
@pytest.mark.parametrize("strict", [False, True])
def test_export_of_a_fast_sine_layer_records_the_operator(strict):
    layer = SineLayer(8, 16, use_norm=True, dtype=torch.bfloat16,
                      fast_sine=True).eval()
    x = torch.randn(5, 8)
    ep = torch.export.export(layer, (x,), strict=strict)
    targets = [str(n.target) for n in ep.graph.nodes]
    assert "season_nerf.fast_sine.default" in targets
    assert torch.equal(ep.module()(x), layer(x))


def test_compiled_training_layer_matches_eager():
    torch.manual_seed(1)
    layer = SineLayer(8, 16, use_norm=True, dtype=torch.bfloat16,
                      fast_sine=True)
    x = torch.randn(64, 8)
    grads = []
    for fn in (layer, torch.compile(layer, backend="eager", fullgraph=True)):
        torch._dynamo.reset()
        xi = x.clone().requires_grad_()
        y = fn(xi)
        y.float().pow(2).sum().backward()
        grads.append((y, xi.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


@pytest.mark.parametrize("cosine", [False, True], ids=["sin", "cos"])
def test_derivatives_of_every_order_follow_sin_and_cos(cosine):
    """d^k of fast_sin cycles fast_cos, -fast_sin, -fast_cos, fast_sin
    (fast_cos starts a quarter turn on), in values, not only in form."""
    x = _x(513, seed=3, scale=40.0).requires_grad_()
    s, c = _chain_sin(x.detach()), _chain_cos(x.detach())
    cycle = [c, -s, -c, s] if not cosine else [-s, -c, s, c]
    f = (fm.fast_cos if cosine else fm.fast_sin)(x)
    for want in cycle:
        (f,) = torch.autograd.grad(f.sum(), x, create_graph=True)
        assert torch.equal(f.detach(), want)
    # and through a bf16 gradient: d/dg of g * D(x) is D(x)
    g = _x(513, seed=4, scale=1.0).to(torch.bfloat16).requires_grad_()
    dx = fm.sine_grad_op(x.detach(), g, cosine)
    (dg,) = torch.autograd.grad(dx.sum(), g)
    assert dg.dtype == torch.bfloat16
    assert torch.equal(dg, cycle[0].to(torch.bfloat16))
