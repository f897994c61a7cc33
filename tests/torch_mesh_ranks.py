"""What the ranks of ``tests/test_torch_mesh.py`` and
``tests/test_torch_batchnorm_train.py`` run.

``parallel.mesh.launch`` spawns its ranks, and each imports the module
that defines its function by name; this one imports nothing of JAX (the
test files do), so a rank starts in a second or two.
"""

import torch

from season_nerf_torch.models.siren import SineLayer
from season_nerf_torch.ops.batchnorm_train import batchnorm_sine
from season_nerf_torch.parallel.mesh import all_reduce_grads, global_amin


def bn_and_min(mesh, state, x, g, albedo, w):
    """A BatchNorm SIREN layer (``state``) in training mode on this rank's
    rows of ``x``, its loss ``sum(y * g)`` over them, and the replicated
    ``sum(w * global_amin(albedo))``, with their gradients; ``mesh`` None
    takes every row in one process -> (y and albedo's gradient of these
    rows, the layer's gradients summed over the ranks, its running
    statistics, the minimum)."""
    rows = slice(None)
    if mesh is not None:
        per = x.shape[0] // mesh.size
        rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    layer = SineLayer(x.shape[1], g.shape[1], use_norm=True)
    layer.load_state_dict(state)
    layer.train()
    layer.mesh = mesh
    y = layer(x[rows])
    a = albedo[rows].clone().requires_grad_()
    m = global_amin(a, mesh)
    (torch.sum(y * g[rows]) + torch.sum(w * m)).backward()
    if mesh is not None:
        all_reduce_grads(list(layer.parameters()), mesh)
    return {"y": y.detach(), "albedo_grad": a.grad,
            "grads": {k: p.grad for k, p in layer.named_parameters()},
            "running": {k: v for k, v in layer.state_dict().items()
                        if "running" in k},
            "min": m.detach()}


def bn_sine(mesh, state, z, g, plain=True):
    """A training layer's BatchNorm and sine (``ops/batchnorm_train``: the
    plain version, or with ``plain`` False the card's kernels) on this
    rank's rows of the bf16 ``z``, on the rank's device (``z``'s with no
    mesh), with ``g`` as its output's gradient; ``mesh`` None takes every
    row in one process -> (y and dz of these rows, the scale's and shift's
    gradients summed over the ranks, the running statistics), on the
    CPU."""
    rows = slice(None)
    device = z.device
    if mesh is not None:
        per = z.shape[0] // mesh.size
        rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
        device = mesh.device
    norm = torch.nn.BatchNorm1d(z.shape[1])
    norm.load_state_dict(state)
    norm.to(device)
    zr = z[rows].to(device).clone().requires_grad_()
    y = batchnorm_sine(zr, norm, mesh, plain=plain)
    y.backward(g[rows].to(device))
    if mesh is not None:
        all_reduce_grads(list(norm.parameters()), mesh)
    out = {"y": y.detach(), "dz": zr.grad, "dscale": norm.weight.grad,
           "dshift": norm.bias.grad, "running_mean": norm.running_mean,
           "running_var": norm.running_var}
    return {k: v.cpu() for k, v in out.items()}
