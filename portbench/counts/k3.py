"""K3, the inference trunk (``ops/fused_trunk.py``): operations and bytes
of one launch over ``points`` samples, and its bound.

Operations: 2 x the trunk's multiply-adds a point, without padding.
Bytes: each input read once and each output written once: the point's
encoding (64 float32 columns), x_enc (W / 2 float32 columns) and the
folded weights in the compute dtype with float32 biases."""

from portbench.counts import layers as L
from portbench.counts.peaks import bound_s

PE_COLS = 64


def flops(c: dict, points: int) -> float:
    return 2.0 * points * L.forward(L.trunk(c))


def nbytes(c: dict, points: int) -> float:
    size = 2 if c["compute_dtype"] == "bfloat16" else 4
    weights = sum((g + f) * o * size + o * 4 for g, f, o in L.trunk(c))
    return points * (PE_COLS + c["fc_units"] // 2) * 4 + weights


def launch_bound_s(c: dict, points: int) -> float:
    return bound_s(flops(c, points), nbytes(c, points), c["compute_dtype"])


def frame_launches(c: dict, rays: int):
    """The points of each launch of a frame of ``rays`` rays: one launch
    a render chunk, the last one partly filled."""
    chunk, s = c["chunk"], c["n_samples"]
    return [min(chunk, rays - a) * s for a in range(0, rays, chunk)]
