"""The polynomial sine's kernel alone (``csrc/fast_sine.cu``): one launch a
direction of each ``SineLayer`` with ``fast_sine``.  The elements of each
launch of a training step and of a render chunk, from the configuration's
shapes, and each launch's bound by the rule of the kernel table: each
input read once and each output written once, over the card's memory
rate (a handful of operations an element: bytes bound it).

A forward reads x in float32 and writes y in the compute dtype; a
backward reads x in float32 and the gradient g in the compute dtype, and
writes dx in float32.

The layers, widths W, W / 2 = H and W / 4 = Q: the trunk fc1..fcN at W
and fc9 at H, one row a sample; the class branch (two at W) and the sky
(one at Q), one row a ray; the solar branch (three at H) and the adjust
(three at W), one row a sample.  A step's camera pass runs every layer
forward (the trunk's twice under ``pallas_trunk``, which K1 does, with
no launch of this kernel) and every one backward but the solar branch,
whose visibility the composite reads detached; its solar pass runs the
sky, the trunk (no gradient) and the solar branch forward, and the solar
branch backward.  A render chunk runs every branch forward once (K3
runs the trunk)."""

from portbench.counts.peaks import BYTES_PER_S

FWD, BWD = "fwd", "bwd"


def nbytes(c: dict, n: int, direction: str) -> int:
    act = 2 if c["compute_dtype"] == "bfloat16" else 4
    return n * (4 + act) if direction == FWD else n * (4 + act + 4)


def launch_bound_s(c: dict, n: int, direction: str) -> float:
    return nbytes(c, n, direction) / BYTES_PER_S


def _layers(c: dict, rays: int, points: int) -> dict:
    """Elements of each layer's launch, by branch."""
    W = c["fc_units"]
    H, Q = W // 2, W // 4
    return {"trunk": [points * W] * c["fc_layers"] + [points * H],
            "class": [rays * W] * 2, "sky": [rays * Q],
            "solar": [points * H] * 3, "adjust": [points * W] * 3}


def step_launches(c: dict):
    """-> [(elements, direction)] of one training step's launches."""
    if not c["fast_sine"]:
        return []
    rays = c["batch_size"]
    L = _layers(c, rays, rays * c["n_samples"])
    trunk = [] if c.get("pallas_trunk") else L["trunk"]
    fwd = (L["class"] + L["sky"] + trunk + L["solar"] + L["adjust"]
           + L["sky"] + trunk + L["solar"])
    bwd = trunk + L["adjust"] + L["class"] + L["sky"] + L["solar"]
    return [(n, FWD) for n in fwd] + [(n, BWD) for n in bwd]


def chunk_launches(c: dict, rays: int):
    """-> [(elements, direction)] of one render chunk of ``rays`` rays."""
    if not c["fast_sine"]:
        return []
    L = _layers(c, rays, rays * c["n_samples"])
    return [(n, FWD) for n in L["class"] + L["sky"] + L["solar"]
            + L["adjust"]]


def frame_launches(c: dict, rays: int):
    """-> the launches of a frame of ``rays`` rays: one render chunk of
    ``chunk`` rays after another, the last one partly filled."""
    chunk = c["chunk"]
    return [launch for a in range(0, rays, chunk)
            for launch in chunk_launches(c, min(chunk, rays - a))]
