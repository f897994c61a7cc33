"""Checksums of the unfolded instances of ``csrc/fast_sine.cu`` (the
branch layers', the ghost step's and the renderer's launches) at the
branch layers' shapes of a flagship step and render chunk, on inputs made
on the card without a random generator, so that two builds of the kernel
can be compared bit for bit: ``tests/test_torch_batchnorm_cuda.py`` holds
them to :data:`RECORDED`, read from the kernels before the folded variants
were added to the source (NVIDIA H100 80GB HBM3, degree 11).  Imports
nothing of the port but what it is handed, so that it runs against an
older tree too."""

import torch

# (rows, width) of the branch layers: the class branch and the adjust at
# 512 (4,096 rays; 393,216 points), the sky at 128, the solar branch at
# 256; and a ragged width (the scalar tail)
SHAPES = {"class": (4096, 512), "sky": (4096, 128), "solar": (393216, 256),
          "adjust": (393216, 512), "ragged": (1001, 517)}
_P = 2147483629         # a prime below 2^31


def _ramp(n, salt, device):
    i = torch.arange(n, device=device, dtype=torch.int64)
    return ((i * 2654435761 + salt) % 1048576).float() / 524288.0 - 1.0


def _checksum(t):
    """A sum of the bit patterns, each weighted by its position, mod a
    prime: any changed bit changes it but by chance."""
    bits = (t.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
            if t.dtype == torch.bfloat16
            else t.contiguous().view(torch.int32).to(torch.int64)
            & 0xFFFFFFFF)
    w = torch.arange(1, bits.numel() + 1, device=bits.device,
                     dtype=torch.int64) % _P
    return int(((bits.reshape(-1) % _P) * w % _P).sum())


def checksums(fast_math, device="cuda"):
    """-> {shape name: [checksum of each instance]}: the forward (sine,
    cosine) x (float32, bf16 store) and the backward (sine, cosine) x
    (float32, bf16 g), x in +-50 and g in +-1."""
    out = {}
    for name, (r, c) in SHAPES.items():
        x = (_ramp(r * c, 1, device) * 50.0).view(r, c)
        g = _ramp(r * c, 7, device).view(r, c)
        sums = []
        for cos in (False, True):
            for bf16 in (False, True):
                sums.append(_checksum(fast_math.sine_op(x, cos, bf16)))
            for gt in (g, g.to(torch.bfloat16)):
                sums.append(_checksum(fast_math.sine_grad_op(x, gt, cos)))
        out[name] = sums
    return out


RECORDED = {
    "class": [
        2253007215177836, 2235623889920277,
        2252519899657127, 2251299857887716,
        2252220487647098, 2236377463098427,
        2252133365153708, 2250576269754553,
    ],
    "sky": [
        562164443434239, 557311025682668,
        563455605699863, 563189375285120,
        562703979541534, 557343923676362,
        562073068528654, 562374561025866,
    ],
    "solar": [
        108093697075690354, 108071968764135752,
        108096454571830334, 108076680113493774,
        108097458628070489, 108073013646914769,
        108085050980005778, 108092422918809852,
    ],
    "adjust": [
        216169589864334800, 216162852811322199,
        216188165548655160, 216155840651207533,
        216181245168592525, 216159731788673462,
        216169776825669546, 216170982538404655,
    ],
    "ragged": [
        554946767584632, 544440904135469,
        556094044784836, 555903314543838,
        555400508618588, 544484872598291,
        554803400476255, 555092831498716,
    ],
}
