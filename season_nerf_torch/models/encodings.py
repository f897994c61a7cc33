"""Positional (sin/cos) encodings, the reference's ``PE_Encode`` layout.

Per input dimension the block is
``cos(k_0 x), ..., cos(k_{n-1} x), sin(k_0 x), ..., sin(k_{n-1} x)`` with
``k_j = 2^j * pi/2``; the extended form prepends the raw input.
"""

from __future__ import annotations

import math

import torch


def positional_encode(x: torch.Tensor, n_freqs: int, extended=True,
                      scale=math.pi / 2) -> torch.Tensor:
    """[N, D] -> [N, D * 2 * n_freqs (+ D if extended)], float32 math."""
    if n_freqs == 0:
        return x
    k = (2.0 ** torch.arange(n_freqs, dtype=torch.float32,
                             device=x.device)) * scale
    ang = x[..., :, None] * k                                   # [N, D, n]
    enc = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)   # [N, D, 2n]
    enc = enc.reshape(*x.shape[:-1], x.shape[-1] * 2 * n_freqs)
    if extended:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def encoded_size(in_dim, n_freqs, extended=True):
    if n_freqs == 0:
        return in_dim
    return in_dim * (2 * n_freqs + (1 if extended else 0))
