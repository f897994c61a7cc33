"""2-D phase congruency (Kovesi's log-Gabor formulation), batched in torch.

The counterpart of ``season_nerf_tpu/eval/phase_congruency.py``, the
feature map of FSIM (``pairwise_metrics.fsim``): a log-Gabor filter bank
over the FFT, per-orientation energy with phase-deviation weighting, a
noise threshold from the smallest scale's amplitude, and a sigmoid weight
on the frequency spread.

The filter bank is built in numpy per image shape (cached), as in the JAX
package; the FFTs and the elementwise work run on the input's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _filter_bank(rows: int, cols: int, nscale: int, norient: int,
                 min_wavelength: float, mult: float, sigma_onf: float):
    """[norient, nscale, rows, cols] complex64 log-Gabor transfer
    functions, each times its orientation's angular spread and a lowpass."""
    y, x = np.meshgrid(
        (np.arange(rows) - rows // 2) / rows,
        (np.arange(cols) - cols // 2) / cols, indexing="ij")
    radius = np.sqrt(x ** 2 + y ** 2)
    radius = np.fft.ifftshift(radius)
    radius[0, 0] = 1.0
    theta = np.arctan2(-y, x)
    theta = np.fft.ifftshift(theta)
    sin_t, cos_t = np.sin(theta), np.cos(theta)

    # lowpass against the FFT's cross artefacts
    lp = np.fft.ifftshift(
        1.0 / (1.0 + (np.sqrt(x ** 2 + y ** 2) / 0.45) ** (2 * 15)))

    log_gabors = []
    for s in range(nscale):
        wavelength = min_wavelength * mult ** s
        fo = 1.0 / wavelength
        lg = np.exp(-(np.log(radius / fo) ** 2)
                    / (2 * np.log(sigma_onf) ** 2))
        lg *= lp
        lg[0, 0] = 0.0
        log_gabors.append(lg)

    spreads = []
    for o in range(norient):
        angl = o * np.pi / norient
        ds = sin_t * np.cos(angl) - cos_t * np.sin(angl)
        dc = cos_t * np.cos(angl) + sin_t * np.sin(angl)
        dtheta = np.abs(np.arctan2(ds, dc))
        dtheta = np.minimum(dtheta * norient / 2, np.pi)
        spreads.append((np.cos(dtheta) + 1) / 2)

    return np.stack([[lg * sp for lg in log_gabors]
                     for sp in spreads]).astype(np.complex64)


def phase_congruency(imgs: torch.Tensor, nscale=4, norient=4,
                     min_wavelength=6, mult=2.0, sigma_onf=0.5978, k=2.0):
    """[..., H, W] grayscale -> phase congruency summed over the
    orientations, the same shape, float32 on the input's device."""
    H, W = imgs.shape[-2], imgs.shape[-1]
    lead = imgs.shape[:-2]
    x = imgs.reshape((-1, H, W)).float()
    F = torch.fft.fft2(x)
    bank = torch.from_numpy(_filter_bank(
        H, W, nscale, int(norient), float(min_wavelength), float(mult),
        float(sigma_onf))).to(x.device)

    eps = 1e-4
    pc_sum = torch.zeros_like(x)
    for o in range(int(norient)):
        resp = torch.fft.ifft2(F[:, None] * bank[o][None])   # [B, S, H, W]
        e = resp.real
        od = resp.imag
        an = torch.sqrt(e ** 2 + od ** 2)
        sum_e = e.sum(1)
        sum_o = od.sum(1)
        sum_an = an.sum(1)
        x_energy = torch.sqrt(sum_e ** 2 + sum_o ** 2) + eps
        mean_e = sum_e / x_energy
        mean_o = sum_o / x_energy
        # energy with phase-deviation weighting
        energy = torch.sum(e * mean_e[:, None] + od * mean_o[:, None]
                           - torch.abs(e * mean_o[:, None]
                                       - od * mean_e[:, None]), 1)
        # noise threshold from the smallest scale's amplitude (Rayleigh)
        a1 = an[:, 0]
        mean_a1 = a1.mean(dim=(-2, -1), keepdim=True)
        # the noise energy over all scales (a geometric series)
        tot = mean_a1 * (1 - (1 / mult) ** nscale) / (1 - 1 / mult)
        noise_sigma = tot * np.sqrt(np.pi / 2) / np.sqrt(2.0)
        T = noise_sigma * (1 + k * np.sqrt((4 - np.pi) / np.pi))
        energy = torch.clamp(energy - T, min=0.0)
        # frequency-spread weighting
        max_an = an.amax(1)
        width = (sum_an / (max_an + eps) - 1) / (nscale - 1)
        weight = 1.0 / (1.0 + torch.exp(10.0 * (0.4 - width)))
        pc_sum = pc_sum + weight * energy / (sum_an + eps)
    return pc_sum.reshape(lead + (H, W))
