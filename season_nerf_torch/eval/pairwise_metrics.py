"""All-pairs image similarity metrics over a stack, in torch.

The counterpart of ``season_nerf_tpu/eval/pairwise_metrics.py``: each
function maps an image stack ``[N_sets, M, H, W, C]`` to the score of
every pair within a set, ``[N_sets, M, M]`` (channel-averaged): MSE, RMSE,
PSNR, global SSIM, UQI, SAM, SRE, RASE, ERGAS, MS-SSIM and FSIM.  They
run on the stack's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from season_nerf_torch.eval.phase_congruency import phase_congruency


def _pairwise_diff(imgs):
    return imgs[:, :, None] - imgs[:, None, :]


def mse(imgs):
    """[N, M, H, W, C] -> [N, M, M]: mean squared error per pair."""
    return torch.mean(_pairwise_diff(imgs) ** 2, dim=(3, 4, 5))


def rmse(imgs):
    return torch.sqrt(mse(imgs))


def psnr(imgs, max_val=1.0, eps=1e-10):
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse(imgs), min=eps))


def _moments(x, ddof):
    """Per-image channel means, variances and the pairs' covariances."""
    n_pix = x.shape[2] * x.shape[3]
    mu = x.mean(dim=(2, 3))                                # [N, M, C]
    cen = x - mu[:, :, None, None, :]
    # NaN where a scale has one pixel and ddof 1, as jnp.var gives
    var = torch.sum(cen ** 2, dim=(2, 3)) / (n_pix - ddof)
    cov = torch.einsum("nmhwc,nkhwc->nmkc", cen, cen) / (n_pix - ddof)
    return mu, var, cov


def ssim_global(imgs, max_val=1.0, k1=0.01, k2=0.03, unbiased=True):
    """Global-window SSIM per channel, channel-averaged -> [N, M, M]."""
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu, var, cov = _moments(imgs, 1 if unbiased else 0)
    mu_i, mu_j = mu[:, :, None], mu[:, None, :]
    var_i, var_j = var[:, :, None], var[:, None, :]
    s = ((2 * mu_i * mu_j + c1) * (2 * cov + c2)
         / ((mu_i ** 2 + mu_j ** 2 + c1) * (var_i + var_j + c2)))
    return s.mean(-1)


def uqi(imgs):
    """The universal quality index: global SSIM with the same constants."""
    return ssim_global(imgs)


def sam(imgs, eps=1e-12):
    """Spectral angle mapper: the mean per-pixel arccos of the cosine
    between the two channel vectors."""
    flat = imgs.reshape(imgs.shape[0], imgs.shape[1], -1, imgs.shape[-1])
    num = torch.einsum("nmpc,nkpc->nmkp", flat, flat)
    nrm = torch.sqrt(torch.sum(flat ** 2, -1) + eps)
    den = nrm[:, :, None] * nrm[:, None, :]
    return torch.arccos(torch.clamp(num / den, 0.0, 1.0)).mean(-1)


def sre(imgs, eps=1e-10):
    """Signal-to-reconstruction error in dB."""
    n_pix = imgs.shape[2] * imgs.shape[3]
    mu2 = imgs.mean(dim=(2, 3)) ** 2                          # [N, M, C]
    d = _pairwise_diff(imgs)
    fro = torch.sqrt(torch.sum(d ** 2, dim=(3, 4))) / n_pix   # [N, M, M, C]
    fro = torch.clamp(fro, min=eps)
    return 10.0 * torch.log10(mu2[:, :, None] / fro).mean(-1)


def rase(imgs, eps=1e-10):
    """Relative average spectral error."""
    r = torch.sqrt(torch.mean(_pairwise_diff(imgs) ** 2, dim=(3, 4, 5)))
    m = imgs.mean(dim=(2, 3, 4))
    return r / (m[:, :, None] + eps)


def ergas(imgs, r=1.0, eps=1e-10):
    """ERGAS: the root mean over channels of MSE / mean^2, times ``r``."""
    mse_c = torch.mean(_pairwise_diff(imgs) ** 2, dim=(3, 4))  # [N,M,M,C]
    m = imgs.mean(dim=(2, 3))                                  # [N,M,C]
    return torch.sqrt(torch.mean(mse_c / (m[:, :, None] ** 2 + eps), -1)) * r


def ms_ssim(imgs, max_val=1.0, k1=0.01, k2=0.03,
            weights=(0.0448, 0.2856, 0.3001, 0.2363, 0.1333)):
    """Multi-scale SSIM from global-window components at each scale, 2 x 2
    box downsampling between scales."""
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    c3 = c2 / 2

    def components(x):
        mu, var, cov = _moments(x, 1)
        mu_i, mu_j = mu[:, :, None], mu[:, None, :]
        var_i, var_j = var[:, :, None], var[:, None, :]
        sd = torch.sqrt(torch.clamp(var_i * var_j, min=0.0))
        lum = (2 * mu_i * mu_j + c1) / (mu_i ** 2 + mu_j ** 2 + c1)
        con = (2 * sd + c2) / (var_i + var_j + c2)
        struc = (cov + c3) / (sd + c3)
        return lum, con, struc

    x = imgs
    val = torch.ones((imgs.shape[0], imgs.shape[1], imgs.shape[1],
                      imgs.shape[-1]), dtype=imgs.dtype, device=imgs.device)
    lum = None
    for i, w in enumerate(weights):
        lum, con, struc = components(x)
        cs = con * struc
        val = val * torch.sign(cs) * torch.abs(cs) ** w
        if i != len(weights) - 1:
            H2, W2 = (x.shape[2] // 2) * 2, (x.shape[3] // 2) * 2
            x = x[:, :, :H2, :W2]
            x = (x[:, :, 0::2, 0::2] + x[:, :, 1::2, 0::2]
                 + x[:, :, 0::2, 1::2] + x[:, :, 1::2, 1::2]) / 4
    val = val * torch.sign(lum) * torch.abs(lum) ** weights[-1]
    return val.mean(-1)


def fsim(imgs, nscale=4, min_wavelength=6, mult=2.0, sigma_onf=0.5978):
    """Feature similarity: the phase-congruency and Scharr-gradient
    similarity maps of each channel, weighted by the pair's larger phase
    congruency, averaged over the channels."""
    N, M, H, W, C = imgs.shape
    x = imgs.movedim(-1, 2).reshape(N * M * C, H, W).float()
    pc = phase_congruency(x, nscale=nscale, min_wavelength=min_wavelength,
                          mult=mult, sigma_onf=sigma_onf)
    pc = pc.reshape(N, M, C, H, W)

    gx = torch.tensor([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]],
                      dtype=torch.float32, device=x.device)
    # a cross-correlation with zero padding, as lax.conv_general_dilated
    grad = torch.sqrt(F.conv2d(x[:, None], gx[None, None], padding=1) ** 2
                      + F.conv2d(x[:, None], gx.T[None, None], padding=1)
                      ** 2)
    grad = grad.reshape(N, M, C, H, W)

    def sim(a, b, c):
        return (2 * a * b + c) / (a ** 2 + b ** 2 + c)

    pc_i, pc_j = pc[:, :, None], pc[:, None, :]
    g_i, g_j = grad[:, :, None], grad[:, None, :]
    s_l = sim(pc_i, pc_j, 0.85) * sim(g_i, g_j, 160.0)
    pc_max = torch.maximum(pc_i, pc_j)
    num = torch.sum(s_l * pc_max, dim=(-2, -1))
    den = torch.sum(pc_max, dim=(-2, -1)) + 1e-10
    return (num / den).mean(-1)


METRICS = {
    "mse": mse, "rmse": rmse, "psnr": psnr, "ssim": ssim_global,
    "uqi": uqi, "sam": sam, "sre": sre, "rase": rase, "ergas": ergas,
    "ms_ssim": ms_ssim, "fsim": fsim,
}
