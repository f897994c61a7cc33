"""Image quality metrics: masked PSNR, SSIM with a Gaussian window, and the
global-window SSIM of one image and of every pair in a stack.

The counterpart of ``season_nerf_tpu/ops/metrics.py``, as plain torch
functions on any device.  The trainer's validation reads :func:`psnr`; the
evaluation suite reads the rest.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(img, ref, mask=None, max_val=1.0):
    """Masked PSNR.  img/ref: [..., C]; mask: broadcastable boolean."""
    err = (img - ref) ** 2
    if mask is not None:
        m = mask.to(img.dtype)
        while m.dim() < err.dim():
            m = m[..., None]
        mse = torch.sum(err * m) / torch.clamp(
            torch.sum(m * torch.ones_like(err)), min=1.0)
    else:
        mse = torch.mean(err)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def ssim_global(img, ref, max_val=1.0, k1=0.01, k2=0.03):
    """SSIM with one window over the whole image: one mean, variance and
    covariance over all axes.  One image ([H, W] or [H, W, C]) at a time;
    for a stack see :func:`pairwise_ssim_global`."""
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_x, mu_y = img.mean(), ref.mean()
    var_x = torch.var(img, unbiased=False)
    var_y = torch.var(ref, unbiased=False)
    cov = torch.mean((img - mu_x) * (ref - mu_y))
    return ((2 * mu_x * mu_y + c1) * (2 * cov + c2)
            / ((mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2)))


def _gaussian_kernel(size=13, sigma=1.5, device=None):
    """[size, size] normalized Gaussian window; sigma stays 1.5 whatever
    the size, as the reference builds its window."""
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.as_tensor(np.outer(g, g), dtype=torch.float32,
                           device=device)


def _filter2d(img, kernel):
    """Depthwise 2-D convolution over edge-replicated padding: a full
    [H, W] output whose border windows see the replicated edge pixels.
    img: [H, W] or [H, W, C]."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    pad = kernel.shape[0] // 2
    x = img.permute(2, 0, 1)[:, None]                    # [C, 1, H, W]
    x = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    y = F.conv2d(x, kernel[None, None])                  # cross-correlation
    y = y[:, 0].permute(1, 2, 0)
    return y[..., 0] if squeeze else y


def ssim(img, ref, mask=None, max_val=1.0, win_size=13, sigma=1.5,
         k1=0.01, k2=0.03):
    """Masked Gaussian-window SSIM: the full-size SSIM map over
    edge-replicated windows, averaged over the windows that touch no
    invalid pixel.  img/ref: [H, W] or [H, W, C] in [0, max_val], invalid
    pixels zero-filled by the caller.  -> the mean SSIM (scalar)."""
    img, ref = img.float(), ref.float()
    kern = _gaussian_kernel(win_size, sigma, img.device)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_x = _filter2d(img, kern)
    mu_y = _filter2d(ref, kern)
    mu_xx = _filter2d(img * img, kern)
    mu_yy = _filter2d(ref * ref, kern)
    mu_xy = _filter2d(img * ref, kern)
    var_x = mu_xx - mu_x ** 2
    var_y = mu_yy - mu_y ** 2
    cov = mu_xy - mu_x * mu_y
    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)
                / ((mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2)))
    if mask is None:
        return ssim_map.mean()
    # a window with any invalid pixel gives conv(1 - mask) > 0, an
    # all-valid one an exact 0 (a sum of zeros)
    invalid = 1.0 - mask.float()
    m = (_filter2d(invalid, kern) == 0.0).float()
    while m.dim() < ssim_map.dim():
        m = m[..., None]
    return torch.sum(ssim_map * m) / torch.clamp(
        torch.sum(m * torch.ones_like(ssim_map)), min=1.0)


def pairwise_ssim_global(patches, max_val=1.0, k1=0.01, k2=0.03):
    """Global-window SSIM of every pair in a stack [N, H, W(, C)] -> the
    [N, N] matrix."""
    n = patches.shape[0]
    flat = patches.reshape(n, -1).float()
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu = flat.mean(dim=1)
    var = torch.var(flat, dim=1, unbiased=False)
    centered = flat - mu[:, None]
    cov = (centered @ centered.t()) / flat.shape[1]
    mu_i, mu_j = mu[:, None], mu[None, :]
    var_i, var_j = var[:, None], var[None, :]
    return ((2 * mu_i * mu_j + c1) * (2 * cov + c2)
            / ((mu_i ** 2 + mu_j ** 2 + c1) * (var_i + var_j + c2)))
