"""PSNR and SSIM of SR images, NHWC in [0, 1], over the first 3 channels.

Counterpart of dpmn_tpu/utils/metrics.py:21-74 (reference
utils/ssim_psnr.py:9-79): PSNR = 20 log10(255 / sqrt(mse)) of the images
scaled by 255; SSIM with an 11x11 Gaussian window (sigma 1.5) as a depthwise
convolution padded by 5, C1 = 0.01^2, C2 = 0.03^2, averaged over everything
(or per image).  Inputs are numpy arrays or tensors; the sums run in float32
on the inputs' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    g = np.array([math.exp(-((x - window_size // 2) ** 2) / float(2 * sigma**2)) for x in range(window_size)],
                 dtype=np.float32)
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _rgb_nchw(img) -> torch.Tensor:
    x = img if torch.is_tensor(img) else torch.from_numpy(np.asarray(img))
    return x[..., :3].float().permute(0, 3, 1, 2)


def psnr(img1, img2) -> torch.Tensor:
    """PSNR over the first 3 channels of two NHWC batches in [0, 1]."""
    a, b = _rgb_nchw(img1) * 255.0, _rgb_nchw(img2) * 255.0
    mse = torch.mean((a - b) ** 2)
    return 20.0 * torch.log10(255.0 / torch.sqrt(mse))


def ssim(img1, img2, window_size: int = 11, size_average: bool = True) -> torch.Tensor:
    """SSIM over the first 3 channels of two NHWC batches in [0, 1]: one
    value, or one per image when not `size_average`."""
    x1, x2 = _rgb_nchw(img1), _rgb_nchw(img2)
    c = x1.shape[1]
    window = torch.from_numpy(_gaussian_window(window_size, 1.5)).to(x1.device)
    kernel = window.expand(c, 1, window_size, window_size)
    pad = window_size // 2

    def conv(t):
        return F.conv2d(t, kernel, padding=pad, groups=c)

    mu1, mu2 = conv(x1), conv(x2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(x1 * x1) - mu1_sq
    sigma2_sq = conv(x2 * x2) - mu2_sq
    sigma12 = conv(x1 * x2) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean() if size_average else ssim_map.mean(dim=(1, 2, 3))
