"""Image reconstruction losses, NCHW (counterpart of dpmn_tpu/losses.py:16-48,
reference loss/image_loss.py:5-44).

ImageLoss = w0 * MSE + w1 * GradientPriorLoss, the gradient prior being the
L1 distance between central-difference gradient-magnitude maps of the first
3 channels.  The reference trainer uses loss_weight = (1, 1) and the
cascade multiplies by 100.  The bf16 AMP step passes float32 images, as the
JAX package casts the SR to float32 before its losses (dpmn_tpu/system.py:395).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gradient_map(x: torch.Tensor) -> torch.Tensor:
    """Central-difference gradient magnitude of (B, C, H, W).  The shifted
    copies come from zero padding + slicing, so the border sees one-sided
    differences against an implicit zero row / column."""
    h, w = x.shape[2], x.shape[3]
    r = F.pad(x, (0, 1, 0, 0))[:, :, :, 1:]
    l = F.pad(x, (1, 0, 0, 0))[:, :, :, :w]
    t = F.pad(x, (0, 0, 1, 0))[:, :, :h, :]
    b = F.pad(x, (0, 0, 0, 1))[:, :, 1:, :]
    return torch.sqrt(((r - l) * 0.5) ** 2 + ((t - b) * 0.5) ** 2 + 1e-6)


def gradient_prior_loss(out_images: torch.Tensor, target_images: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(gradient_map(out_images) - gradient_map(target_images)))


def image_loss(out_images: torch.Tensor, target_images: torch.Tensor, gradient: bool = False,
               loss_weight=(1.0, 1.0)) -> torch.Tensor:
    """w0 * MSE (+ w1 * the gradient prior over the first 3 channels)."""
    loss = loss_weight[0] * torch.mean((out_images - target_images) ** 2)
    if gradient:
        loss = loss + loss_weight[1] * gradient_prior_loss(out_images[:, :3], target_images[:, :3])
    return loss
