"""Batched rotation augmentation (reference utils/util.py:37-58).

Counterpart of dpmn_tpu/ops/rotate.py: per-sample affine matrices with an
aspect-jittered rotation, warped by affine_grid + grid_sample
(align_corners=False).
"""

from __future__ import annotations

import math

import torch

from .grid_sample import affine_grid, grid_sample


def rotate_images(images: torch.Tensor, arc: torch.Tensor, rand_offs: torch.Tensor,
                  off_range: float = 0.2) -> torch.Tensor:
    """images NCHW; arc (B,) radians; rand_offs (B,) uniform in [0, 1)."""
    n, _, h, w = images.shape
    ratios_mul = h / float(w) + rand_offs * off_range * 2.0 - off_range
    cos, sin, zeros = torch.cos(arc), torch.sin(arc), torch.zeros_like(arc)
    theta = torch.stack([cos, sin * ratios_mul, zeros, -sin / ratios_mul, cos, zeros], dim=1).reshape(n, 2, 3)
    return grid_sample(images, affine_grid(theta, (n, h, w)))


def random_rotate(images_lr: torch.Tensor, images_hr: torch.Tensor, generator: torch.Generator,
                  rotate_degrees: float):
    """The rotate_train path (super_resolution.py:144-151): one angle and
    one aspect offset drawn per sample from `generator` (a CPU generator)
    and applied to both LR and HR."""
    b = images_lr.shape[0]
    angle = torch.rand(b, generator=generator) * rotate_degrees * 2.0 - rotate_degrees
    rand_offs = torch.rand(b, generator=generator)
    arc = (angle / 180.0 * math.pi).to(images_lr.device)
    rand_offs = rand_offs.to(images_lr.device)
    return rotate_images(images_lr, arc, rand_offs), rotate_images(images_hr, arc, rand_offs)
