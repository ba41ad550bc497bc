"""Bilinear grid sampling and affine grids with zeros padding, NCHW.

Counterpart of dpmn_tpu/ops/grid_sample.py (reference: the TPS warp
model/tps_spatial_transformer.py, MORAN's MORN, the rotation augmentation of
utils/util.py:37-58).  The JAX package gathers four clamped corners and
blends them in plain XLA, outside any Pallas kernel; here `F.grid_sample`
computes the same function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(x: torch.Tensor, grid: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """Sample NCHW `x` at the normalized `grid` (B, Ho, Wo, 2) in [-1, 1]
    (grid[..., 0] is x, grid[..., 1] is y), zero outside the image.  The
    blend runs in the grid's precision and the result comes back in x's
    dtype, as the JAX function does (sub-pixel weights stay exact when x is
    bf16)."""
    out = F.grid_sample(x.to(grid.dtype), grid, mode="bilinear", padding_mode="zeros", align_corners=align_corners)
    return out.to(x.dtype)


def affine_grid(theta: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """theta (B, 2, 3), size (B, H, W) → grid (B, H, W, 2), as torch's
    F.affine_grid."""
    b, h, w = size
    return F.affine_grid(theta, (b, 1, h, w), align_corners=align_corners)
