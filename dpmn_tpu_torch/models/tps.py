"""Thin-plate-spline spatial transformer.

Counterpart of dpmn_tpu/models/tps.py (reference
model/tps_spatial_transformer.py:22-112).  The TPS kernel's inverse and the
target coordinates' representation depend only on the geometry: they are
computed once on the host in float64 (the (N+3)x(N+3) inverse is
numerically touchy), cached, and held as non-persistent float32 buffers, so
a checkpoint neither carries nor expects them.  A warp is two small matmuls
and one grid_sample.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn

from ..ops.grid_sample import grid_sample


def _partial_repr(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """phi(x1, x2) = 0.5 r^2 log(r^2), 0 at r = 0 (reference :22-34)."""
    dist = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        rep = 0.5 * dist * np.log(dist)
    rep[~np.isfinite(rep)] = 0.0
    return rep


def build_output_control_points(num_control_points: int, margins) -> np.ndarray:
    margin_x, margin_y = margins
    n_side = num_control_points // 2
    xs = np.linspace(margin_x, 1.0 - margin_x, n_side)
    top = np.stack([xs, np.full(n_side, margin_y)], axis=1)
    bottom = np.stack([xs, np.full(n_side, 1.0 - margin_y)], axis=1)
    return np.concatenate([top, bottom], axis=0)


@functools.lru_cache(maxsize=16)
def _tps_constants(target_height: int, target_width: int, num_control_points: int, margins):
    """(inverse kernel (N+3, N+3), target coordinate repr (H*W, N+3), target
    control points (N, 2)), float32 from float64 host arithmetic."""
    ctrl = build_output_control_points(num_control_points, margins)
    n = num_control_points
    fk = np.zeros((n + 3, n + 3))
    fk[:n, :n] = _partial_repr(ctrl, ctrl)
    fk[:n, -3] = 1.0
    fk[-3, :n] = 1.0
    fk[:n, -2:] = ctrl
    fk[-2:, :n] = ctrl.T
    inverse_kernel = np.linalg.inv(fk)
    yy, xx = np.meshgrid(np.arange(target_height), np.arange(target_width), indexing="ij")
    coord = np.stack([xx.reshape(-1) / (target_width - 1), yy.reshape(-1) / (target_height - 1)], axis=1)
    repr_mat = np.concatenate([_partial_repr(coord, ctrl), np.ones((len(coord), 1)), coord], axis=1)
    return inverse_kernel.astype(np.float32), repr_mat.astype(np.float32), ctrl.astype(np.float32)


class TPSSpatialTransformer(nn.Module):
    """The TPS warp; no learnable parameters."""

    def __init__(self, output_image_size, num_control_points: int = 20, margins=(0.05, 0.05)):
        super().__init__()
        self.target_height, self.target_width = output_image_size
        self.num_control_points = num_control_points
        inv_k, repr_mat, ctrl = _tps_constants(self.target_height, self.target_width, num_control_points,
                                               tuple(margins))
        self.register_buffer("inverse_kernel", torch.from_numpy(inv_k), persistent=False)
        self.register_buffer("target_coordinate_repr", torch.from_numpy(repr_mat), persistent=False)
        self.register_buffer("target_control_points", torch.from_numpy(ctrl), persistent=False)

    def forward(self, x: torch.Tensor, source_control_points: torch.Tensor):
        """x NCHW; source_control_points (B, N, 2) in [0, 1] image coordinates
        → (warped (B, C, H_t, W_t), source coordinates (B, H_t * W_t, 2))."""
        b = source_control_points.shape[0]
        pad = source_control_points.new_zeros(b, 3, 2)
        y = torch.cat([source_control_points, pad], dim=1)  # (B, N + 3, 2)
        mapping = torch.matmul(self.inverse_kernel, y)
        source_coordinate = torch.matmul(self.target_coordinate_repr, mapping)  # (B, H*W, 2)
        grid = source_coordinate.reshape(b, self.target_height, self.target_width, 2)
        grid = torch.clamp(grid, 0.0, 1.0) * 2.0 - 1.0
        return grid_sample(x, grid), source_coordinate
