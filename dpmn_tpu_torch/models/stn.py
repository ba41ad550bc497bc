"""STN localization head predicting TPS control points.

Counterpart of dpmn_tpu/models/stn.py.  The reference has two near-duplicate
heads, six conv3x3-BN-ReLU blocks with max pools between them, then fc(512)
→ BN → ReLU and a final fc:
  * model/stn_head.py:25-106, the PSN's front, pools 2x2 four times then
    1x2 on its 16x64 input (variant "psn");
  * model/recognizer/stn_head.py:26-106, ASTER's, pools 2x2 five times on
    its 32x64 input (variant "recognizer").
Both leave a (256, 1, 2) map, so fc1 takes 512 inputs; NCHW flattens it in
the reference's (C, H, W) order.  Parameter names are the reference's
(`stn_convnet.{0,2,4,6,8,10}.{0,1}`, `stn_fc1.{0,1}`, `stn_fc2`).  Every
caller of the reference and of dpmn_tpu passes activation "none", so the
control points are stn_fc2's output as it is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn


def init_ctrl_points(num_ctrlpoints: int, margin: float = 0.01) -> np.ndarray:
    """The margin-0.01 rectangle of control points, (N, 2) in (x, y): the
    bias of stn_fc2, whose zero weight makes an untrained STN a near-identity
    warp."""
    n_side = num_ctrlpoints // 2
    xs = np.linspace(margin, 1.0 - margin, n_side)
    top = np.stack([xs, np.full(n_side, margin)], axis=1)
    bottom = np.stack([xs, np.full(n_side, 1.0 - margin)], axis=1)
    return np.concatenate([top, bottom], axis=0).astype(np.float32)


def _conv_block(c_in: int, c_out: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(c_in, c_out, 3, padding=1), nn.BatchNorm2d(c_out), nn.ReLU())


class STNHead(nn.Module):
    def __init__(self, in_planes: int, num_ctrlpoints: int = 20, variant: str = "psn"):
        super().__init__()
        if variant not in ("psn", "recognizer"):
            raise ValueError(variant)
        self.num_ctrlpoints = num_ctrlpoints
        last_pool = (1, 2) if variant == "psn" else (2, 2)
        chans = (in_planes, 32, 64, 128, 256, 256, 256)
        layers = []
        for i in range(6):
            layers.append(_conv_block(chans[i], chans[i + 1]))
            if i < 4:
                layers.append(nn.MaxPool2d(2, 2))
            elif i == 4:
                layers.append(nn.MaxPool2d(last_pool, last_pool))
        self.stn_convnet = nn.Sequential(*layers)
        self.stn_fc1 = nn.Sequential(nn.Linear(2 * 256, 512), nn.BatchNorm1d(512), nn.ReLU())
        self.stn_fc2 = nn.Linear(512, num_ctrlpoints * 2)

    def forward(self, x: torch.Tensor):
        """x NCHW, (B, C, 16, 64) psn / (B, C, 32, 64) recognizer → (img_feat
        (B, 512), ctrl_points (B, N, 2))."""
        x = self.stn_convnet(x).flatten(1)
        feat = self.stn_fc1(x)
        return feat, self.stn_fc2(0.1 * feat).reshape(-1, self.num_ctrlpoints, 2)
