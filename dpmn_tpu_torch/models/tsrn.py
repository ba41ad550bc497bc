"""TSRN building blocks used by the TATT PSN.

Counterpart of dpmn_tpu/models/tsrn.py GruBlock and RecurrentResidualBlockTL
(reference model/tsrn.py:132-150, :249-278), NCHW.  Each SRB runs a vertical
bi-GRU sweep (sequences along H, one per image column) and a horizontal one
(sequences along W, one per image row); both recurrences run in the gru_scan
kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.gru import BiGRU
from ..ops.torch_compat import mish


class GruBlock(nn.Module):
    """conv1x1 + bi-GRU along W for every row (reference :132-150)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 1)
        self.gru = BiGRU(out_channels, out_channels // 2)

    def forward(self, x):
        """x (B, C, H, W) → (B, out, H, W)."""
        x = self.conv1(x)
        b, c, h, w = x.shape
        seq = x.permute(0, 2, 3, 1).reshape(b * h, w, c)
        return self.gru(seq).reshape(b, h, w, c).permute(0, 3, 1, 2)


class RecurrentResidualBlockTL(nn.Module):
    """SRB with text-prior fusion (reference :249-278)."""

    def __init__(self, channels: int, text_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(channels)
        self.gru1 = GruBlock(channels + text_channels, channels)
        self.gru2 = GruBlock(channels, channels)

    def forward(self, x, text_emb):
        residual = self.bn2(self.conv2(mish(self.bn1(self.conv1(x)))))
        cat = torch.cat([residual, text_emb], dim=1)
        # vertical sweep: swap H and W, run along (old) H, swap back
        residual = self.gru1(cat.transpose(2, 3)).transpose(2, 3)
        return self.gru2(x + residual)
