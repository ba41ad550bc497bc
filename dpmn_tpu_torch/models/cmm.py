"""CMM — Complementation Modulation Module (dual-encoder U-Net fuser).

Counterpart of dpmn_tpu/models/cmm.py (reference model/cmm.py:38-161): two
6-stage encoders (one per PGRM branch output), an SE-style channel gate at the
bottleneck applied as residual * weight + residual, and a skip-concat
transpose-conv decoder.  NCHW; on 32x128 inputs the stages run 32x128 →
16x64 → 8x32 → 4x16 → 2x8 → 1x4.  In train mode its BatchNorms use batch
statistics and move their running statistics as flax does (ops/batch_norm.py).
On bf16 input (the bf16 AMP step) every op runs in bf16, its BatchNorms by
flax's half-precision rule, the leaky-ReLU slope rounded to bf16 as JAX's
weakly typed 0.2 is.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.batch_norm import BatchNorm2d
from ..ops.torch_compat import weak


def _leaky(x):
    return F.leaky_relu(x, weak(0.2, x.dtype))


class EncodeBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, in_channels, 4, stride=2, padding=3, dilation=2)
        self.bn1 = BatchNorm2d(in_channels)
        self.conv2 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.bn2 = BatchNorm2d(out_channels)

    def forward(self, x):
        x = self.bn1(self.conv1(_leaky(x)))
        return self.bn2(self.conv2(_leaky(x)))


class DecodeBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.deconv1 = nn.ConvTranspose2d(in_channels, out_channels, 3, stride=1, padding=1)
        self.bn1 = BatchNorm2d(out_channels)
        self.deconv2 = nn.ConvTranspose2d(out_channels, out_channels, 4, stride=2, padding=1)
        self.bn2 = BatchNorm2d(out_channels)

    def forward(self, x):
        x = self.bn1(self.deconv1(F.relu(x)))
        return self.bn2(self.deconv2(F.relu(x)))


class CMM(nn.Module):
    def __init__(self, c_img: int = 3, cnum: int = 64):
        super().__init__()
        cn = self.cnum = cnum
        for tag in ("1", "2"):
            setattr(self, f"en_1_{tag}", nn.Conv2d(c_img, cn, 3, padding=1))
            setattr(self, f"en_2_{tag}", EncodeBlock(cn, cn * 2))
            setattr(self, f"en_3_{tag}", EncodeBlock(cn * 2, cn * 4))
            setattr(self, f"en_4_{tag}", EncodeBlock(cn * 4, cn * 8))
            setattr(self, f"en_5_{tag}", EncodeBlock(cn * 8, cn * 8))
            setattr(self, f"en_6_{tag}", nn.Conv2d(cn * 8, cn * 8, 4, stride=2, padding=1))
        self.fc_1 = nn.Linear(16 * cn, 4 * cn)
        self.fc_2 = nn.Linear(4 * cn, 16 * cn)
        self.de_6_conv = nn.ConvTranspose2d(16 * cn, cn * 8, 4, stride=2, padding=1)
        self.de_6_bn = BatchNorm2d(cn * 8)
        self.de_5 = DecodeBlock(cn * 8 * 3, cn * 8)
        self.de_4 = DecodeBlock(cn * 8 * 3, cn * 4)
        self.de_3 = DecodeBlock(cn * 4 * 3, cn * 2)
        self.de_2 = DecodeBlock(cn * 2 * 3, cn)
        self.de_1_conv = nn.ConvTranspose2d(cn * 3, c_img, 3, stride=1, padding=1)

    def _encode(self, x, tag):
        o = {1: getattr(self, f"en_1_{tag}")(x)}
        for k in (2, 3, 4, 5):
            o[k] = getattr(self, f"en_{k}_{tag}")(o[k - 1])
        o[6] = getattr(self, f"en_6_{tag}")(_leaky(o[5]))
        return o

    def forward(self, x1, x2):
        """x1, x2: branch SR images (B, 3, 32, 128) → fused image."""
        o1, o2 = self._encode(x1, "1"), self._encode(x2, "2")
        res = torch.cat([o1[6], o2[6]], dim=1)
        z = F.relu(self.fc_1(res.mean(dim=(2, 3))))
        weight = torch.sigmoid(self.fc_2(z))
        out6 = res * weight[:, :, None, None] + res
        d = self.de_6_bn(self.de_6_conv(F.relu(out6)))
        for k, blk in ((5, self.de_5), (4, self.de_4), (3, self.de_3), (2, self.de_2)):
            d = blk(torch.cat([d, o1[k], o2[k]], dim=1))
        return self.de_1_conv(F.relu(torch.cat([d, o1[1], o2[1]], dim=1)))
