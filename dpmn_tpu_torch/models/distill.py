"""Deep-to-shallow self-distillation module (counterpart of
dpmn_tpu/models/distill.py, reference model/distill_module.py:4-31).

cat(deep, shallow) → conv(6→3) + BN + ReLU against conv(shallow)(3→3) + BN +
ReLU; the L1 between the two features is the distill loss, and the cat
feature is passed down the cascade (interfaces/super_resolution.py:245-263).
NCHW.  On bf16 input (the bf16 AMP step) the features and the loss are bf16
(the mean summed in float32, as jnp.mean does), the BatchNorms by flax's
half-precision rule (ops/batch_norm.py); the step casts the loss to float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.batch_norm import BatchNorm2d


class DistillModule(nn.Module):
    def __init__(self, channels: int = 3):
        super().__init__()
        self.conv_cat_feature = nn.Conv2d(2 * channels, channels, 3, padding=1)
        self.bn_1 = BatchNorm2d(channels)
        self.conv_feature = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn_2 = BatchNorm2d(channels)

    def forward(self, x_deep, x_shallow):
        """Returns (loss, feature_cat)."""
        feature_cat = F.relu(self.bn_1(self.conv_cat_feature(torch.cat([x_deep, x_shallow], dim=1))))
        feature_shallow = F.relu(self.bn_2(self.conv_feature(x_shallow)))
        return torch.mean(torch.abs(feature_cat - feature_shallow)), feature_cat
