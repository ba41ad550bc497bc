"""TBSRN PSN: the TSRN skeleton with self-attention FeatureEnhancer SRBs, NCHW,
eval.

Counterpart of dpmn_tpu/models/tbsrn.py (reference model/tbsrn.py:63-257).
Each SRB is conv-BN-mish-conv-BN followed by a FeatureEnhancer over the
h * w tokens of the feature map (row-major, the JAX package's NHWC reshape):
the tokens' 64 channels and a static 2-D sincos code of 64 concatenated (128
wide), one 4-head attention block and one feed-forward block, each closed by
the reference's LayerNorm (x - mean) / (std + eps) with the *unbiased* std,
then a linear back to 64 channels; the SRB output is x + that.  The
reference's SRBs also define gru1 / gru2 and never call them
(tbsrn.py:246-257), so no GRU runs here.  The attention is the port's
MultiHeadAttention (the JAX package computes it outside any Pallas kernel);
its dropout of 0.1 is off in eval.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import MultiHeadAttention
from ..ops.torch_compat import mish
from .tsrn import PSN

POS_CHANNELS = 64  # the positional code's channels; the features' must match (128 = 64 + 64)


def positional_encoding_2d(d_model: int, height: int, width: int) -> np.ndarray:
    """(d_model, H, W) static sincos code (reference tbsrn.py:39-61): the
    first half codes the column, the second the row."""
    assert d_model % 4 == 0
    pe = np.zeros((d_model, height, width), np.float32)
    half = d_model // 2
    div_term = np.exp(np.arange(0.0, half, 2) * -(math.log(10000.0) / half))
    pos_w = np.arange(0.0, width)[:, None]
    pos_h = np.arange(0.0, height)[:, None]
    pe[0:half:2] = np.sin(pos_w * div_term).T[:, None, :].repeat(height, axis=1)
    pe[1:half:2] = np.cos(pos_w * div_term).T[:, None, :].repeat(height, axis=1)
    pe[half::2] = np.sin(pos_h * div_term).T[:, :, None].repeat(width, axis=2)
    pe[half + 1 :: 2] = np.cos(pos_h * div_term).T[:, :, None].repeat(width, axis=2)
    return pe


class TorchRefLayerNorm(nn.Module):
    """a_2 * (x - mean) / (std_unbiased + eps) + b_2 (reference tbsrn.py:23-36),
    the statistics in float32 as dpmn_tpu computes them."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.a_2 = nn.Parameter(torch.ones(features))
        self.b_2 = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        std = xf.std(-1, keepdim=True)
        return (self.a_2.float() * (xf - mean) / (std + self.eps) + self.b_2.float()).to(x.dtype)


class FeatureEnhancer(nn.Module):
    """Token self-attention over the (B, h*w, 64) feature map (ref :63-92)."""

    def __init__(self, height: int = 16, width: int = 64):
        super().__init__()
        code = positional_encoding_2d(POS_CHANNELS, height, width).reshape(POS_CHANNELS, -1).T
        self.register_buffer("pe", torch.from_numpy(np.ascontiguousarray(code)), persistent=False)
        d = 2 * POS_CHANNELS
        self.multihead = MultiHeadAttention(d, 4)
        self.mul_layernorm1 = TorchRefLayerNorm(d)
        self.w_1 = nn.Linear(d, d)
        self.w_2 = nn.Linear(d, d)
        self.mul_layernorm3 = TorchRefLayerNorm(d)
        self.linear = nn.Linear(d, POS_CHANNELS)

    def forward(self, tokens):
        """tokens (B, h*w, 64) → (B, h*w, 64)."""
        pos = self.pe.to(tokens.dtype).expand(tokens.shape[0], -1, -1)
        x = torch.cat([tokens, pos], dim=-1)
        x = self.mul_layernorm1(x + self.multihead(x, x, x, need_weights=False)[0])
        x = self.mul_layernorm3(x + self.w_2(F.relu(self.w_1(x))))
        return self.linear(x)


class TBSRNBlock(nn.Module):
    """SRB with a FeatureEnhancer (reference :229-257)."""

    def __init__(self, channels: int, height: int, width: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(channels)
        self.feature_enhancer = FeatureEnhancer(height, width)

    def forward(self, x):
        residual = self.bn2(self.conv2(mish(self.bn1(self.conv1(x)))))
        b, c, h, w = residual.shape
        enhanced = self.feature_enhancer(residual.flatten(2).transpose(1, 2))  # (B, h*w, C), row-major
        return x + enhanced.transpose(1, 2).reshape(b, c, h, w)


class TBSRN(PSN):
    """The `tbsrn` PSN (reference :166-226): x (B, 4 or 3, h, w) LR image →
    tanh SR (B, 4 or 3, 2h, 2w), with h = height / scale_factor and
    w = width / scale_factor the grid of the positional code."""

    def __init__(self, scale_factor=2, width=128, height=32, srb_nums=5, mask=False, hidden_units=32):
        super().__init__()
        if 2 * hidden_units != POS_CHANNELS:
            raise ValueError(f"TBSRN: the FeatureEnhancer concatenates its {POS_CHANNELS}-channel positional code "
                             f"to the SRB features into a width of {2 * POS_CHANNELS}, so the features must have "
                             f"{POS_CHANNELS} channels (hidden_units {POS_CHANNELS // 2}); got hidden_units "
                             f"{hidden_units}")
        ch = self._stem(mask, hidden_units)
        lh, lw = height // scale_factor, width // scale_factor
        self.srbs = nn.ModuleList([TBSRNBlock(ch, lh, lw) for _ in range(srb_nums)])
        self._trunk(ch, scale_factor)

    def forward(self, x):
        b1 = self._head(x)
        feat = b1
        for srb in self.srbs:
            feat = srb(feat)
        return self._tail(b1, feat)
