"""VisionLAN recognizer, eval path — the student that reads the cascade image.

Counterpart of dpmn_tpu/models/visionlan.py (reference model/VisionLAN/):
ResNet45 backbone (strides (1,1),(2,2),(2,2),(2,2),(1,1),(1,1) → (B, 512, 8, 32)
on a 64x256 input), a 3-layer post-LN transformer encoder, the parallel
prediction layer and a fixed 25-step argmax with the first-EOS length in
place of the reference's early-stop loop (VisionLAN.py:114-131).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize
from ..ops.torch_compat import LN_EPS


def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """(n_position, d_hid) PE table (modules/modules.py:11-18)."""
    pos = np.arange(n_position)[:, None]
    j = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class BasicBlockVL(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride=(1, 1), downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (
            nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False), nn.BatchNorm2d(planes))
            if downsample else None)

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        residual = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + residual)


class ResNet45(nn.Module):
    def __init__(self, strides=((1, 1), (2, 2), (2, 2), (2, 2), (1, 1), (1, 1))):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3, stride=strides[0], padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(32)
        blocks, inplanes = [], 32
        for planes, n, stride in zip((32, 64, 128, 256, 512), (3, 4, 6, 6, 3), strides[1:]):
            down = tuple(stride) != (1, 1) or inplanes != planes
            blocks.append(BasicBlockVL(inplanes, planes, stride, down))
            blocks += [BasicBlockVL(planes, planes) for _ in range(1, n)]
            inplanes = planes
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        for blk in self.blocks:
            x = blk(x)
        return x


class VLEncoderLayer(nn.Module):
    """Separate q/k/v MHA + FFN, post-LN (modules/modules.py:41-108)."""

    def __init__(self, d_model=512, d_inner=2048, n_head=8):
        super().__init__()
        self.n_head = n_head
        self.w_qs = nn.Linear(d_model, d_model)
        self.w_ks = nn.Linear(d_model, d_model)
        self.w_vs = nn.Linear(d_model, d_model)
        self.fc = nn.Linear(d_model, d_model)
        self.attn_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.w_1 = nn.Linear(d_model, d_inner)
        self.w_2 = nn.Linear(d_inner, d_model)
        self.ffn_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x):
        b, l, d = x.shape
        dk = d // self.n_head

        def split(t):
            return t.reshape(b, l, self.n_head, dk).transpose(1, 2)

        q, k, v = split(self.w_qs(x)), split(self.w_ks(x)), split(self.w_vs(x))
        attn = torch.softmax((q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dk)), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, l, d)
        x = self.attn_norm(self.fc(out) + x)
        return self.ffn_norm(self.w_2(F.relu(self.w_1(x))) + x)


class TransformerEncoderVL(nn.Module):
    def __init__(self, n_layers=3, n_position=256, d_model=512, d_inner=2048):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(sinusoid_table(n_position, d_model)), persistent=False)
        self.layers = nn.ModuleList([VLEncoderLayer(d_model, d_inner) for _ in range(n_layers)])
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x):
        x = x + self.pe[None, : x.shape[1]].to(x.dtype)  # cast first, as visionlan.py:126-132
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)


class PPLayer(nn.Module):
    """Parallel-prediction attention (modules/modules.py:148-170)."""

    def __init__(self, n_dim=512, n_max_character=25, n_position=256):
        super().__init__()
        self.f0_embedding = nn.Embedding(n_max_character, n_dim)
        self.w0 = nn.Linear(n_max_character, n_position)
        self.wv = nn.Linear(n_dim, n_dim)
        self.we = nn.Linear(n_dim, n_max_character)

    def forward(self, enc):
        t = self.w0(self.f0_embedding.weight.T)  # (512, 256): the same for every sample
        t = torch.tanh(t.T[None] + self.wv(enc))  # (B, 256, 512)
        t = torch.softmax(self.we(t).transpose(1, 2), dim=2)  # (B, S, 256)
        return t @ enc  # (B, S, 512)


class VisionLAN(nn.Module):
    """Eval model (VisionLAN.py:142-167): NCHW (B, 3, 64, 256) → (logits
    (B, 25, n_class), lengths (B,))."""

    def __init__(self, n_class: int = 37, n_max_character: int = 26):
        super().__init__()
        self.backbone = ResNet45()
        self.SequenceModeling = TransformerEncoderVL(n_layers=3)
        self.pp = PPLayer(n_max_character=n_max_character)
        self.w_vrm = nn.Linear(512, n_class)

    def forward(self, x):
        feats = self.backbone(x)  # (B, 512, 8, 32)
        b = feats.shape[0]
        # the reference flattens W-major then H (VisionLAN.py:76-78)
        tokens = feats.permute(0, 3, 2, 1).reshape(b, -1, 512)
        logits = self.w_vrm(self.pp(self.SequenceModeling(tokens)))[:, :25]
        is_eos = logits.argmax(-1) == 0
        first_eos = torch.argmax(is_eos.to(torch.int32), dim=1)
        lengths = torch.where(is_eos.any(dim=1), first_eos + 1, 25)
        return logits, lengths


def parse_visionlan_input(imgs: torch.Tensor) -> torch.Tensor:
    """RGB NCHW float → (B, 3, 64, 256) (interfaces/base.py:473-478).

    The reference round-trips each sample through ToPILImage (float·255 cast
    to uint8: truncation toward zero, wrapping modulo 256 — tanh'd PSN outputs
    do go negative), a bilinear resize of the uint8 image re-quantized to
    uint8, and ToTensor (/255); both quantizations are reproduced."""
    x = torch.remainder(torch.trunc(imgs[:, :3] * 255.0).to(torch.int32), 256)
    y = resize(x.to(imgs.dtype), (64, 256), mode="bilinear", align_corners=False)
    return torch.clamp(torch.round(y), 0.0, 255.0) / 255.0
