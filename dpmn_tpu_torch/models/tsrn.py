"""TSRN / TG / TSRN_TL Prior Super-resolution Networks and the skeleton every
PSN of the port shares, NCHW, eval.

Counterpart of dpmn_tpu/models/tsrn.py (reference model/tsrn.py):
  * TSRN (:14-74), the `tsrn` and `tg` PSN: conv9x9 + PReLU → srb_nums
    recurrent residual blocks (SRB: conv-BN-mish-conv-BN, then a vertical
    bi-GRU sweep (sequences along H, one per image column) and a horizontal
    one (sequences along W, one per image row)) → conv3x3 + BN → (+ the
    stem's features) → x2 upsample blocks → conv9x9 → tanh;
  * TSRN_TL (:153-247), the `tpgsr` PSN: the same skeleton, each SRB's
    vertical sweep reading the residual concatenated with a spatial
    text-prior embedding that InfoGen (:281-308) makes from the (B, 37, 1, T)
    text-prior logits.
The TPS-STN front end is left out: the reference and the JAX package apply it
in training only, and the frozen PSN runs in eval for good.  Every GRU sweep
runs in the gru_scan kernel (ops/gru.py).

`PSN` holds the skeleton's modules under the names the reference-checkpoint
key maps share across TSRN, TSRN_TL, TBSRN and TATT (convert.py): conv_in,
prelu, srbs, conv_mid, bn_mid, upsample, conv_out.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.gru import BiGRU
from ..ops.resize import resize
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


class RecurrentResidualBlock(nn.Module):
    """SRB (reference :77-101); with `text_channels` the SRB of TSRN_TL and
    TATT, whose vertical sweep reads the residual concatenated with a
    text-prior map of that many channels (RecurrentResidualBlockTL,
    :249-278)."""

    def __init__(self, channels: int, text_channels: int = 0):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(channels)
        self.gru1 = GruBlock(channels + text_channels, channels)
        self.gru2 = GruBlock(channels, channels)

    def forward(self, x, text_emb=None):
        residual = self.bn2(self.conv2(mish(self.bn1(self.conv1(x)))))
        if text_emb is not None:
            residual = torch.cat([residual, text_emb], dim=1)
        # vertical sweep: swap H and W, run along (old) H, swap back
        residual = self.gru1(residual.transpose(2, 3)).transpose(2, 3)
        return self.gru2(x + residual)


class UpsampleBlock(nn.Conv2d):
    """conv3x3 C → C·r² + PixelShuffle + mish (reference :104-118); the
    conv is the module itself, so its weight sits at `upsample.{i}.weight`
    in every PSN."""

    def __init__(self, channels: int, up_scale: int = 2):
        super().__init__(channels, channels * up_scale**2, 3, padding=1)
        self.up_scale = up_scale

    def forward(self, x):
        return mish(F.pixel_shuffle(super().forward(x), self.up_scale))


class InfoGen(nn.Module):
    """Text-prior spatial embedding (reference :281-308): four transposed
    convs without bias, each followed by BN and ReLU; (B, 37, 1, T) →
    (B, output_size, 1, 8T - 5)."""

    def __init__(self, t_emb: int = 37, output_size: int = 32):
        super().__init__()
        self.tconv1 = nn.ConvTranspose2d(t_emb, 512, 3, 2, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(512)
        self.tconv2 = nn.ConvTranspose2d(512, 128, 3, 2, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(128)
        self.tconv3 = nn.ConvTranspose2d(128, 64, 3, 2, padding=1, bias=False)
        self.bn3 = nn.BatchNorm2d(64)
        self.tconv4 = nn.ConvTranspose2d(64, output_size, 3, (2, 1), padding=(1, 0), bias=False)
        self.bn4 = nn.BatchNorm2d(output_size)

    def forward(self, t_embedding):
        x = t_embedding
        for j in range(1, 5):
            x = F.relu(getattr(self, f"bn{j}")(getattr(self, f"tconv{j}")(x)))
        return x


class PSN(nn.Module):
    """The skeleton of the four PSNs: `_stem` makes conv_in and prelu,
    `_trunk` conv_mid, bn_mid, the x2 upsample blocks and conv_out; a PSN
    registers its SRBs (and its text-prior module) between the two."""

    def _stem(self, mask: bool, hidden_units: int) -> int:
        self.in_planes = 4 if mask else 3
        ch = 2 * hidden_units
        self.conv_in = nn.Conv2d(self.in_planes, ch, 9, padding=4)
        self.prelu = nn.PReLU()
        return ch

    def _trunk(self, ch: int, scale_factor: int) -> None:
        self.conv_mid = nn.Conv2d(ch, ch, 3, padding=1)
        self.bn_mid = nn.BatchNorm2d(ch)
        self.upsample = nn.ModuleList([UpsampleBlock(ch) for _ in range(int(math.log2(scale_factor)))])
        self.conv_out = nn.Conv2d(ch, self.in_planes, 9, padding=4)

    def _head(self, x):
        return self.prelu(self.conv_in(x))

    def _tail(self, b1, feat):
        out = b1 + self.bn_mid(self.conv_mid(feat))
        for up in self.upsample:
            out = up(out)
        return torch.tanh(self.conv_out(out))


class TSRN(PSN):
    """The `tsrn` / `tg` PSN (reference :14-74): x (B, 4 or 3, h, w) LR
    image → tanh SR (B, 4 or 3, 2h, 2w).  `width` and `height` are taken
    for the constructors' common signature; without the STN nothing reads
    them."""

    def __init__(self, scale_factor=2, width=128, height=32, srb_nums=5, mask=True, hidden_units=32):
        super().__init__()
        ch = self._stem(mask, hidden_units)
        self.srbs = nn.ModuleList([RecurrentResidualBlock(ch) for _ in range(srb_nums)])
        self._trunk(ch, scale_factor)

    def forward(self, x):
        b1 = self._head(x)
        feat = b1
        for srb in self.srbs:
            feat = srb(feat)
        return self._tail(b1, feat)


class TSRN_TL(PSN):
    """The `tpgsr` PSN (reference :153-247): x (B, 4 or 3, h, w) and the text
    prior (B, 37, 1, T) → tanh SR; InfoGen's map is resized to h x w
    (bilinear, align_corners) and fused into every SRB."""

    def __init__(self, scale_factor=2, width=128, height=32, srb_nums=5, mask=True, hidden_units=32,
                 text_emb=37, out_text_channels=32):
        super().__init__()
        self.text_emb = text_emb
        ch = self._stem(mask, hidden_units)
        self.infoGen = InfoGen(text_emb, out_text_channels)
        self.srbs = nn.ModuleList([RecurrentResidualBlock(ch, out_text_channels) for _ in range(srb_nums)])
        self._trunk(ch, scale_factor)

    def forward(self, x, text_emb=None):
        b1 = self._head(x)
        if text_emb is None:  # no prior: zeros over the CRNN's 26 frames, as dpmn_tpu's TSRN_TL
            text_emb = x.new_zeros(x.shape[0], self.text_emb, 1, 26)
        t_map = resize(self.infoGen(text_emb), tuple(x.shape[2:]), mode="bilinear", align_corners=True)
        feat = b1
        for srb in self.srbs:
            feat = srb(feat, t_map)
        return self._tail(b1, feat)
