"""MORAN recognizer: MORN offset-grid rectifier + ASRN attention decoder.

Counterpart of dpmn_tpu/models/moran.py (reference model/moran/: moran.py:6-22,
morn.py:7-95, asrn_res.py:9-259), the eval path: MORN predicts vertical
offsets on a 32x100 bilinear resize, grid-samples them back onto the full
grid and adds them to grid_y, with one more enhance pass at test time; ASRN
is a ResNet with momentum-0.01 BNs, two BiLSTMs and two GRU-cell attention
decoders that feed back argmax + 1 as the next character's embedding index.
Parameter names are the reference's (`MORN.cnn.{1,5,9,12,15}` convs and
`{2,6,10,13,16}` BNs; `ASRN.cnn.block{0..5}`, `ASRN.rnn.{0,1}`,
`ASRN.attention{L2R,R2L}.{attention_cell,generator,char_embeddings}`).

`frac_pickup` is the reference's train-only attention jitter
(fracPickup.py:7-48), with a torch.Generator.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.grid_sample import grid_sample
from ..ops.resize import resize
from .crnn import BidirectionalLSTM, parse_crnn_input


def _base_grid(h: int, w: int, device=None) -> torch.Tensor:
    """Normalized sampling grid, (1, H, W, 2) in (x, y) order (morn.py:27-44)."""
    ys = torch.arange(h, device=device) * 2.0 / (h - 1) - 1.0
    xs = torch.arange(w, device=device) * 2.0 / (w - 1) - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)[None]


class MORN(nn.Module):
    """Offset-grid rectifier (morn.py:7-95); the offset CNN serves the first
    pass and the test-time enhance pass."""

    def __init__(self):
        super().__init__()
        self.cnn = nn.Sequential(
            nn.MaxPool2d(2, 2), nn.Conv2d(1, 64, 3, 1, 1), nn.BatchNorm2d(64), nn.ReLU(), nn.MaxPool2d(2, 2),
            nn.Conv2d(64, 128, 3, 1, 1), nn.BatchNorm2d(128), nn.ReLU(), nn.MaxPool2d(2, 2),
            nn.Conv2d(128, 64, 3, 1, 1), nn.BatchNorm2d(64), nn.ReLU(),
            nn.Conv2d(64, 16, 3, 1, 1), nn.BatchNorm2d(16), nn.ReLU(),
            nn.Conv2d(16, 1, 3, 1, 1), nn.BatchNorm2d(1))

    def _offsets(self, x_small, grid):
        """The offset CNN's pooled offsets, sampled onto `grid` → (B, H, W, 1)."""
        offsets = self.cnn(x_small)
        pooled = F.max_pool2d(F.relu(offsets), 2, 1) - F.max_pool2d(F.relu(-offsets), 2, 1)
        return grid_sample(pooled, grid).permute(0, 2, 3, 1)

    def forward(self, x):
        """x NCHW (B, 1, H, W) → rectified (B, 1, 32, 100), with the test-time
        enhance pass (the judges' path; the reference's train-time skip of
        MORN is not ported)."""
        h, w = 32, 100
        x_small = resize(x, (h, w), mode="bilinear", align_corners=False)
        grid = _base_grid(h, w, x.device).to(x.dtype).expand(x.shape[0], h, w, 2)
        grid_x, grid_y = grid[..., 0:1], grid[..., 1:2]
        offsets_grid = self._offsets(x_small, grid)
        x_rectified = grid_sample(x, torch.cat([grid_x, grid_y + offsets_grid], dim=-1))
        offsets_grid = offsets_grid + self._offsets(x_rectified, grid)
        return grid_sample(x, torch.cat([grid_x, grid_y + offsets_grid], dim=-1))


class ResidualBlockMoran(nn.Module):
    """asrn_res.py:164-177: conv1 (3x3 with the stride, or 1x1) + BN, conv2
    3x3 + BN, no activation between them; a strided block's shortcut is a
    strided 3x3 conv + BN."""

    def __init__(self, c_in: int, c_out: int, stride=(1, 1)):
        super().__init__()
        down = stride[0] > 1
        bn = lambda: nn.BatchNorm2d(c_out, momentum=0.01)
        conv1 = nn.Conv2d(c_in, c_out, 3, stride, 1) if down else nn.Conv2d(c_in, c_out, 1, stride)
        self.conv1 = nn.Sequential(conv1, bn())
        self.conv2 = nn.Sequential(nn.Conv2d(c_out, c_out, 3, 1, 1), bn())
        self.downsample = nn.Sequential(nn.Conv2d(c_in, c_out, 3, stride, 1), bn()) if down else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(residual + self.conv2(self.conv1(x)))


class ResNetMoran(nn.Module):
    def __init__(self):
        super().__init__()
        self.block0 = nn.Sequential(nn.Conv2d(1, 32, 3, 1, 1), nn.BatchNorm2d(32, momentum=0.01))
        inp = 32
        for i, (c_out, stride, repeat) in enumerate(((32, (2, 2), 3), (64, (2, 2), 4), (128, (2, 1), 6),
                                                     (256, (2, 1), 6), (512, (2, 1), 3)), start=1):
            blocks = [ResidualBlockMoran(inp, c_out, stride)]
            blocks += [ResidualBlockMoran(c_out, c_out) for _ in range(repeat - 1)]
            setattr(self, f"block{i}", nn.Sequential(*blocks))
            inp = c_out

    def forward(self, x):
        for i in range(6):
            x = getattr(self, f"block{i}")(x)
        return x  # (B, 512, 1, 25) for a 32x100 input


class AttentionCell(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, num_embeddings: int):
        super().__init__()
        self.i2h = nn.Linear(input_size, hidden_size, bias=False)
        self.h2h = nn.Linear(hidden_size, hidden_size)
        self.score = nn.Linear(hidden_size, 1, bias=False)
        self.rnn = nn.GRUCell(input_size + num_embeddings, hidden_size)


class MoranAttention(nn.Module):
    """GRU-cell attention decoder (asrn_res.py:27-155), eval path."""

    def __init__(self, input_size: int = 256, hidden_size: int = 256, num_classes: int = 37,
                 num_embeddings: int = 256):
        super().__init__()
        self.hidden_size = hidden_size
        self.attention_cell = AttentionCell(input_size, hidden_size, num_embeddings)
        self.generator = nn.Linear(hidden_size, num_classes)
        self.char_embeddings = nn.Parameter(torch.randn(num_classes + 1, num_embeddings))

    def forward(self, feats, num_steps: int = 20):
        """feats (B, T, C) → (B, num_steps, num_classes) logits."""
        cell = self.attention_cell
        b = feats.shape[0]
        feats_proj = cell.i2h(feats)
        hidden = feats.new_zeros(b, self.hidden_size)
        tgt = torch.zeros(b, dtype=torch.long, device=feats.device)
        logits = []
        for _ in range(num_steps):
            e = cell.score(torch.tanh(feats_proj + cell.h2h(hidden)[:, None, :]))[..., 0]  # (B, T)
            context = torch.bmm(torch.softmax(e, dim=1)[:, None, :], feats)[:, 0]
            hidden = cell.rnn(torch.cat([context, self.char_embeddings[tgt]], dim=1), hidden)
            out = self.generator(hidden)
            logits.append(out)
            tgt = out.argmax(dim=1) + 1  # feed argmax + 1 (asrn_res.py:141-142)
        return torch.stack(logits, dim=1)


class ASRN(nn.Module):
    """ResNet → 2 x BiLSTM → bidirectional attention decode (asrn_res.py:214-259)."""

    def __init__(self, nh: int = 256, num_classes: int = 37):
        super().__init__()
        self.cnn = ResNetMoran()
        self.rnn = nn.Sequential(BidirectionalLSTM(512, nh, nh), BidirectionalLSTM(nh, nh, nh))
        self.attentionL2R = MoranAttention(nh, nh, num_classes)
        self.attentionR2L = MoranAttention(nh, nh, num_classes)

    def forward(self, x, num_steps: int = 20):
        seq = self.rnn(self.cnn(x)[:, :, 0].transpose(1, 2))  # (B, T, nh)
        return self.attentionL2R(seq, num_steps), self.attentionR2L(seq, num_steps)


class MORAN(nn.Module):
    """MORN + ASRN (moran.py:6-22), eval interface."""

    def __init__(self, num_classes: int = 37, nh: int = 256):
        super().__init__()
        self.MORN = MORN()
        self.ASRN = ASRN(nh, num_classes)

    def forward(self, x, num_steps: int = 20):
        """x (B, 1, 32, 100) grayscale → (logits_l2r, logits_r2l), each
        (B, num_steps, num_classes)."""
        return self.ASRN(self.MORN(x), num_steps)


# RGB NCHW in [0, 1] → (B, 1, 32, 100) grayscale: the reference's MORAN
# parser (interfaces/base.py:396-409) is the CRNN's, a torch-bicubic resize
# then luma.
parse_moran_input = parse_crnn_input


def frac_pickup_warp(alpha: torch.Tensor, idx: int, beta: float) -> torch.Tensor:
    """alpha (B, T) resampled on the grid whose columns idx-1 and idx are
    swapped toward each other by the blend beta (fracPickup.py:7-48)."""
    b, t = alpha.shape
    w = torch.arange(t, dtype=alpha.dtype, device=alpha.device) * 2.0 / (t - 1) - 1.0
    v0 = beta * w[idx] + (1 - beta) * w[idx - 1]
    v1 = beta * w[idx - 1] + (1 - beta) * w[idx]
    w = w.clone()
    w[idx - 1], w[idx] = v0, v1
    grid = torch.stack([w.expand(b, 1, t), torch.zeros(b, 1, t, dtype=alpha.dtype, device=alpha.device)], dim=-1)
    return grid_sample(alpha[:, None, None, :], grid)[:, 0, 0, :]


def frac_pickup(alpha: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Train-only attention jitter: a random adjacent pair of attention
    columns (idx uniform in [1, T-1)) swapped by a random blend (beta uniform
    in [0, 1/4)), both drawn from `generator` (a CPU generator)."""
    t = alpha.shape[1]
    idx = int(torch.randint(1, t - 1, (), generator=generator))
    beta = float(torch.rand((), generator=generator)) / 4.0
    return frac_pickup_warp(alpha, idx, beta)
