"""CRNN recognizer (7-conv VGG → 2 x BiLSTM → per-frame logits), eval.

Counterpart of dpmn_tpu/models/crnn.py (reference model/crnn/crnn.py:23-79):
a (B, 1, 32, 100) grayscale crop in, (T = 26, B, 37) logits out.  It is the
frozen text-prior recognizer in front of the TATT PSN.  The LSTMs are torch's
own nn.LSTM (no TPU kernel exists for them); names follow the reference
(`rnn`, `embedding`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize


class BidirectionalLSTM(nn.Module):
    def __init__(self, n_in: int, hidden: int, n_out: int):
        super().__init__()
        self.rnn = nn.LSTM(n_in, hidden, bidirectional=True, batch_first=True)
        self.embedding = nn.Linear(2 * hidden, n_out)

    def forward(self, x):
        """x (B, T, C) → (B, T, n_out)."""
        return self.embedding(self.rnn(x)[0])


class CRNN(nn.Module):
    def __init__(self, nc: int = 1, nclass: int = 37, nh: int = 256):
        super().__init__()
        chans = (nc, 64, 128, 256, 256, 512, 512, 512)
        self.convs = nn.ModuleList(
            [nn.Conv2d(chans[i], chans[i + 1], 3 if i < 6 else 2, padding=1 if i < 6 else 0) for i in range(7)])
        self.bns = nn.ModuleDict({str(i): nn.BatchNorm2d(chans[i + 1]) for i in (2, 4, 6)})
        self.rnn1 = BidirectionalLSTM(512, nh, nh)
        self.rnn2 = BidirectionalLSTM(nh, nh, nclass)

    def forward(self, x):
        """x (B, nc, 32, W) → logits (T, B, nclass)."""
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if str(i) in self.bns:
                x = self.bns[str(i)](x)
            x = F.relu(x)
            if i in (0, 1):
                x = F.max_pool2d(x, 2, 2)
            elif i in (3, 5):
                x = F.max_pool2d(x, (2, 2), (2, 1), (0, 1))
        if x.shape[2] != 1:
            raise ValueError(f"conv height must be 1, got {tuple(x.shape)}")
        x = x[:, :, 0].transpose(1, 2)  # (B, T, 512)
        return self.rnn2(self.rnn1(x)).transpose(0, 1)


def parse_crnn_input(imgs: torch.Tensor) -> torch.Tensor:
    """RGB NCHW in [0, 1] → (B, 1, 32, 100) grayscale via the torch-bicubic
    resize matrices (interfaces/base.py:419-425)."""
    x = resize(imgs[:, :3], (32, 100), mode="bicubic", align_corners=False)
    return 0.299 * x[:, 0:1] + 0.587 * x[:, 1:2] + 0.114 * x[:, 2:3]
