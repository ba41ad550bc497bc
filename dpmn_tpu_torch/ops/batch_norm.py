"""BatchNorm with flax.linen.BatchNorm's train-mode statistics.

In train mode both packages normalise with the biased batch variance, but
`nn.BatchNorm2d` moves `running_var` toward the *unbiased* one, where flax
moves it toward the biased one.  flax momentum 0.9 is torch momentum 0.1
(new = 0.9 old + 0.1 batch in both).  Eval mode is `nn.BatchNorm2d`'s own;
the parameter and buffer names are unchanged.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(x.mean(dim=(0, 2, 3)), alpha=m)
            self.running_var.mul_(1.0 - m).add_(x.var(dim=(0, 2, 3), unbiased=False), alpha=m)
        return y
