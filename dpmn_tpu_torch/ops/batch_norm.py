"""BatchNorm with flax.linen.BatchNorm's train-mode statistics.

In train mode both packages normalise with the biased batch variance, but
`nn.BatchNorm2d` moves `running_var` toward the *unbiased* one, where flax
moves it toward the biased one.  flax momentum 0.9 is torch momentum 0.1
(new = 0.9 old + 0.1 batch in both).  Eval mode is `nn.BatchNorm2d`'s own;
the parameter and buffer names are unchanged.

bf16 input in train mode (the bf16 AMP step) follows flax 0.12's
half-precision rule (flax.linen.normalization `_compute_stats`,
`BatchNorm.__call__`, `_normalize`): the batch mean and variance in float32
from the bf16 input, the normalisation in float32 with the (bf16) scale and
bias, the output rounded to the input's dtype; the running statistics move
as momentum * old in bf16 (the old value cast down, as the JAX package casts
the statistics for the step, dpmn_tpu/system.py:470-472; the momentum a
weakly typed bf16 scalar) plus (1 - momentum) * batch in float32, and the
float32 result is written into the float32 buffers.  The variance is the
two-pass one, as in float32 (flax's E[x^2] - E[x]^2 is a deliberate
difference, ROADMAP §3).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .torch_compat import weak


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if x.dtype == torch.bfloat16:
            return self._forward_bf16(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(x.mean(dim=(0, 2, 3)), alpha=m)
            self.running_var.mul_(1.0 - m).add_(x.var(dim=(0, 2, 3), unbiased=False), alpha=m)
        return y

    def _forward_bf16(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = F.batch_norm(xf, None, None, self.weight.float(), self.bias.float(), True, 0.0, self.eps)
        with torch.no_grad():
            m = self.momentum
            old = weak(1.0 - m, x.dtype)
            for buf, stat in ((self.running_mean, xf.mean(dim=(0, 2, 3))),
                              (self.running_var, xf.var(dim=(0, 2, 3), unbiased=False))):
                buf.copy_(buf.to(x.dtype) * old + stat * m)
        return y.to(x.dtype)
