"""Counterpart of dpmn_tpu/ops/torch_compat.py.

The JAX package re-implements three torch primitives; the port uses torch's
own: `nn.PReLU` (one shared slope), `nn.ConvTranspose2d` (the CMM decoder,
weights (in, out, kh, kw)) and `F.pixel_shuffle` (dpmn_tpu/ops/pixel_shuffle.py
reproduces torch's channel order).  Only mish needs a definition, and the
LayerNorm epsilon: every flax nn.LayerNorm of the JAX package uses flax's
default 1e-6, where torch's default is 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) — reference model/tsrn.py:121-129."""
    return x * torch.tanh(F.softplus(x))
