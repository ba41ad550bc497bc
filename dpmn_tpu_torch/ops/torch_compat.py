"""Counterpart of dpmn_tpu/ops/torch_compat.py.

The JAX package re-implements three torch primitives; the port uses torch's
own: `nn.PReLU` (one shared slope), `nn.ConvTranspose2d` (the CMM decoder,
weights (in, out, kh, kw)) and `F.pixel_shuffle` (dpmn_tpu/ops/pixel_shuffle.py
reproduces torch's channel order).  Only mish needs a definition, and the
LayerNorm epsilon: every flax nn.LayerNorm of the JAX package uses flax's
default 1e-6, where torch's default is 1e-5.  `weak` gives a Python
constant the value JAX computes with against an array of a given dtype.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


@functools.lru_cache(maxsize=None)
def weak(value: float, dtype: torch.dtype) -> float:
    """`value` as JAX uses a Python scalar against an array of `dtype`: a
    weakly typed scalar takes the array's dtype, so against bf16 it is
    rounded to bf16 (0.9 -> 0.8984375).  Against float32 or float64 the
    result is the value torch computes with anyway."""
    return float(torch.tensor(value, dtype=dtype))


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) — reference model/tsrn.py:121-129."""
    return x * torch.tanh(F.softplus(x))
