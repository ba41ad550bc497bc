"""The training cores' attention-dropout masks, dumped by the hand-written kernel K9.

Counterpart of tools/debug_train_dropout.py::dump_masks, a TPU kernel that
reseeds the TPU's PRNG per image and group and draws, per head, the keep
mask of dpmn_tpu/ops/pallas_window_train.py::_dropout_mask (0, or 1/keep
where the low 31 bits of the draw are below keep * 2^31).  The port's
training cores (K3, K4, K5) draw that mask in-kernel from a counter hash of
(seed, image, group, head, window, query, key) instead
(ops/window_attention_train.py `dropout_bits`); `dropout_mask` returns
exactly those draws for a seed, so a dumped mask is the mask a core applied.

The masks are per window, (B, heads, nW, N, N) for each group, not packed
into the TPU's (HW/128, 128, 128) tiles: the port's cores never pack
(ops/window_attention_core.py).  `dropout_mask` launches
csrc/dropout_mask.cu on the card and runs the plain version
`dropout_mask_plain` (`dropout_bits` + `keep_multiplier`) on the CPU.  No
JAX function computes these masks on the CPU: the TPU kernel draws from the
TPU's hardware PRNG, which has no interpret mode.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from .. import resolve_device
from . import kernels
from .window_attention_train import _M32, dropout_bits, keep_multiplier, keep_threshold

dropout_mask_counter = kernels.LaunchCounter()


def _geometry(keep: float, window_sizes: Sequence[int], hw_shape):
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"keep {keep} outside (0, 1]")
    h, w = hw_shape
    for ws in window_sizes:
        if ws < 1 or h % ws or w % ws:
            raise ValueError(f"dropout_mask: window {ws} on a {h}x{w} grid")
    return [((h // ws) * (w // ws), ws * ws) for ws in window_sizes]


def dropout_mask_plain(seed: int, batch: int, keep: float, window_sizes: Sequence[int], gnum_heads: int, hw_shape,
                       device="cpu") -> List[torch.Tensor]:
    """The keep multipliers (0 or 1/keep) a training core applies for `seed`:
    per group a float32 (batch, gnum_heads, nW, N, N) tensor."""
    out = []
    for g, (nw, n) in enumerate(_geometry(keep, window_sizes, hw_shape)):
        bits = dropout_bits(seed, batch, g, gnum_heads, nw, n, device)  # (batch, nW, heads, N, N)
        out.append(keep_multiplier(bits, keep).permute(0, 2, 1, 3, 4).contiguous())
    return out


def dropout_mask(seed: int, batch: int, keep: float, window_sizes: Sequence[int], gnum_heads: int, hw_shape,
                 device=None) -> List[torch.Tensor]:
    """The masks of `dropout_mask_plain`: drawn by the CUDA kernel on a CUDA
    device (the default), by the plain version with device="cpu".  `seed` is
    a host int in [0, SEED_BOUND) of ops/window_attention_train.py."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dropout_mask_plain(seed, batch, keep, window_sizes, gnum_heads, hw_shape, dev)
    shapes = _geometry(keep, window_sizes, hw_shape)
    sizes = [batch * gnum_heads * nw * n * n for nw, n in shapes]
    flat = torch.empty(sum(sizes), device=dev, dtype=torch.float32)
    h, w = hw_shape
    n_group = len(window_sizes)
    fn = kernels.library("dropout_mask").dropout_mask_forward
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_uint32] * 2
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(kernels.ptr(flat), batch, h, w, n_group, (ctypes.c_int * n_group)(*window_sizes), gnum_heads,
             ctypes.c_uint32(seed & _M32), ctypes.c_uint32(keep_threshold(keep)), ctypes.c_float(np.float32(1.0 / keep)),
             kernels.stream_ptr(dev))
    kernels.check_launch(err, "dropout_mask_forward")
    dropout_mask_counter.launches += 1
    return [t.view(batch, gnum_heads, nw, n, n) for t, (nw, n) in zip(flat.split(sizes), shapes)]
