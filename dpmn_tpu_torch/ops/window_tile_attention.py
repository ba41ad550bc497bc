"""Per-window attention tiles over the hand-written kernel K8.

Counterpart of dpmn_tpu/ops/pallas_kernels.py::pallas_window_attention (body
`_window_attn_kernel`).  For W windows of N tokens with C channels (batch,
windows and heads folded into W by the caller, q already scaled):
    out[w] = softmax(q[w] k[w]^T + bias[w] [+ mask[w]]) v[w]
`window_tile_attention` launches csrc/window_tile_attention.cu for CUDA
tensors and runs the plain version `window_tile_attention_plain` for CPU
tensors.

The JAX function's `tile_w` is dropped: it pads W to a multiple of the TPU
grid's tile of windows and cuts the padding off again, which changes nothing
in the result; the CUDA kernel masks its last block instead.  No PyTorch
call of the port computes this function; `F.scaled_dot_product_attention`
with `attn_mask=bias + mask` and `scale=1` does, and serves as a yardstick
only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import kernels

window_tile_attention_counter = kernels.LaunchCounter()

MAX_N = 64
MAX_C = 64


def window_tile_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v (W, N, C); bias and mask (W, N, N) or mask None → (W, N, C)."""
    scores = q @ k.transpose(-1, -2) + bias
    if mask is not None:
        scores = scores + mask
    return torch.softmax(scores, dim=-1) @ v


def window_tile_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tiles: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  Same signature and result as `window_tile_attention_plain`.  On
    the card it takes contiguous float32 tensors with N <= 64 and C <= 64 and
    raises on anything else; it has no backward and raises if autograd would
    need one."""
    if q.device.type == "cpu":
        return window_tile_attention_plain(q, k, v, bias, mask)
    if q.dim() != 3:
        raise ValueError(f"window_tile_attention: expected q of shape (W, N, C), got {tuple(q.shape)}")
    w, n, c = q.shape
    if not (1 <= n <= MAX_N and 1 <= c <= MAX_C and w >= 1):
        raise ValueError(f"window_tile_attention kernel: N={n}, C={c}; it takes 1 <= N <= {MAX_N}, "
                         f"1 <= C <= {MAX_C}")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        kernels.check_cuda_tensor(name, t, (w, n, c), dev)
    kernels.check_cuda_tensor("bias", bias, (w, n, n), dev)
    if mask is not None:
        kernels.check_cuda_tensor("mask", mask, (w, n, n), dev)
    kernels.refuse_autograd("window_tile_attention", (q, k, v, bias, mask))
    out = torch.empty(w, n, c, device=dev, dtype=torch.float32)
    fn = kernels.bind("window_tile_attention", "window_tile_attention_forward",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    mask_ptr = kernels.ptr(mask) if mask is not None else ctypes.c_void_p(None)
    err = fn(kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(bias), mask_ptr, kernels.ptr(out), w, n, c,
             kernels.stream_ptr(dev))
    kernels.check_launch(err, "window_tile_attention_forward")
    window_tile_attention_counter.launches += 1
    return out
