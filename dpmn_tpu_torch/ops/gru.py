"""Bidirectional GRU with torch gate math over the hand-written scan kernel.

Counterpart of dpmn_tpu/ops/gru.py.  The input projection for all time steps
is one matmul outside the kernel (as the JAX package computes it outside its
Pallas kernel, gru.py:84); the recurrence runs in `gru_scan`, which launches
the CUDA kernel csrc/gru_scan.cu for CUDA tensors and runs the plain version
`gru_scan_plain` for CPU tensors.  Gate blocks are ordered [r; z; n]:
    r = sigmoid(gi_r + gh_r); z = sigmoid(gi_z + gh_z)
    n = tanh(gi_n + r * gh_n); h' = (1 - z) * n + z * h
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn as nn

from . import kernels


gru_scan_counter = kernels.LaunchCounter()


def gru_scan_plain(x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                   reverse: bool = False) -> torch.Tensor:
    """x_proj (N, T, 3H), w_hh (3H, H) torch layout, b_hh (3H,) → (N, T, H)."""
    n, t_len, g = x_proj.shape
    hdim = g // 3
    h = x_proj.new_zeros(n, hdim)
    out = x_proj.new_empty(n, t_len, hdim)
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    for t in steps:
        gi = x_proj[:, t]
        gh = h @ w_hh.T + b_hh
        r = torch.sigmoid(gi[:, :hdim] + gh[:, :hdim])
        z = torch.sigmoid(gi[:, hdim : 2 * hdim] + gh[:, hdim : 2 * hdim])
        nn_ = torch.tanh(gi[:, 2 * hdim :] + r * gh[:, 2 * hdim :])
        h = (1.0 - z) * nn_ + z * h
        out[:, t] = h
    return out


def gru_scan(x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
             reverse: bool = False) -> torch.Tensor:
    """The GRU recurrence: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Same signature and result as `gru_scan_plain`.  The
    kernel has no backward: on the card it raises if autograd would need one."""
    if x_proj.device.type == "cpu":
        return gru_scan_plain(x_proj, w_hh, b_hh, reverse)
    n, t_len, g = x_proj.shape
    hdim = g // 3
    if g != 3 * hdim or hdim % 32 != 0:
        raise ValueError(f"gru_scan kernel needs 3H columns with H a multiple of 32, got {g}")
    dev = x_proj.device
    kernels.check_cuda_tensor("x_proj", x_proj, device=dev)
    kernels.check_cuda_tensor("w_hh", w_hh, (g, hdim), dev)
    kernels.check_cuda_tensor("b_hh", b_hh, (g,), dev)
    kernels.refuse_autograd("gru_scan", (x_proj, w_hh, b_hh))
    out = torch.empty(n, t_len, hdim, device=dev, dtype=torch.float32)
    lib = kernels.library("gru_scan")
    fn = lib.gru_scan_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(kernels.ptr(x_proj), kernels.ptr(w_hh), kernels.ptr(b_hh), kernels.ptr(out),
             n, t_len, hdim, int(reverse), kernels.stream_ptr(dev))
    kernels.check_launch(err, "gru_scan_forward")
    gru_scan_counter.launches += 1
    return out


class BiGRU(nn.Module):
    """Bidirectional single-layer GRU, (N, T, I) → (N, T, 2H), with
    torch.nn.GRU's parameter names and layouts (weight_ih_l0 (3H, I), ...,
    *_reverse), output [forward; backward]."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        g = 3 * hidden_size
        for sfx in ("l0", "l0_reverse"):
            self.register_parameter(f"weight_ih_{sfx}", nn.Parameter(torch.empty(g, input_size)))
            self.register_parameter(f"weight_hh_{sfx}", nn.Parameter(torch.empty(g, hidden_size)))
            self.register_parameter(f"bias_ih_{sfx}", nn.Parameter(torch.empty(g)))
            self.register_parameter(f"bias_hh_{sfx}", nn.Parameter(torch.empty(g)))

    def forward(self, x: torch.Tensor, steps: int = None) -> torch.Tensor:
        """With `steps`, x is (N, 1, I): the same input at each of `steps`
        time steps, projected once and broadcast (the faithful gru_encoding)."""
        outs = []
        for sfx, reverse in (("l0", False), ("l0_reverse", True)):
            xp = torch.matmul(x, getattr(self, f"weight_ih_{sfx}").T) + getattr(self, f"bias_ih_{sfx}")
            if steps is not None:
                xp = xp.expand(-1, steps, -1)
            outs.append(gru_scan(xp.contiguous(), getattr(self, f"weight_hh_{sfx}"),
                                 getattr(self, f"bias_hh_{sfx}"), reverse))
        return torch.cat(outs, dim=-1)
