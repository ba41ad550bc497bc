"""Bidirectional GRU with torch gate math over the hand-written scan kernel.

Counterpart of dpmn_tpu/ops/gru.py.  The input projection for all time steps
is one matmul per direction outside the kernel (as the JAX package computes
it outside its Pallas kernel, gru.py:84); the recurrence of both directions
runs in one launch of the CUDA kernel csrc/gru_scan.cu (`gru_bidir`, the
counterpart of pallas_bigru), and `gru_scan` runs one direction through the
same kernel.  CUDA tensors launch the kernel; CPU tensors run the plain
versions `gru_scan_plain` / `gru_bidir_plain`.  Gate blocks are ordered
[r; z; n]:
    r = sigmoid(gi_r + gh_r); z = sigmoid(gi_z + gh_z)
    n = tanh(gi_n + r * gh_n); h' = (1 - z) * n + z * h
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn as nn

from . import kernels


gru_scan_counter = kernels.LaunchCounter()
gru_bidir_counter = kernels.LaunchCounter()

SEQ_CHUNK = 64  # sequences per chunk of the kernel's cooperative regime (LNC in csrc/gru_scan.cu)
MAX_HIDDEN = 512  # the largest H of the cooperative regime (LMAX_H in csrc/gru_scan.cu)


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


def gru_bidir_plain(xp_fw: torch.Tensor, xp_bw: torch.Tensor, w_hh_fw: torch.Tensor, w_hh_bw: torch.Tensor,
                    b_hh_fw: torch.Tensor, b_hh_bw: torch.Tensor) -> torch.Tensor:
    """Both directions: (N, T, 2H), the forward scan of xp_fw in [..., :H],
    the reversed scan of xp_bw in [..., H:]."""
    return torch.cat([gru_scan_plain(xp_fw, w_hh_fw, b_hh_fw), gru_scan_plain(xp_bw, w_hh_bw, b_hh_bw, True)], -1)


def _launch(xps, w_hhs, b_hhs, reverse: bool) -> torch.Tensor:
    """One launch of csrc/gru_scan.cu over len(xps) directions.  The inputs
    may be strided along sequences and time (a time stride of 0 broadcasts
    one projection); their gate axis must be contiguous."""
    x = xps[0]
    if x.dim() != 3:
        raise ValueError(f"gru kernel: x_proj must be (N, T, 3H), got {tuple(x.shape)}")
    n, t_len, g = x.shape
    hdim = g // 3
    if g != 3 * hdim or hdim % 32 != 0 or hdim > MAX_HIDDEN:
        raise ValueError(f"gru kernel needs 3H columns with H a multiple of 32 up to {MAX_HIDDEN}, got {g}")
    dev = x.device
    for i, xp in enumerate(xps):
        kernels.check_cuda_tensor(f"x_proj[{i}]", xp, (n, t_len, g), dev, contiguous=False)
        if xp.stride(2) != 1 or xp.stride()[:2] != x.stride()[:2]:
            raise ValueError(f"gru kernel: x_proj needs a contiguous gate axis and one pair of (sequence, step) "
                             f"strides, got {[tuple(v.stride()) for v in xps]}")
    for i, (w, b) in enumerate(zip(w_hhs, b_hhs)):
        kernels.check_cuda_tensor(f"w_hh[{i}]", w, (g, hdim), dev)
        kernels.check_cuda_tensor(f"b_hh[{i}]", b, (g,), dev)
    kernels.refuse_autograd("gru_scan", (*xps, *w_hhs, *b_hhs))
    ndir = len(xps)
    out = torch.empty(n, t_len, ndir * hdim, device=dev, dtype=torch.float32)
    # the cooperative regime's ping-pong h, [2][ndir][H][SEQ_CHUNK]
    hbuf = None if hdim == 32 else torch.empty(2 * ndir * hdim * SEQ_CHUNK, device=dev, dtype=torch.float32)
    fn = kernels.bind("gru_scan", "gru_scan_forward",
                      [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    second = 1 if ndir == 2 else 0
    err = fn(kernels.ptr(xps[0]), kernels.ptr(xps[second]), kernels.ptr(w_hhs[0]), kernels.ptr(w_hhs[second]),
             kernels.ptr(b_hhs[0]), kernels.ptr(b_hhs[second]), kernels.ptr(out),
             ctypes.c_void_p(None if hbuf is None else hbuf.data_ptr()), n, t_len, hdim, ndir, int(reverse),
             x.stride(0), x.stride(1), kernels.stream_ptr(dev))
    kernels.check_launch(err, "gru_scan_forward")
    return out


def gru_scan(x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
             reverse: bool = False) -> torch.Tensor:
    """One direction of the GRU recurrence: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  Same signature and result as
    `gru_scan_plain`.  The kernel has no backward: on the card it raises if
    autograd would need one."""
    if x_proj.device.type == "cpu":
        return gru_scan_plain(x_proj, w_hh, b_hh, reverse)
    out = _launch((x_proj,), (w_hh,), (b_hh,), reverse)
    gru_scan_counter.launches += 1
    return out


def gru_bidir(xp_fw: torch.Tensor, xp_bw: torch.Tensor, w_hh_fw: torch.Tensor, w_hh_bw: torch.Tensor,
              b_hh_fw: torch.Tensor, b_hh_bw: torch.Tensor) -> torch.Tensor:
    """Both directions in one launch of the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; same signature and result as
    `gru_bidir_plain`.  xp_fw and xp_bw (N, T, 3H) may be strided alike along
    N and T (time stride 0: one projection at every step); each direction
    writes its half of the output.  No backward, as `gru_scan`."""
    if xp_fw.device.type == "cpu":
        return gru_bidir_plain(xp_fw, xp_bw, w_hh_fw, w_hh_bw, b_hh_fw, b_hh_bw)
    out = _launch((xp_fw, xp_bw), (w_hh_fw, w_hh_bw), (b_hh_fw, b_hh_bw), False)
    gru_bidir_counter.launches += 1
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
        time steps, projected once and broadcast with a time stride of 0 (the
        faithful gru_encoding)."""
        xps = []
        for sfx in ("l0", "l0_reverse"):
            xp = torch.matmul(x, getattr(self, f"weight_ih_{sfx}").T) + getattr(self, f"bias_ih_{sfx}")
            xps.append(xp if steps is None else xp.expand(-1, steps, -1))
        return gru_bidir(*xps, self.weight_hh_l0, self.weight_hh_l0_reverse, self.bias_hh_l0,
                         self.bias_hh_l0_reverse)
