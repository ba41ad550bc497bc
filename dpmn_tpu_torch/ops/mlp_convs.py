"""The faithful PGRM Mlp conv pair over the hand-written kernel K6.

Counterpart of dpmn_tpu/ops/pallas_mlp.py::fused_mlp_convs, whose oracle is
the faithful branch of the JAX package's Mlp (dpmn_tpu/models/pgrm.py:187-215).
Per image, x (HW, hidden) is viewed in C order as (hidden, s, s) with
s = sqrt(HW) (the reference's model/pgrm.py:33-38 quirk); a depthwise 3x3
conv with zero padding and its bias, the exact (erf) GELU, a 1x1 conv (the
channel mix) and its bias; the (hidden, s*s) result read back as
(HW, hidden).  The weights are in the layouts of the port's `Mlp.dwconv`
(hidden, 1, 3, 3) and `Mlp.pwconv` (hidden, hidden, 1, 1).

`mlp_convs_plain` is what the port's `Mlp` runs (cuDNN's convolutions on the
card); `mlp_convs` launches csrc/mlp_convs.cu for CUDA tensors and runs the
plain version for CPU tensors.  The kernel is a standalone op: no path of the
port calls it, as no path of the JAX package calls the TPU kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import kernels

mlp_convs_counter = kernels.LaunchCounter()


def _side(hw: int) -> int:
    s = math.isqrt(hw)
    if s * s != hw:
        raise ValueError(f"mlp_convs: HW = {hw} is not a perfect square")
    return s


def mlp_convs_plain(x: torch.Tensor, dw_weight: torch.Tensor, dw_bias: torch.Tensor, pw_weight: torch.Tensor,
                    pw_bias: torch.Tensor) -> torch.Tensor:
    """x (B, HW, hidden) → (B, HW, hidden): the C-order (hidden, s, s) view,
    depthwise 3x3 + bias, exact GELU, 1x1 + bias, viewed back."""
    b, hw, hidden = x.shape
    s = _side(hw)
    xg = F.conv2d(x.reshape(b, hidden, s, s), dw_weight, dw_bias, padding=1, groups=hidden)
    return F.conv2d(F.gelu(xg), pw_weight, pw_bias).reshape(b, hw, hidden)


def mlp_convs(x: torch.Tensor, dw_weight: torch.Tensor, dw_bias: torch.Tensor, pw_weight: torch.Tensor,
              pw_bias: torch.Tensor) -> torch.Tensor:
    """The conv pair: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  Same signature and result as `mlp_convs_plain`.  On the
    card it takes contiguous float32 tensors with hidden a multiple of 32 and
    HW a perfect square, and raises on anything else; it has no backward and
    raises if autograd would need one."""
    if x.device.type == "cpu":
        return mlp_convs_plain(x, dw_weight, dw_bias, pw_weight, pw_bias)
    if x.dim() != 3:
        raise ValueError(f"mlp_convs: expected x of shape (B, HW, hidden), got {tuple(x.shape)}")
    b, hw, hidden = x.shape
    s = _side(hw)
    if hidden % 32 != 0:
        raise ValueError(f"mlp_convs kernel: hidden {hidden}, it takes a multiple of 32")
    dev = x.device
    kernels.check_cuda_tensor("x", x, (b, hw, hidden), dev)
    kernels.check_cuda_tensor("dw_weight", dw_weight, (hidden, 1, 3, 3), dev)
    kernels.check_cuda_tensor("dw_bias", dw_bias, (hidden,), dev)
    kernels.check_cuda_tensor("pw_weight", pw_weight, (hidden, hidden, 1, 1), dev)
    kernels.check_cuda_tensor("pw_bias", pw_bias, (hidden,), dev)
    kernels.refuse_autograd("mlp_convs", (x, dw_weight, dw_bias, pw_weight, pw_bias))
    g = torch.empty(b, hidden, hw, device=dev, dtype=torch.float32)
    out = torch.empty(b, hw, hidden, device=dev, dtype=torch.float32)
    fn = kernels.library("mlp_convs").mlp_convs_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*[kernels.ptr(t) for t in (x, dw_weight, dw_bias, pw_weight, pw_bias, g, out)], b, s, hidden,
             kernels.stream_ptr(dev))
    kernels.check_launch(err, "mlp_convs_forward")
    mlp_convs_counter.launches += 1
    return out
