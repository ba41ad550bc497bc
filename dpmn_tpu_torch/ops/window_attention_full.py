"""The training window attention with SKConv fused in, over the hand-written kernel K5.

Counterpart of dpmn_tpu/ops/pallas_window_train.py::window_attention_full_core,
the core the JAX package runs with DPMN_TPU_FUSE_SKCONV=1 on the faithful
layout (models/pgrm.py train_core "full" here).  `window_attention_full_core`
runs the autograd Function `KernelCore` of ops/window_attention_train.py:
for CUDA tensors its forward and backward launch
csrc/window_attention_full.cu, for CPU tensors they run the plain version
`window_attention_full_core_plain` — K3's plain version
(`window_attention_block_core_plain`: LN, the q / kv projections, the
grouped window attention with dropout, the faithful raw layout) followed by
the functional SKConv of ops/window_attention.py, without the residual.  The
backward saves only its inputs and returns the gradients of xq, xkv, the 16
weights (LN x4, q / kv weights and biases, SKConv's proj, fc1, fc2 and
proj_head weights and biases) and the per-group biases.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import kernels
from . import window_attention_train as WT
from .window_attention import skconv

forward_counter = kernels.LaunchCounter()
backward_counter = kernels.LaunchCounter()

_NAME = "window_attention_full"
_SKCONV = ("proj_w", "proj_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b", "ph_w", "ph_b")


def window_attention_full_core_plain(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, proj_w, proj_b, fc1_w, fc1_b,
                                     fc2_w, fc2_b, ph_w, ph_b, biases: Sequence[torch.Tensor],
                                     masks: Sequence[Optional[torch.Tensor]], seed: int, keep: float,
                                     window_sizes: Sequence[int], shifts: Sequence[int], gnum_heads: int,
                                     scale: float, hw_shape) -> torch.Tensor:
    """Plain PyTorch version: SKConv (no residual) on K3's faithful-layout
    attention output; (B, L, dim).  Weights in torch Linear layout."""
    tokens = WT.window_attention_block_core_plain(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, biases, masks, seed,
                                                  keep, window_sizes, shifts, gnum_heads, scale, hw_shape)
    return skconv(tokens, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ph_w, ph_b, len(window_sizes))


def _prepare(st: WT._Static, primals, biases):
    """Check what the kernels take; returns (B, H, W, D, dz, wt, bias, mask,
    ws_arr, sh_arr) with wt the 16 weights' pointers as a C array."""
    b, h, w, dim, bias, mask, ws_arr, sh_arr = WT._prepare(st, primals[:10], biases)
    dz, ch = primals[12].shape[0], dim // len(st.window_sizes)
    shapes = {"proj_w": (dim, dim), "proj_b": (dim,), "fc1_w": (dz, dim), "fc1_b": (dz,), "fc2_w": (dim, dz),
              "fc2_b": (dim,), "ph_w": (dim, ch), "ph_b": (dim,)}
    for name, t in zip(_SKCONV, primals[10:]):
        kernels.check_cuda_tensor(name, t, shapes[name], primals[0].device)
    wt = (ctypes.c_void_p * 16)(*[t.data_ptr() for t in primals[2:]])
    return b, h, w, dim, dz, wt, bias, mask, ws_arr, sh_arr


def _forward_cuda(st: WT._Static, primals, biases) -> torch.Tensor:
    b, h, w, dim, dz, wt, bias, mask, ws_arr, sh_arr = _prepare(st, primals, biases)
    dev = primals[0].device
    lib = kernels.library(_NAME)
    size = lib.window_attention_full_forward_scratch
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_size_t
    scratch = torch.empty(size(b, h, w, dim), device=dev)
    out = torch.empty(b, h * w, dim, device=dev)
    fn = lib.window_attention_full_forward
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_uint32] * 2
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(kernels.ptr(primals[0]), kernels.ptr(primals[1]), wt, kernels.ptr(bias), kernels.ptr(mask),
             kernels.ptr(scratch), kernels.ptr(out), b, h, w, dim, len(st.window_sizes), ws_arr, sh_arr,
             st.gnum_heads, dz, float(st.scale), *WT.drop_args(st), kernels.stream_ptr(dev))
    kernels.check_launch(err, "window_attention_full_forward")
    forward_counter.launches += 1
    return out


def _backward_cuda(st: WT._Static, primals, biases, dout: torch.Tensor):
    """The 18 primal gradients and the per-group bias gradients."""
    b, h, w, dim, dz, wt, bias, mask, ws_arr, sh_arr = _prepare(st, primals, biases)
    dev = primals[0].device
    kernels.check_cuda_tensor("dout", dout, (b, h * w, dim), dev)
    lib = kernels.library(_NAME)
    size = lib.window_attention_full_backward_scratch
    size.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int] * 2
    size.restype = ctypes.c_size_t
    scratch = torch.empty(size(b, h, w, dim, len(st.window_sizes), ws_arr, st.gnum_heads, dz), device=dev)
    dxq, dxkv = torch.empty(b, h * w, dim, device=dev), torch.empty(b, h * w, dim, device=dev)
    weights = primals[2:]
    gw = torch.empty(sum(t.numel() for t in weights), device=dev)
    dbias = torch.empty(bias.numel(), device=dev)
    fn = lib.window_attention_full_backward
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_uint32] * 2
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(kernels.ptr(primals[0]), kernels.ptr(primals[1]), wt, kernels.ptr(bias), kernels.ptr(mask),
             kernels.ptr(dout), kernels.ptr(scratch), kernels.ptr(dxq), kernels.ptr(dxkv), kernels.ptr(gw),
             kernels.ptr(dbias), b, h, w, dim, len(st.window_sizes), ws_arr, sh_arr, st.gnum_heads, dz,
             float(st.scale), *WT.drop_args(st), kernels.stream_ptr(dev))
    kernels.check_launch(err, "window_attention_full_backward")
    backward_counter.launches += 1
    gws = [g.view(t.shape) for g, t in zip(gw.split([t.numel() for t in weights]), weights)]
    return (dxq, dxkv, *gws, *WT.split_bias_grad(dbias, biases))


_FULL = WT.CoreImpl(18, lambda st, p, b: window_attention_full_core_plain(*p, b, *st.plain_args()), _forward_cuda,
                    _backward_cuda)


def window_attention_full_core(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w,
                               fc2_b, ph_w, ph_b, biases: Sequence[torch.Tensor],
                               masks: Sequence[Optional[torch.Tensor]], seed: int, keep: float,
                               window_sizes: Sequence[int], shifts: Sequence[int], gnum_heads: int, scale: float,
                               hw_shape) -> torch.Tensor:
    """The core with its backward: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors.  Same arguments and result as
    `window_attention_full_core_plain`; gradients flow to the 18 primals and
    the per-group biases.  `seed` is a host int in [0, SEED_BOUND); with
    keep = 1 it is not read."""
    st = WT.make_static(masks, seed, keep, window_sizes, shifts, gnum_heads, scale, hw_shape)
    return WT.KernelCore.apply(_FULL, st, xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, proj_w, proj_b, fc1_w,
                               fc1_b, fc2_w, fc2_b, ph_w, ph_b, *biases)
