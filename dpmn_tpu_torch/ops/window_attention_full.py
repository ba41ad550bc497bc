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
the functional SKConv of ops/window_attention.py, without the residual.  On
the card the forward also returns what the backward would otherwise
recompute, the attention's tokens and SKConv's per-tile GAP sums and gate,
and `KernelCore` saves them beside the inputs; on the CPU only the inputs
are saved.  The backward returns the gradients of xq, xkv, the 16 weights
(LN x4, q / kv weights and biases, SKConv's proj, fc1, fc2 and proj_head
weights and biases) and the per-group biases.

bf16 io (the bf16 AMP step under "full"): the 18 primals bf16, the biases
float32; the output and the primals' gradients bf16, dbias float32.  The
kernels (csrc/window_attention_full.cu `_bf16` entry points, their own
launch counters) and the plain version keep the TPU kernel's rounding points
(_full_fwd and _full_bwd_impl, dpmn_tpu/ops/pallas_window_train.py:706-973):
K3's bf16 rounding up to P v (LN, q / kv, q * bf16(scale), P), the
attention's tokens float32 and unrounded (its `tok_sc`), SKConv in float32
on them with the weights widened, the output rounded once; in the backward
SKConv's in float32, the tokens' gradient rounded to bf16 before the
attention backward, then K3's bf16 attention and projection backward, the
16 weight gradients summed in float32 and rounded once.  What the forward
keeps for the backward (tokens, GAP sums, gate) is float32.  This is not
K3's bf16 plain version followed by a bf16 SKConv: the plain version runs
`block_tokens` unrounded, SKConv on float32, and rounds the tokens'
gradient (`_RoundGrad`).
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
forward_bf16_counter = kernels.LaunchCounter()
backward_bf16_counter = kernels.LaunchCounter()

_NAME = "window_attention_full"
_SKCONV = ("proj_w", "proj_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b", "ph_w", "ph_b")
_PRIMALS = WT._PRIMALS + _SKCONV


def window_attention_full_core_plain(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, proj_w, proj_b, fc1_w, fc1_b,
                                     fc2_w, fc2_b, ph_w, ph_b, biases: Sequence[torch.Tensor],
                                     masks: Sequence[Optional[torch.Tensor]], seed: int, keep: float,
                                     window_sizes: Sequence[int], shifts: Sequence[int], gnum_heads: int,
                                     scale: float, hw_shape) -> torch.Tensor:
    """Plain PyTorch version: SKConv (no residual) on K3's faithful-layout
    attention output; (B, L, dim).  Weights in torch Linear layout.  bf16
    primals (float32 biases) run K5's bf16 form (module docstring)."""
    primals = (xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ph_w, ph_b)
    bf16 = WT.check_dtypes(primals, biases, _PRIMALS, _NAME) == torch.bfloat16
    tokens = WT.block_tokens(primals[:10], biases, masks, seed, keep, window_sizes, shifts, gnum_heads, scale,
                             hw_shape, bf16)
    if not bf16:
        return skconv(tokens, *primals[10:], len(window_sizes))
    tokens = WT._RoundGrad.apply(tokens)  # dtokens rounded before the attention backward
    return skconv(tokens, *(t.float() for t in primals[10:]), len(window_sizes)).to(torch.bfloat16)


def _check(st: WT._Static, primals):
    """Check the 18 primals (all float32 or all bf16) and the geometry;
    returns (B, H, W, D, dz, wt) with wt the 16 weights' pointers as a C
    array."""
    io = primals[0].dtype
    b, h, w, dim = WT.check_primals(st, primals[:10], io)
    dz, ch = primals[12].shape[0], dim // len(st.window_sizes)
    shapes = {"proj_w": (dim, dim), "proj_b": (dim,), "fc1_w": (dz, dim), "fc1_b": (dz,), "fc2_w": (dim, dz),
              "fc2_b": (dim,), "ph_w": (dim, ch), "ph_b": (dim,)}
    for name, t in zip(_SKCONV, primals[10:]):
        kernels.check_cuda_tensor(name, t, shapes[name], primals[0].device, io)
    wt = (ctypes.c_void_p * 16)(*[t.data_ptr() for t in primals[2:]])
    return b, h, w, dim, dz, wt


def _prepare(st: WT._Static, primals, biases):
    """_check, then the float32 tables concatenated: (B, H, W, D, dz, wt,
    bias, mask, ws_arr, sh_arr)."""
    return (*_check(st, primals), *WT.pack_tables(st, biases, primals[0].device))


def _names(primals):
    """The C entry points and launch counters of the primals' io dtype."""
    if primals[0].dtype == torch.bfloat16:
        return "_bf16", forward_bf16_counter, backward_bf16_counter
    return "", forward_counter, backward_counter


def kept_shapes(b: int, l: int, dim: int):
    """Shapes of what the forward keeps for the backward: the attention's
    tokens (B, L, D), SKConv's GAP sums of gelu(feats) per 64-token tile
    (B * L / 64, D) and its gate (B, D)."""
    return (b, l, dim), (b * l // 64, dim), (b, dim)


def _argtypes(n_ptrs):
    """The argtypes of K5's forward and backward entry points: n_ptrs
    pointers, then the geometry, dz, scale and the dropout arguments."""
    return ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_uint32] * 2
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _forward_cuda(st: WT._Static, primals, biases):
    """(out, kept): SKConv's output and what the backward takes besides the
    inputs (`kept_shapes`)."""
    suffix, counter, _ = _names(primals)
    b, h, w, dim, dz, wt = _check(st, primals)
    dev = primals[0].device
    if suffix:  # the bf16 forward takes each group's table pointers
        bias, mask, ws_arr, sh_arr = WT.group_tables(st, biases, dev)
        tables = (bias, mask)
    else:
        bias, mask, ws_arr, sh_arr = WT.pack_tables(st, biases, dev)
        tables = (kernels.ptr(bias), kernels.ptr(mask))
    size = kernels.bind(_NAME, f"window_attention_full_forward{suffix}_scratch", [ctypes.c_int] * 4,
                        ctypes.c_size_t)
    scratch = torch.empty(size(b, h, w, dim), device=dev)
    out = torch.empty(b, h * w, dim, device=dev, dtype=primals[0].dtype)
    kept = tuple(torch.empty(shape, device=dev) for shape in kept_shapes(b, h * w, dim))
    fn = kernels.bind(_NAME, f"window_attention_full_forward{suffix}", _argtypes(10))
    err = fn(kernels.ptr(primals[0]), kernels.ptr(primals[1]), wt, *tables, kernels.ptr(scratch), kernels.ptr(out),
             *[kernels.ptr(t) for t in kept], b, h, w, dim,
             len(st.window_sizes), ws_arr, sh_arr, st.gnum_heads, dz, float(st.scale), *WT.drop_args(st),
             kernels.stream_ptr(dev))
    kernels.check_launch(err, f"window_attention_full_forward{suffix}")
    counter.launches += 1
    return out, kept


def _backward_cuda(st: WT._Static, primals, biases, dout: torch.Tensor, kept):
    """The 18 primal gradients and the per-group bias gradients, from the
    inputs, what the forward kept and dout."""
    b, h, w, dim, dz, wt, bias, mask, ws_arr, sh_arr = _prepare(st, primals, biases)
    suffix, _, counter = _names(primals)
    dev, io = primals[0].device, primals[0].dtype
    kernels.check_cuda_tensor("dout", dout, (b, h * w, dim), dev, io)
    for name, t, shape in zip(("tok", "partial", "gate"), kept, kept_shapes(b, h * w, dim)):
        kernels.check_cuda_tensor(name, t, shape, dev)
    size = kernels.bind(_NAME, f"window_attention_full_backward{suffix}_scratch",
                        [ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int] * 2, ctypes.c_size_t)
    scratch = torch.empty(size(b, h, w, dim, len(st.window_sizes), ws_arr, st.gnum_heads, dz), device=dev)
    dxq, dxkv = (torch.empty(b, h * w, dim, device=dev, dtype=io) for _ in range(2))
    weights = primals[2:]
    gw = torch.empty(sum(t.numel() for t in weights), device=dev, dtype=io)
    dbias = torch.empty(bias.numel(), device=dev)
    fn = kernels.bind(_NAME, f"window_attention_full_backward{suffix}", _argtypes(14))
    err = fn(kernels.ptr(primals[0]), kernels.ptr(primals[1]), wt, kernels.ptr(bias), kernels.ptr(mask),
             *[kernels.ptr(t) for t in (dout, *kept, scratch, dxq, dxkv, gw, dbias)], b, h, w, dim,
             len(st.window_sizes), ws_arr, sh_arr, st.gnum_heads, dz, float(st.scale), *WT.drop_args(st),
             kernels.stream_ptr(dev))
    kernels.check_launch(err, f"window_attention_full_backward{suffix}")
    counter.launches += 1
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
    the per-group biases.  The primals all float32 or all bf16 (float32
    biases; module docstring), or float64 on the CPU; mixed dtypes raise.
    `seed` is a host int in [0, SEED_BOUND); with keep = 1 it is not read."""
    WT.check_dtypes((xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ph_w,
                     ph_b), biases, _PRIMALS, _NAME)
    st = WT.make_static(masks, seed, keep, window_sizes, shifts, gnum_heads, scale, hw_shape)
    return WT.KernelCore.apply(_FULL, st, xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, proj_w, proj_b, fc1_w,
                               fc1_b, fc2_w, fc2_b, ph_w, ph_b, *biases)
