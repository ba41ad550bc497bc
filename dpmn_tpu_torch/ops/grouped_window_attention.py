"""The eval attention on projected q, k, v over the hand-written kernel K7.

Counterpart of dpmn_tpu/ops/pallas_window.py::fused_grouped_window_attention.
For q, k, v (B, H, W, dim): per channel group (window ws, shift sh) and head,
the -sh roll, the window partition, softmax(scale q k^T + relative bias
[+ shift mask]) v, and the output in the faithful raw layout (the
window-major rows read as raster rows, reference model/pgrm.py:263).  No LN,
no projections, no SKConv, no dropout.

Two io types: float32, and bf16 — q, k, v and the per-group biases in bf16,
the shift masks in float32, every sum in float32 and the result rounded
once to bf16, as the TPU kernel does.  `grouped_window_attention` launches
csrc/grouped_window_attention.cu (the forward attention kernel of K4 at keep
1, templated on the io type; bf16 on bf16 tensor-core products) once a call
for CUDA tensors and runs the plain version `grouped_window_attention_plain`
for CPU tensors.  The kernel has no backward.  The wrapper hands the
kernel the per-group tables as arrays of pointers (nothing is
concatenated) and checks a static geometry once (`_geometry`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import kernels
from . import window_attention_train as WT
from .window_attention_train import window_attention_core_plain

grouped_window_attention_counter = kernels.LaunchCounter()

IO_TYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
             + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_geometries: dict = {}


def grouped_window_attention_plain(q, k, v, biases: Sequence[torch.Tensor], masks: Sequence[Optional[torch.Tensor]],
                                   window_sizes: Sequence[int], shifts: Sequence[int], gnum_heads: int,
                                   scale: float) -> torch.Tensor:
    """Plain PyTorch version: K4's plain version at keep 1 on the float32
    values of q, k, v and the biases, the result cast to q's dtype.  q, k, v
    (B, H, W, dim); `biases` per group (heads, N, N), `masks` per group
    (nW, N, N) or None; returns (B, H, W, dim)."""
    b, h, w, dim = q.shape
    qf, kf, vf = (t.reshape(b, h * w, dim).float() for t in (q, k, v))
    out = window_attention_core_plain(qf, kf, vf, [bb.float() for bb in biases], masks, 0, 1.0, window_sizes,
                                      shifts, gnum_heads, scale, (h, w))
    return out.reshape(b, h, w, dim).to(q.dtype)


def _geometry(window_sizes, shifts, gnum_heads, scale, h, w, dim):
    """(groups, windows and shifts as C int arrays, per group the bias table's
    shape and the mask table's or None): checked once per geometry (raises
    on one the kernel does not take), then kept."""
    key = (window_sizes, shifts, gnum_heads, h, w, dim)
    if key not in _geometries:
        st = WT.make_static((), 0, 1.0, window_sizes, shifts, gnum_heads, scale, (h, w))
        WT.check_geometry("grouped_window_attention", st, h * w, dim)
        n = len(st.window_sizes)
        if len(st.shifts) != n:
            raise ValueError(f"grouped_window_attention: {n} windows and {len(st.shifts)} shifts")
        tables = [((st.gnum_heads, ws * ws, ws * ws), ((h // ws) * (w // ws), ws * ws, ws * ws) if sh > 0 else None)
                  for ws, sh in zip(st.window_sizes, st.shifts)]
        _geometries[key] = (n, (ctypes.c_int * n)(*st.window_sizes), (ctypes.c_int * n)(*st.shifts), tables)
    return _geometries[key]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """A table the kernel reads in 8-byte pairs: itself, or a copy where it
    is not 8-byte aligned (a view into a larger tensor)."""
    return t if t.data_ptr() % 8 == 0 else t.clone()


def grouped_window_attention(q, k, v, biases: Sequence[torch.Tensor], masks: Sequence[Optional[torch.Tensor]],
                             window_sizes: Sequence[int], shifts: Sequence[int], gnum_heads: int,
                             scale: float) -> torch.Tensor:
    """The attention: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  Same signature and result as
    `grouped_window_attention_plain`.  On the card q, k, v and the biases are
    contiguous and of one io type (float32 or bf16), the masks float32, in
    the geometry the training kernels take (ops/window_attention_train.py
    `check_geometry`: head dim 16, windows 2, 4 or 8 dividing the grid).
    It raises on anything else, and if autograd would need a gradient."""
    if q.device.type == "cpu":
        return grouped_window_attention_plain(q, k, v, biases, masks, window_sizes, shifts, gnum_heads, scale)
    if q.dim() != 4:
        raise ValueError(f"grouped_window_attention: expected q of shape (B, H, W, dim), got {tuple(q.shape)}")
    b, h, w, dim = q.shape
    dtype, dev = q.dtype, q.device
    if dtype not in IO_TYPES:
        raise ValueError(f"grouped_window_attention kernel: io type {dtype}, it takes float32 or bfloat16")
    n, ws_arr, sh_arr, tables = _geometry(tuple(window_sizes), tuple(shifts), gnum_heads, scale, h, w, dim)
    for name, t in (("q", q), ("k", k), ("v", v)):
        kernels.check_cuda_tensor(name, t, (b, h, w, dim), dev, dtype)
    if len(biases) != n or len(masks) != n:
        raise ValueError(f"grouped_window_attention: {n} groups, {len(biases)} biases and {len(masks)} masks")
    bias_ptrs, mask_ptrs = (ctypes.c_void_p * n)(), (ctypes.c_void_p * n)()
    held = []  # the tables the kernel reads, copies included, alive until it is launched
    for i, (bias, mask, (bias_shape, mask_shape)) in enumerate(zip(biases, masks, tables)):
        kernels.check_cuda_tensor(f"bias {i}", bias, bias_shape, dev, dtype)
        held.append(_aligned(bias))
        bias_ptrs[i] = held[-1].data_ptr()
        if mask_shape is not None:
            kernels.check_cuda_tensor(f"mask {i}", mask, mask_shape, dev)
            held.append(_aligned(mask))
            mask_ptrs[i] = held[-1].data_ptr()
    kernels.refuse_autograd("grouped_window_attention", (q, k, v, *biases))
    out = torch.empty(b, h, w, dim, device=dev, dtype=dtype)
    fn = kernels.bind("grouped_window_attention", "grouped_window_attention_forward", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptrs, mask_ptrs, out.data_ptr(), b, h, w, dim, n,
             ws_arr, sh_arr, gnum_heads, scale, int(dtype == torch.bfloat16), kernels.stream_ptr(dev))
    kernels.check_launch(err, "grouped_window_attention_forward")
    grouped_window_attention_counter.launches += 1
    return out
