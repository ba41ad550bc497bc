"""The training attention core on projected q, k, v over the hand-written kernel K4.

Counterpart of dpmn_tpu/ops/pallas_window_train.py::window_attention_core,
the core the JAX package runs with DPMN_TPU_FUSE_QKV=0 (LN and the q / kv
projections in XLA before it; models/pgrm.py train_core "attention" here).
`window_attention_core` runs the autograd Function `KernelCore` of
ops/window_attention_train.py: for CUDA tensors its forward and backward
launch csrc/window_attention_core.cu, for CPU tensors they run the plain
version `window_attention_core_plain` (shared with K3, whose plain version
runs it after LN and the projections).  For q, k, v (B, L = H*W, dim):
per channel group (window ws, shift sh) the -sh roll, the window partition,
per head P = softmax(scale q k^T + relative bias [+ shift mask]), attention
dropout on P from K3's counter hash of (seed, image, group, head, window,
query, key) — the same draw as K3 for the same seed — and (P*M) v, written
in the faithful raw layout (the window-major rows read as raster rows).
The backward saves only q, k, v and the biases and returns dq, dk, dv and
the per-group bias gradients (heads, N, N).

The JAX kernel takes one packed (n_group, heads, HW/128, 128, 128) bias that
carries the shift masks and a -1e9 wall between windows; the port takes the
per-group biases and masks, as its K3 does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import kernels
from . import window_attention_train as WT
from .window_attention_train import window_attention_core_plain  # noqa: F401  (this core's plain version)

forward_counter = kernels.LaunchCounter()
backward_counter = kernels.LaunchCounter()

_NAME = "window_attention_core"


def _prepare(st: WT._Static, primals, biases):
    """Check what the kernels take; returns (B, H, W, D, bias, mask, ws_arr,
    sh_arr)."""
    q = primals[0]
    b, l, dim = q.shape
    WT.check_geometry(_NAME, st, l, dim)
    for name, t in zip("qkv", primals):
        kernels.check_cuda_tensor(name, t, (b, l, dim), q.device)
    return (b, *st.hw_shape, dim, *WT.pack_tables(st, biases, q.device))


def _forward_cuda(st: WT._Static, primals, biases) -> torch.Tensor:
    b, h, w, dim, bias, mask, ws_arr, sh_arr = _prepare(st, primals, biases)
    dev = primals[0].device
    out = torch.empty(b, h * w, dim, device=dev)
    fn = kernels.library(_NAME).window_attention_core_forward
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_uint32] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(*[kernels.ptr(t) for t in (*primals, bias, mask, out)], b, h, w, dim, len(st.window_sizes), ws_arr,
             sh_arr, st.gnum_heads, float(st.scale), *WT.drop_args(st), kernels.stream_ptr(dev))
    kernels.check_launch(err, "window_attention_core_forward")
    forward_counter.launches += 1
    return out


def _backward_cuda(st: WT._Static, primals, biases, dout: torch.Tensor):
    """dq, dk, dv and the per-group bias gradients."""
    b, h, w, dim, bias, mask, ws_arr, sh_arr = _prepare(st, primals, biases)
    dev = primals[0].device
    kernels.check_cuda_tensor("dout", dout, (b, h * w, dim), dev)
    lib = kernels.library(_NAME)
    dbias_part = torch.empty(WT.scratch_floats(lib.window_attention_core_backward_scratch, b, h, w,
                                               len(st.window_sizes), ws_arr, st.gnum_heads), device=dev)
    dq, dk, dv = (torch.empty(b, h * w, dim, device=dev) for _ in range(3))
    dbias = torch.empty(bias.numel(), device=dev)
    fn = lib.window_attention_core_backward
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_uint32] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(*[kernels.ptr(t) for t in (*primals, bias, mask, dout, dbias_part, dq, dk, dv, dbias)], b, h, w, dim,
             len(st.window_sizes), ws_arr, sh_arr, st.gnum_heads, float(st.scale), *WT.drop_args(st),
             kernels.stream_ptr(dev))
    kernels.check_launch(err, "window_attention_core_backward")
    backward_counter.launches += 1
    return (dq, dk, dv, *WT.split_bias_grad(dbias, biases))


_CORE = WT.CoreImpl(3, lambda st, p, b: window_attention_core_plain(*p, b, *st.plain_args()), _forward_cuda,
                    _backward_cuda)


def window_attention_core(q, k, v, biases: Sequence[torch.Tensor], masks: Sequence[Optional[torch.Tensor]],
                          seed: int, keep: float, window_sizes: Sequence[int], shifts: Sequence[int],
                          gnum_heads: int, scale: float, hw_shape) -> torch.Tensor:
    """The core with its backward: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors.  Same arguments and result as
    `window_attention_core_plain`; q, k, v are contiguous (B, L, dim) tensors
    and gradients flow to them and to the per-group biases.  `seed` is a
    host int in [0, SEED_BOUND); with keep = 1 it is not read."""
    st = WT.make_static(masks, seed, keep, window_sizes, shifts, gnum_heads, scale, hw_shape)
    return WT.KernelCore.apply(_CORE, st, q, k, v, *biases)
