"""The training forward and backward of a PGRM window-attention block core.

Counterpart of dpmn_tpu/ops/pallas_window_train.py::window_attention_block_core.
`window_attention_block_core` is a `torch.autograd.Function`: for CUDA
tensors its forward and backward launch the CUDA kernels of
csrc/window_attention_train.cu, for CPU tensors they run the plain version
`window_attention_block_core_plain` (the backward through autograd on a
recomputed plain forward).  Both compute, from pre-norm tokens xq, xkv
(B, L = H*W, c):
  * LayerNorm norm1_q / norm1_kv (float32 statistics, var = E[x^2] - mean^2
    clamped at 0, eps 1e-6), q = ln(xq) Wq^T + bq, kv = ln(xkv) Wkv^T + bkv;
  * per channel group (window ws, shift sh): the -sh roll, the window
    partition, per head P = softmax(scale q k^T + relative bias [+ shift
    mask]), attention dropout on P (keep with probability `keep`, kept
    entries scaled by 1/keep), (P*M) v;
  * the output in the faithful raw layout (the window-major rows read as
    raster rows, reference model/pgrm.py:263), before SKConv.
The backward saves only the inputs: it recomputes the forward and draws the
same dropout mask again.

The dropout mask comes from a counter-based hash of (seed, image, group,
head, window, query, key) — a murmur3 fmix32 chain — that the kernel and
`dropout_bits` compute identically, so the card can hold kernel against
plain version with dropout on.  The TPU kernel draws from the TPU's own
PRNG, which nothing else reproduces: parity with dpmn_tpu holds at keep = 1.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernels
from .window_attention import _window_partition, layer_norm

forward_counter = kernels.LaunchCounter()
backward_counter = kernels.LaunchCounter()

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
SEED_BOUND = 2**31 - 1  # seeds are drawn from [0, SEED_BOUND)


# ------------------------------------------------------------ dropout bits


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """h * c mod 2^32 for int64 h in [0, 2^32), in 16-bit halves so every
    product stays below 2^48."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _hash_step(h, v) -> torch.Tensor:
    return _fmix32(h ^ ((v + _GOLDEN) & _M32))


def dropout_bits(seed: int, batch: int, group: int, heads: int, n_windows: int, n: int,
                 device=None) -> torch.Tensor:
    """The 32-bit hashes of one group's attention-dropout draws, int64
    (batch, n_windows, heads, N, N): the chain seed → image → group → head →
    window → query → key of csrc/window_common.cuh."""
    def idx(k, axis):
        shape = [1] * 5
        shape[axis] = k
        return torch.arange(k, dtype=torch.int64, device=device).reshape(shape)

    h = torch.tensor(seed & _M32, dtype=torch.int64, device=device)
    h = _hash_step(h, idx(batch, 0))
    h = _hash_step(h, group)
    h = _hash_step(h, idx(heads, 2))
    h = _hash_step(h, idx(n_windows, 1))
    h = _hash_step(h, idx(n, 3))
    return _hash_step(h, idx(n, 4))


def keep_threshold(keep: float) -> int:
    """An entry is kept when the low 31 bits of its hash are below this
    (dpmn_tpu/ops/pallas_window_train.py:_dropout_mask's rule)."""
    return min(int(keep * 2147483648.0), 2147483647)


def keep_multiplier(bits: torch.Tensor, keep: float) -> torch.Tensor:
    """float32 1/keep where `bits` keeps the entry, else 0."""
    inv = torch.tensor(np.float32(1.0 / keep), device=bits.device)
    return torch.where((bits & 0x7FFFFFFF) < keep_threshold(keep), inv, torch.zeros((), device=bits.device))


# ----------------------------------------------------------- plain version


def window_attention_block_core_plain(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b,
                                      biases: Sequence[torch.Tensor], masks: Sequence[Optional[torch.Tensor]],
                                      seed: int, keep: float, window_sizes: Sequence[int], shifts: Sequence[int],
                                      gnum_heads: int, scale: float, hw_shape) -> torch.Tensor:
    """Plain PyTorch version of the core; returns the faithful-layout
    attention output (B, L, dim).  Weights in torch layout: q_w (dim, c),
    kv_w (2 dim, c); `biases` per group (heads, N, N), `masks` per group
    (nW, N, N) or None."""
    b, l, _ = xq.shape
    h, w = hw_shape
    dim = q_w.shape[0]
    n_group = len(window_sizes)
    channel = dim // n_group
    gch = channel // gnum_heads
    q = (layer_norm(xq, qs, qb) @ q_w.T + q_b).reshape(b, h, w, dim)
    kv = (layer_norm(xkv, ks, kb) @ kv_w.T + kv_b).reshape(b, h, w, 2 * dim)
    groups = []
    for g, (ws, sh) in enumerate(zip(window_sizes, shifts)):
        sl = slice(g * channel, (g + 1) * channel)
        qg, kg, vg = q[..., sl], kv[..., sl], kv[..., dim:][..., sl]
        if sh > 0:
            qg, kg, vg = (torch.roll(t, (-sh, -sh), dims=(1, 2)) for t in (qg, kg, vg))
        n = ws * ws

        def heads(t):
            t = _window_partition(t, ws)
            return t.reshape(t.shape[0], n, gnum_heads, gch).permute(0, 2, 1, 3)

        qh, kh, vh = heads(qg), heads(kg), heads(vg)
        bw = qh.shape[0]
        nw = bw // b
        attn = (qh * scale) @ kh.transpose(-1, -2) + biases[g][None]
        if sh > 0:
            attn = (attn.reshape(b, nw, gnum_heads, n, n) + masks[g][None, :, None]).reshape(bw, gnum_heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        if keep < 1.0:
            bits = dropout_bits(seed, b, g, gnum_heads, nw, n, attn.device)
            attn = (attn.reshape(b, nw, gnum_heads, n, n) * keep_multiplier(bits, keep)).reshape(bw, gnum_heads, n, n)
        out = (attn @ vh).permute(0, 2, 1, 3).reshape(b, h, w, channel)  # faithful raw layout
        groups.append(out)
    return torch.cat(groups, dim=-1).reshape(b, l, dim)


def corrected_relayout(out: torch.Tensor, window_sizes: Sequence[int], shifts: Sequence[int],
                       hw_shape) -> torch.Tensor:
    """Undo the faithful raw layout (dpmn_tpu/models/pgrm.py:128-148): per
    group, the inverse window partition and the +shift roll; (B, L, dim)."""
    b, l, dim = out.shape
    h, w = hw_shape
    channel = dim // len(window_sizes)
    groups = []
    for g, (ws, sh) in enumerate(zip(window_sizes, shifts)):
        t = out[..., g * channel:(g + 1) * channel].reshape(b, h // ws, w // ws, ws, ws, channel)
        t = t.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, channel)
        if sh > 0:
            t = torch.roll(t, (sh, sh), dims=(1, 2))
        groups.append(t)
    return torch.cat(groups, dim=-1).reshape(b, l, dim)


# ------------------------------------------------------------ CUDA kernels


class _Static(NamedTuple):
    masks: Tuple[Optional[torch.Tensor], ...]
    window_sizes: Tuple[int, ...]
    shifts: Tuple[int, ...]
    gnum_heads: int
    scale: float
    hw_shape: Tuple[int, int]
    seed: int
    keep: float


_PRIMALS = ("xq", "xkv", "qs", "qb", "ks", "kb", "q_w", "q_b", "kv_w", "kv_b")


def _bwd_chunks(n: int, gnum_heads: int, n_windows: int) -> int:
    """Blocks per image of a group's attention backward (launch_attn_bwd in
    csrc/window_attention_train.cu): windows in batches of wpb, 4 batches a
    block."""
    wpb = max(1, 128 // (n * gnum_heads))
    return -(-n_windows // (4 * wpb))


def _prepare(st: _Static, primals, biases):
    """Check what the kernels take; returns (B, H, W, D, bias, mask, ws_arr,
    sh_arr) with the per-group tables concatenated."""
    xq = primals[0]
    b, l, dim = xq.shape
    h, w = st.hw_shape
    n_group = len(st.window_sizes)
    channel = dim // n_group
    if l != h * w or l % 64 != 0 or dim % 32 != 0 or dim > 96 or channel * n_group != dim:
        raise ValueError(f"window_attention_train kernel: unsupported geometry L={l} ({h}x{w}) D={dim} "
                         f"groups={n_group}")
    if channel != 16 * st.gnum_heads:
        raise ValueError(f"window_attention_train kernel: head dim {channel}/{st.gnum_heads}, the kernel takes 16")
    for ws in st.window_sizes:
        if ws not in (2, 4, 8) or h % ws or w % ws:
            raise ValueError(f"window_attention_train kernel: window {ws} on a {h}x{w} grid")
    dev = xq.device
    shapes = {"xq": (b, l, dim), "xkv": (b, l, dim), "qs": (dim,), "qb": (dim,), "ks": (dim,), "kb": (dim,),
              "q_w": (dim, dim), "q_b": (dim,), "kv_w": (2 * dim, dim), "kv_b": (2 * dim,)}
    for name, t in zip(_PRIMALS, primals):
        kernels.check_f32_cuda(name, t, shapes[name], dev)
    for i, (ws, sh) in enumerate(zip(st.window_sizes, st.shifts)):
        n = ws * ws
        kernels.check_f32_cuda(f"bias {i}", biases[i], (st.gnum_heads, n, n), dev)
        if sh > 0:
            kernels.check_f32_cuda(f"mask {i}", st.masks[i], ((h // ws) * (w // ws), n, n), dev)
    bias = torch.cat([bb.reshape(-1) for bb in biases])
    shifted = [m.reshape(-1) for m, sh in zip(st.masks, st.shifts) if sh > 0]
    mask = torch.cat(shifted) if shifted else bias.new_zeros(1)
    ws_arr = (ctypes.c_int * n_group)(*st.window_sizes)
    sh_arr = (ctypes.c_int * n_group)(*st.shifts)
    return b, h, w, dim, bias, mask, ws_arr, sh_arr


def _drop_args(st: _Static):
    drop = st.keep < 1.0
    return (ctypes.c_uint32(st.seed & _M32), ctypes.c_uint32(keep_threshold(st.keep) if drop else 0),
            ctypes.c_float(np.float32(1.0 / st.keep)), int(drop))


def _forward_cuda(st: _Static, primals, biases) -> torch.Tensor:
    b, h, w, dim, bias, mask, ws_arr, sh_arr = _prepare(st, primals, biases)
    dev = primals[0].device
    l = h * w
    qbuf = torch.empty(b, l, dim, device=dev)
    kvbuf = torch.empty(b, l, 2 * dim, device=dev)
    out = torch.empty(b, l, dim, device=dev)
    fn = kernels.library("window_attention_train").window_attention_train_forward
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_uint32] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ptrs = [kernels.ptr(t) for t in (*primals, bias, mask, qbuf, kvbuf, out)]
    err = fn(*ptrs, b, h, w, dim, len(st.window_sizes), ws_arr, sh_arr, st.gnum_heads, float(st.scale),
             *_drop_args(st), kernels.stream_ptr(dev))
    kernels.check_launch(err, "window_attention_train_forward")
    forward_counter.launches += 1
    return out


def _backward_cuda(st: _Static, primals, biases, dout: torch.Tensor):
    """All 10 primal gradients and the per-group bias gradients."""
    b, h, w, dim, bias, mask, ws_arr, sh_arr = _prepare(st, primals, biases)
    dev = primals[0].device
    l, ntok = h * w, b * h * w
    kernels.check_f32_cuda("dout", dout, (b, l, dim), dev)

    def scratch(*shape):
        return torch.empty(*shape, device=dev)

    n_part = sum(b * _bwd_chunks(ws * ws, st.gnum_heads, (h // ws) * (w // ws)) * st.gnum_heads * (ws * ws) ** 2
                 for ws in st.window_sizes)
    n_chunk = -(-ntok // 512)
    bufs = [scratch(b, l, dim), scratch(b, l, 2 * dim), scratch(b, l, dim), scratch(b, l, 2 * dim),
            scratch(n_part), scratch(n_chunk, dim * dim + dim), scratch(n_chunk, 2 * dim * dim + 2 * dim),
            scratch(ntok // 64, 2 * dim), scratch(ntok // 64, 2 * dim)]
    dxq, dxkv = scratch(b, l, dim), scratch(b, l, dim)
    gq, gkv = scratch(dim * dim + dim), scratch(2 * dim * dim + 2 * dim)
    gln_q, gln_kv = scratch(2 * dim), scratch(2 * dim)
    dbias = scratch(bias.numel())
    fn = kernels.library("window_attention_train").window_attention_train_backward
    fn.argtypes = ([ctypes.c_void_p] * 29 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_uint32] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ptrs = [kernels.ptr(t) for t in (*primals, bias, mask, dout, *bufs, dxq, dxkv, gq, gkv, gln_q, gln_kv, dbias)]
    err = fn(*ptrs, b, h, w, dim, len(st.window_sizes), ws_arr, sh_arr, st.gnum_heads, float(st.scale),
             *_drop_args(st), kernels.stream_ptr(dev))
    kernels.check_launch(err, "window_attention_train_backward")
    backward_counter.launches += 1
    dbiases, off = [], 0
    for bb in biases:
        dbiases.append(dbias[off:off + bb.numel()].view(bb.shape))
        off += bb.numel()
    return (dxq, dxkv, gln_q[:dim], gln_q[dim:], gln_kv[:dim], gln_kv[dim:],
            gq[:dim * dim].view(dim, dim), gq[dim * dim:], gkv[:2 * dim * dim].view(2 * dim, dim),
            gkv[2 * dim * dim:], *dbiases)


class _BlockCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, st: _Static, *tensors):
        ctx.st = st
        ctx.save_for_backward(*tensors)
        primals, biases = tensors[:10], tensors[10:]
        if tensors[0].device.type == "cpu":
            return window_attention_block_core_plain(*primals, list(biases), st.masks, st.seed, st.keep,
                                                     st.window_sizes, st.shifts, st.gnum_heads, st.scale,
                                                     st.hw_shape)
        return _forward_cuda(st, primals, biases)

    @staticmethod
    def backward(ctx, dout):
        st, tensors = ctx.st, ctx.saved_tensors
        if dout.device.type == "cpu":
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in tensors]
                out = window_attention_block_core_plain(*leaves[:10], leaves[10:], st.masks, st.seed, st.keep,
                                                        st.window_sizes, st.shifts, st.gnum_heads, st.scale,
                                                        st.hw_shape)
                grads = torch.autograd.grad(out, leaves, dout)
        else:
            grads = _backward_cuda(st, tensors[:10], tensors[10:], dout.contiguous())
        return (None, *grads)


def window_attention_block_core(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b,
                                biases: Sequence[torch.Tensor], masks: Sequence[Optional[torch.Tensor]],
                                seed: int, keep: float, window_sizes: Sequence[int], shifts: Sequence[int],
                                gnum_heads: int, scale: float, hw_shape) -> torch.Tensor:
    """The core with its backward: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors.  Same arguments and result as
    `window_attention_block_core_plain`; gradients flow to the 10 primals and
    the per-group biases.  `seed` is a host int in [0, SEED_BOUND); with
    keep = 1 it is not read."""
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"keep {keep} outside (0, 1]")
    st = _Static(tuple(masks), tuple(int(v) for v in window_sizes), tuple(int(v) for v in shifts), int(gnum_heads),
                 float(scale), (int(hw_shape[0]), int(hw_shape[1])), int(seed), float(keep))
    return _BlockCore.apply(st, xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, *biases)

