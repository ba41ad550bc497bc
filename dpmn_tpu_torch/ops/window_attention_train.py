"""The training forward and backward of a PGRM window-attention block core.

Counterpart of dpmn_tpu/ops/pallas_window_train.py::window_attention_block_core.
`window_attention_block_core` runs the autograd Function `KernelCore`: for
CUDA tensors its forward and backward launch the CUDA kernels of
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
same dropout mask again.  The module also holds what the other two training
cores share with this one (ops/window_attention_core.py, kernel K4, and
ops/window_attention_full.py, kernel K5): the attention plain version after
the projections, the dropout hash, the geometry checks and `KernelCore`.

The dropout mask comes from a counter-based hash of (seed, image, group,
head, window, query, key) — a murmur3 fmix32 chain — that the kernel and
`dropout_bits` compute identically, so the card can hold kernel against
plain version with dropout on.  The TPU kernel draws from the TPU's own
PRNG, which nothing else reproduces: parity with dpmn_tpu holds at keep = 1.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

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


def window_attention_core_plain(q, k, v, biases: Sequence[torch.Tensor], masks: Sequence[Optional[torch.Tensor]],
                                seed: int, keep: float, window_sizes: Sequence[int], shifts: Sequence[int],
                                gnum_heads: int, scale: float, hw_shape) -> torch.Tensor:
    """Plain PyTorch version of the grouped window-attention core on
    projected q, k, v (B, L, dim) — kernel K4's function, and the part of
    K3's after the projections: per group the -sh roll, the window
    partition, per head softmax(scale q k^T + bias [+ mask]) with dropout,
    times v; returns the faithful-layout output (B, L, dim).  `biases` per
    group (heads, N, N), `masks` per group (nW, N, N) or None."""
    b, l, dim = q.shape
    h, w = hw_shape
    n_group = len(window_sizes)
    channel = dim // n_group
    gch = channel // gnum_heads
    q, k, v = (t.reshape(b, h, w, dim) for t in (q, k, v))
    groups = []
    for g, (ws, sh) in enumerate(zip(window_sizes, shifts)):
        sl = slice(g * channel, (g + 1) * channel)
        qg, kg, vg = q[..., sl], k[..., sl], v[..., sl]
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


def window_attention_block_core_plain(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b,
                                      biases: Sequence[torch.Tensor], masks: Sequence[Optional[torch.Tensor]],
                                      seed: int, keep: float, window_sizes: Sequence[int], shifts: Sequence[int],
                                      gnum_heads: int, scale: float, hw_shape) -> torch.Tensor:
    """Plain PyTorch version of the core; returns the faithful-layout
    attention output (B, L, dim).  Weights in torch layout: q_w (dim, c),
    kv_w (2 dim, c); `biases` per group (heads, N, N), `masks` per group
    (nW, N, N) or None."""
    dim = q_w.shape[0]
    q = layer_norm(xq, qs, qb) @ q_w.T + q_b
    kv = layer_norm(xkv, ks, kb) @ kv_w.T + kv_b
    return window_attention_core_plain(q, kv[..., :dim], kv[..., dim:], biases, masks, seed, keep, window_sizes,
                                       shifts, gnum_heads, scale, hw_shape)


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

    def plain_args(self):
        """The plain versions' arguments after the biases."""
        return (self.masks, self.seed, self.keep, self.window_sizes, self.shifts, self.gnum_heads, self.scale,
                self.hw_shape)


def make_static(masks, seed, keep, window_sizes, shifts, gnum_heads, scale, hw_shape) -> _Static:
    """The non-tensor arguments of a training core; raises on keep outside (0, 1]."""
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"keep {keep} outside (0, 1]")
    return _Static(tuple(masks), tuple(int(v) for v in window_sizes), tuple(int(v) for v in shifts), int(gnum_heads),
                   float(scale), (int(hw_shape[0]), int(hw_shape[1])), int(seed), float(keep))


_PRIMALS = ("xq", "xkv", "qs", "qb", "ks", "kb", "q_w", "q_b", "kv_w", "kv_b")


def check_geometry(what: str, st: _Static, l: int, dim: int) -> None:
    """Raise on a geometry the training kernels do not take: L = H*W a
    multiple of 64, D a multiple of 32 up to 96, head dim 16, windows 2, 4
    or 8 dividing the grid."""
    h, w = st.hw_shape
    n_group = len(st.window_sizes)
    channel = dim // n_group
    if l != h * w or l % 64 != 0 or dim % 32 != 0 or dim > 96 or channel * n_group != dim:
        raise ValueError(f"{what} kernel: unsupported geometry L={l} ({h}x{w}) D={dim} groups={n_group}")
    if channel != 16 * st.gnum_heads:
        raise ValueError(f"{what} kernel: head dim {channel}/{st.gnum_heads}, the kernel takes 16")
    for ws in st.window_sizes:
        if ws not in (2, 4, 8) or h % ws or w % ws:
            raise ValueError(f"{what} kernel: window {ws} on a {h}x{w} grid")


def pack_tables(st: _Static, biases, dev, bias_dtype=torch.float32):
    """Check the per-group bias (of `bias_dtype`) and float32 mask tables;
    returns (bias, mask, ws_arr, sh_arr): the tables concatenated (masks of
    shifted groups only) and the windows and shifts as C int arrays."""
    h, w = st.hw_shape
    n_group = len(st.window_sizes)
    for i, (ws, sh) in enumerate(zip(st.window_sizes, st.shifts)):
        n = ws * ws
        kernels.check_cuda_tensor(f"bias {i}", biases[i], (st.gnum_heads, n, n), dev, bias_dtype)
        if sh > 0:
            kernels.check_cuda_tensor(f"mask {i}", st.masks[i], ((h // ws) * (w // ws), n, n), dev)
    bias = torch.cat([bb.reshape(-1) for bb in biases])
    shifted = [m.reshape(-1) for m, sh in zip(st.masks, st.shifts) if sh > 0]
    mask = torch.cat(shifted) if shifted else torch.zeros(1, device=dev)
    ws_arr = (ctypes.c_int * n_group)(*st.window_sizes)
    sh_arr = (ctypes.c_int * n_group)(*st.shifts)
    return bias, mask, ws_arr, sh_arr


def split_bias_grad(dbias: torch.Tensor, biases):
    """The concatenated bias gradient as one view per group."""
    out, off = [], 0
    for bb in biases:
        out.append(dbias[off:off + bb.numel()].view(bb.shape))
        off += bb.numel()
    return out


def _prepare(st: _Static, primals, biases):
    """Check what the K3 kernels take; returns (B, H, W, D, bias, mask,
    ws_arr, sh_arr) with the per-group tables concatenated."""
    xq = primals[0]
    b, l, dim = xq.shape
    check_geometry("window_attention_train", st, l, dim)
    dev = xq.device
    shapes = {"xq": (b, l, dim), "xkv": (b, l, dim), "qs": (dim,), "qb": (dim,), "ks": (dim,), "kb": (dim,),
              "q_w": (dim, dim), "q_b": (dim,), "kv_w": (2 * dim, dim), "kv_b": (2 * dim,)}
    for name, t in zip(_PRIMALS, primals):
        kernels.check_cuda_tensor(name, t, shapes[name], dev)
    return (b, *st.hw_shape, dim, *pack_tables(st, biases, dev))


def scratch_floats(name, fn, b, h, w, n_group, ws_arr, gnum_heads) -> int:
    """The floats of an attention backward's dbias_part scratch, from the C
    function `fn` of the library `name` (attn_bwd_part_floats)."""
    size = kernels.bind(name, fn, [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int], ctypes.c_size_t)
    return size(b, h, w, n_group, ws_arr, gnum_heads)


def core_argtypes(n_ptrs):
    """The argtypes of K3's and K4's forward and backward entry points:
    n_ptrs pointers, then the geometry, scale and the dropout arguments."""
    return ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_float]
            + [ctypes.c_uint32] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def drop_args(st: _Static):
    """(seed, thresh, inv_keep, drop) as the C entry points take them."""
    drop = st.keep < 1.0
    return (ctypes.c_uint32(st.seed & _M32), ctypes.c_uint32(keep_threshold(st.keep) if drop else 0),
            ctypes.c_float(np.float32(1.0 / st.keep)), int(drop))


def _forward_cuda(st: _Static, primals, biases):
    """(out, ()): the backward takes the inputs alone."""
    b, h, w, dim, bias, mask, ws_arr, sh_arr = _prepare(st, primals, biases)
    dev = primals[0].device
    l = h * w
    qbuf = torch.empty(b, l, dim, device=dev)
    kvbuf = torch.empty(b, l, 2 * dim, device=dev)
    out = torch.empty(b, l, dim, device=dev)
    fn = kernels.bind("window_attention_train", "window_attention_train_forward", core_argtypes(15))
    ptrs = [kernels.ptr(t) for t in (*primals, bias, mask, qbuf, kvbuf, out)]
    err = fn(*ptrs, b, h, w, dim, len(st.window_sizes), ws_arr, sh_arr, st.gnum_heads, float(st.scale),
             *drop_args(st), kernels.stream_ptr(dev))
    kernels.check_launch(err, "window_attention_train_forward")
    forward_counter.launches += 1
    return out, ()


def _backward_cuda(st: _Static, primals, biases, dout: torch.Tensor, kept=()):
    """All 10 primal gradients and the per-group bias gradients."""
    b, h, w, dim, bias, mask, ws_arr, sh_arr = _prepare(st, primals, biases)
    dev = primals[0].device
    l, ntok = h * w, b * h * w
    kernels.check_cuda_tensor("dout", dout, (b, l, dim), dev)

    def scratch(*shape):
        return torch.empty(*shape, device=dev)

    n_part = scratch_floats("window_attention_train", "window_attention_train_backward_scratch", b, h, w,
                            len(st.window_sizes), ws_arr, st.gnum_heads)
    n_chunk = -(-ntok // 512)
    bufs = [scratch(b, l, dim), scratch(b, l, 2 * dim), scratch(b, l, dim), scratch(b, l, 2 * dim),
            scratch(n_part), scratch(n_chunk, dim * dim + dim), scratch(n_chunk, 2 * dim * dim + 2 * dim),
            scratch(ntok // 64, 2 * dim), scratch(ntok // 64, 2 * dim)]
    dxq, dxkv = scratch(b, l, dim), scratch(b, l, dim)
    gq, gkv = scratch(dim * dim + dim), scratch(2 * dim * dim + 2 * dim)
    gln_q, gln_kv = scratch(2 * dim), scratch(2 * dim)
    dbias = scratch(bias.numel())
    fn = kernels.bind("window_attention_train", "window_attention_train_backward", core_argtypes(29))
    ptrs = [kernels.ptr(t) for t in (*primals, bias, mask, dout, *bufs, dxq, dxkv, gq, gkv, gln_q, gln_kv, dbias)]
    err = fn(*ptrs, b, h, w, dim, len(st.window_sizes), ws_arr, sh_arr, st.gnum_heads, float(st.scale),
             *drop_args(st), kernels.stream_ptr(dev))
    kernels.check_launch(err, "window_attention_train_backward")
    backward_counter.launches += 1
    return (dxq, dxkv, gln_q[:dim], gln_q[dim:], gln_kv[:dim], gln_kv[dim:],
            gq[:dim * dim].view(dim, dim), gq[dim * dim:], gkv[:2 * dim * dim].view(2 * dim, dim),
            gkv[2 * dim * dim:], *split_bias_grad(dbias, biases))


class CoreImpl(NamedTuple):
    """One training core: its number of primal tensors (those before the
    per-group biases), its plain version as plain(st, primals, biases), and
    its kernels as forward_cuda(st, primals, biases) -> (out, kept) and
    backward_cuda(st, primals, biases, dout, kept) -> the primals' and the
    biases' gradients, where kept are the tensors the forward made for the
    backward besides the inputs (K5's tokens and gate; none for K3, K4)."""
    n_primals: int
    plain: Callable
    forward_cuda: Callable
    backward_cuda: Callable


class KernelCore(torch.autograd.Function):
    """A training core with its backward: the kernels for CUDA tensors, the
    plain version for CPU tensors (the backward through autograd on a
    recomputed plain forward).  Saves its inputs and, on the card, what the
    core's forward kept for its backward."""

    @staticmethod
    def forward(ctx, impl: CoreImpl, st: _Static, *tensors):
        ctx.impl, ctx.st, ctx.n_inputs = impl, st, len(tensors)
        primals, biases = tensors[:impl.n_primals], tensors[impl.n_primals:]
        if tensors[0].device.type == "cpu":
            out, kept = impl.plain(st, primals, list(biases)), ()
        else:
            out, kept = impl.forward_cuda(st, primals, biases)
        ctx.save_for_backward(*tensors, *kept)
        return out

    @staticmethod
    def backward(ctx, dout):
        impl, st, saved = ctx.impl, ctx.st, ctx.saved_tensors
        tensors, kept = saved[:ctx.n_inputs], saved[ctx.n_inputs:]
        n = impl.n_primals
        if dout.device.type == "cpu":
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in tensors]
                grads = torch.autograd.grad(impl.plain(st, leaves[:n], leaves[n:]), leaves, dout)
        else:
            grads = impl.backward_cuda(st, tensors[:n], tensors[n:], dout.contiguous(), kept)
        return (None, None, *grads)


_BLOCK = CoreImpl(10, lambda st, p, b: window_attention_block_core_plain(*p, b, *st.plain_args()), _forward_cuda,
                  _backward_cuda)


def window_attention_block_core(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b,
                                biases: Sequence[torch.Tensor], masks: Sequence[Optional[torch.Tensor]],
                                seed: int, keep: float, window_sizes: Sequence[int], shifts: Sequence[int],
                                gnum_heads: int, scale: float, hw_shape) -> torch.Tensor:
    """The core with its backward: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors.  Same arguments and result as
    `window_attention_block_core_plain`; gradients flow to the 10 primals and
    the per-group biases.  `seed` is a host int in [0, SEED_BOUND); with
    keep = 1 it is not read."""
    st = make_static(masks, seed, keep, window_sizes, shifts, gnum_heads, scale, hw_shape)
    return KernelCore.apply(_BLOCK, st, xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, *biases)
