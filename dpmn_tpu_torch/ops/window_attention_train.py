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

bf16 io (the bf16 AMP train step): the primals bf16 and the biases float32,
as the JAX package passes them (dpmn_tpu/models/pgrm.py:405-407).  The
result and the primals' gradients are bf16, the biases' float32.  Both the
kernels (csrc/window_attention_train.cu `_bf16` entry points, their own
launch counters) and the plain version keep the TPU kernel's rounding points
(dpmn_tpu/ops/pallas_window_train.py): the LN in float32 rounded to bf16,
each projection summed in float32 with its bias and rounded, q * scale in
bf16, scores, softmax and dropout in float32, P rounded before P v and the
output once; in the backward P*M and dS rounded before their products, dq /
dkv rounded before the projection backward (the bias sums take them
unrounded), the parameter gradients summed in float32 and rounded once.  The
plain version computes in float32 on bf16 values, with `_Round` (rounds the
value, passes the gradient) and `_RoundGrad` (passes the value, rounds the
gradient) at those points, so autograd through it gives the kernel's
backward.  q * scale is `scale_q`: JAX multiplies the bf16 q by a Python
float, which it rounds to bf16 first (a weakly typed scalar), so the product
is round_bf16(q * bf16(scale)), while dq = (dS K) * scale takes the float32
scale (:114).  Any scale and any number of heads a group, in the kernels as
in the plain version; the card takes head dims 8, 16 and 32 (`check_geometry`).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernels
from .geometry import check_window_geometry
from .window_attention import _window_partition, layer_norm

forward_counter = kernels.LaunchCounter()
backward_counter = kernels.LaunchCounter()
forward_bf16_counter = kernels.LaunchCounter()
backward_bf16_counter = kernels.LaunchCounter()

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


class _Round(torch.autograd.Function):
    """x rounded to bf16 and widened back (a cast to the io dtype in the
    kernel's forward); the gradient passes unrounded."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """The identity, whose gradient is rounded to bf16 (a cotangent the
    kernel casts to its io dtype before a product)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class _ScaleQ(torch.autograd.Function):
    """bf16 q times the scale as the JAX kernel multiplies them: the scale
    rounded to bf16 (a weakly typed Python float meeting a bf16 array), the
    product exact in float32 and rounded to bf16 once; the gradient times
    the float32 scale, as the kernel's dq = (dS K) * scale."""

    @staticmethod
    def forward(ctx, q, scale: float):
        ctx.scale = scale
        bf16_scale = float(torch.tensor(scale, dtype=torch.float32).to(torch.bfloat16))
        return (q * bf16_scale).to(torch.bfloat16).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        return g * np.float32(ctx.scale), None


def scale_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q (float32 holding bf16 values) times the scale with the bf16 kernels'
    rounding: round_bf16(q * bf16(scale)), the gradient g * float32(scale)."""
    return _ScaleQ.apply(q, scale)


def _identity(x):
    return x


def window_attention_core_plain(q, k, v, biases: Sequence[torch.Tensor], masks: Sequence[Optional[torch.Tensor]],
                                seed: int, keep: float, window_sizes: Sequence[int], shifts: Sequence[int],
                                gnum_heads: int, scale: float, hw_shape) -> torch.Tensor:
    """Plain PyTorch version of the grouped window-attention core on
    projected q, k, v (B, L, dim) — kernel K4's function, and the part of
    K3's after the projections: per group the -sh roll, the window
    partition, per head softmax(scale q k^T + bias [+ mask]) with dropout,
    times v; returns the faithful-layout output (B, L, dim).  `biases` per
    group (heads, N, N), `masks` per group (nW, N, N) or None.  On bf16 q,
    k, v with float32 biases, K4's bf16 form: computed in float32 on their
    values with the bf16 rounding points (`_attention`), the output rounded
    once; autograd's cast back to the bf16 inputs rounds dq, dk and dv."""
    bf16 = check_dtypes((q, k, v), biases, ("q", "k", "v"), "window_attention_core") == torch.bfloat16
    if bf16:
        q, k, v = q.float(), k.float(), v.float()
    out = _attention(q, k, v, biases, masks, seed, keep, window_sizes, shifts, gnum_heads, scale, hw_shape, bf16)
    return out.to(torch.bfloat16) if bf16 else out


def _attention(q, k, v, biases, masks, seed, keep, window_sizes, shifts, gnum_heads, scale, hw_shape,
               bf16: bool) -> torch.Tensor:
    """window_attention_core_plain; with `bf16`, on float32 q, k, v holding
    bf16 values, with the bf16 kernel's rounding points: q * scale as
    `scale_q`, the gradient of the scores' product rounded, P rounded before
    P v."""
    rnd, rnd_grad = (_Round.apply, _RoundGrad.apply) if bf16 else (_identity, _identity)
    times_scale = (lambda t: scale_q(t, scale)) if bf16 else (lambda t: t * scale)
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
        attn = rnd_grad(times_scale(qh) @ kh.transpose(-1, -2)) + biases[g][None]
        if sh > 0:
            attn = (attn.reshape(b, nw, gnum_heads, n, n) + masks[g][None, :, None]).reshape(bw, gnum_heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        if keep < 1.0:
            bits = dropout_bits(seed, b, g, gnum_heads, nw, n, attn.device)
            attn = (attn.reshape(b, nw, gnum_heads, n, n) * keep_multiplier(bits, keep)).reshape(bw, gnum_heads, n, n)
        out = (rnd(attn) @ vh).permute(0, 2, 1, 3).reshape(b, h, w, channel)  # faithful raw layout
        groups.append(out)
    return torch.cat(groups, dim=-1).reshape(b, l, dim)


def window_attention_block_core_plain(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b,
                                      biases: Sequence[torch.Tensor], masks: Sequence[Optional[torch.Tensor]],
                                      seed: int, keep: float, window_sizes: Sequence[int], shifts: Sequence[int],
                                      gnum_heads: int, scale: float, hw_shape) -> torch.Tensor:
    """Plain PyTorch version of the core; returns the faithful-layout
    attention output (B, L, dim) in the io dtype.  Weights in torch layout:
    q_w (dim, c), kv_w (2 dim, c); `biases` per group (heads, N, N), `masks`
    per group (nW, N, N) or None.  bf16 primals take float32 biases and run
    with the bf16 kernel's rounding points (module docstring)."""
    primals = (xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b)
    bf16 = check_dtypes(primals, biases) == torch.bfloat16
    out = block_tokens(primals, biases, masks, seed, keep, window_sizes, shifts, gnum_heads, scale, hw_shape, bf16)
    return out.to(torch.bfloat16) if bf16 else out


def block_tokens(primals, biases, masks, seed, keep, window_sizes, shifts, gnum_heads, scale, hw_shape,
                 bf16: bool) -> torch.Tensor:
    """K3's function on its 10 primals before the output's cast: with
    `bf16`, in float32 on the bf16 values with the bf16 rounding points
    (module docstring) and the attention's tokens left unrounded, as K5's
    bf16 form keeps them."""
    if bf16:
        primals = [t.float() for t in primals]
    xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b = primals
    rnd, rnd_grad = (_Round.apply, _RoundGrad.apply) if bf16 else (_identity, _identity)
    dim = q_w.shape[0]
    q = rnd(rnd_grad(rnd(layer_norm(xq, qs, qb)) @ q_w.T) + q_b)
    kv = rnd(rnd_grad(rnd(layer_norm(xkv, ks, kb)) @ kv_w.T) + kv_b)
    return _attention(q, kv[..., :dim], kv[..., dim:], biases, masks, seed, keep, window_sizes, shifts, gnum_heads,
                      scale, hw_shape, bf16)


def check_dtypes(primals, biases, names=None, what="window_attention_block_core") -> torch.dtype:
    """The io dtype of a training core's call: every primal (named by
    `names`, K3's by default) of one dtype, and the biases float32 for bf16
    primals, else of the primals' dtype.  Raises on anything mixed (the
    kernels cast nothing)."""
    names = names or _PRIMALS
    io = primals[0].dtype
    for name, t in zip(names, primals):
        if t.dtype != io:
            raise TypeError(f"{what}: {name} is {t.dtype}, {names[0]} {io}: mixed primal dtypes")
    want = torch.float32 if io == torch.bfloat16 else io
    for i, bb in enumerate(biases):
        if bb.dtype != want:
            raise TypeError(f"{what}: bias {i} is {bb.dtype}, {io} primals take {want} biases")
    return io


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


def check_geometry(what: str, st: _Static, l: int, dim: int, backward: bool = True) -> None:
    """Raise on a geometry the window-attention kernels do not take
    (ops/geometry.py `check_window_geometry`: D a multiple of 16 up to 96,
    head dims 8, 16 and 32, windows 2, 4 or 8 dividing the grid; with
    `backward`, the attention backward's block within the card)."""
    check_window_geometry(what, st.hw_shape, l, dim, st.window_sizes, st.gnum_heads, backward)


def check_tables(st: _Static, biases, dev, bias_dtype=torch.float32) -> None:
    """Raise unless each group's bias is a CUDA tensor of `bias_dtype` and
    shape (heads, N, N) and, where the group is shifted, its mask a float32
    one of shape (nW, N, N), all contiguous on `dev`."""
    h, w = st.hw_shape
    for i, (ws, sh) in enumerate(zip(st.window_sizes, st.shifts)):
        n = ws * ws
        kernels.check_cuda_tensor(f"bias {i}", biases[i], (st.gnum_heads, n, n), dev, bias_dtype)
        if sh > 0:
            kernels.check_cuda_tensor(f"mask {i}", st.masks[i], ((h // ws) * (w // ws), n, n), dev)


def table_pointers(st: _Static, biases):
    """(biases, masks, ws_arr, sh_arr) as the bf16 forwards' C entry points
    take them: each group's bias and mask pointer (null for an unshifted
    group's mask) and its window and shift, C arrays in group order."""
    n_group = len(st.window_sizes)
    masks = [m.data_ptr() if sh > 0 else None for m, sh in zip(st.masks, st.shifts)]
    return ((ctypes.c_void_p * n_group)(*[bb.data_ptr() for bb in biases]), (ctypes.c_void_p * n_group)(*masks),
            (ctypes.c_int * n_group)(*st.window_sizes), (ctypes.c_int * n_group)(*st.shifts))


def group_tables(st: _Static, biases, dev, bias_dtype=torch.float32):
    """check_tables, then table_pointers: the tables as they are, no copy."""
    check_tables(st, biases, dev, bias_dtype)
    return table_pointers(st, biases)


def pack_tables(st: _Static, biases, dev, bias_dtype=torch.float32):
    """Check the per-group bias (of `bias_dtype`) and float32 mask tables;
    returns (bias, mask, ws_arr, sh_arr): the tables concatenated (masks of
    shifted groups only) and the windows and shifts as C int arrays."""
    check_tables(st, biases, dev, bias_dtype)
    bias = torch.cat([bb.reshape(-1) for bb in biases])
    shifted = [m.reshape(-1) for m, sh in zip(st.masks, st.shifts) if sh > 0]
    mask = torch.cat(shifted) if shifted else torch.zeros(1, device=dev)
    return (bias, mask, *table_pointers(st, biases)[2:])


def split_bias_grad(dbias: torch.Tensor, biases):
    """The concatenated bias gradient as one view per group."""
    out, off = [], 0
    for bb in biases:
        out.append(dbias[off:off + bb.numel()].view(bb.shape))
        off += bb.numel()
    return out


def check_primals(st: _Static, primals, io=torch.float32):
    """Check K3's primals (all of dtype `io`) and the geometry; returns (B,
    H, W, D)."""
    xq = primals[0]
    b, l, dim = xq.shape
    check_geometry("window_attention_train", st, l, dim)
    shapes = {"xq": (b, l, dim), "xkv": (b, l, dim), "qs": (dim,), "qb": (dim,), "ks": (dim,), "kb": (dim,),
              "q_w": (dim, dim), "q_b": (dim,), "kv_w": (2 * dim, dim), "kv_b": (2 * dim,)}
    for name, t in zip(_PRIMALS, primals):
        kernels.check_cuda_tensor(name, t, shapes[name], xq.device, io)
    return (b, *st.hw_shape, dim)


def _prepare(st: _Static, primals, biases, io=torch.float32):
    """check_primals, then the float32 tables concatenated (`pack_tables`):
    (B, H, W, D, bias, mask, ws_arr, sh_arr)."""
    return (*check_primals(st, primals, io), *pack_tables(st, biases, primals[0].device))


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
    if primals[0].dtype == torch.bfloat16:
        return _forward_bf16_cuda(st, primals, biases)
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
    if primals[0].dtype == torch.bfloat16:
        return _backward_bf16_cuda(st, primals, biases, dout)
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


def _forward_bf16_cuda(st: _Static, primals, biases):
    """The bf16 forward, one launch (LN, projections and attention; q and kv
    stay on chip): (out bf16, ())."""
    b, h, w, dim = check_primals(st, primals, torch.bfloat16)
    dev = primals[0].device
    bias, mask, ws_arr, sh_arr = group_tables(st, biases, dev)
    out = torch.empty(b, h * w, dim, device=dev, dtype=torch.bfloat16)
    fn = kernels.bind("window_attention_train", "window_attention_train_forward_bf16", core_argtypes(13))
    err = fn(*[kernels.ptr(t) for t in primals], bias, mask, kernels.ptr(out), b, h, w, dim, len(st.window_sizes),
             ws_arr, sh_arr, st.gnum_heads, float(st.scale), *drop_args(st), kernels.stream_ptr(dev))
    kernels.check_launch(err, "window_attention_train_forward_bf16")
    forward_bf16_counter.launches += 1
    return out, ()


def ln_proj_bf16_cuda(primals):
    """q (B, L, D) and kv (B, L, 2D) in bf16 from K3's bf16 primals by the
    LN + projection kernel alone (what the bf16 backward recomputes); with
    K4's bf16 forward on them, the two-launch composition that
    `_forward_bf16_cuda` equals bit for bit."""
    xq = primals[0]
    b, l, dim = xq.shape
    q = torch.empty(b, l, dim, device=xq.device, dtype=torch.bfloat16)
    kv = torch.empty(b, l, 2 * dim, device=xq.device, dtype=torch.bfloat16)
    fn = kernels.bind("window_attention_train", "window_attention_train_ln_proj_bf16",
                      [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    err = fn(*[kernels.ptr(t) for t in (*primals, q, kv)], b * l, dim, kernels.stream_ptr(xq.device))
    kernels.check_launch(err, "window_attention_train_ln_proj_bf16")
    return q, kv


def _backward_bf16_cuda(st: _Static, primals, biases, dout: torch.Tensor):
    """The bf16 backward: the primals' gradients in bf16, the biases' in
    float32."""
    b, h, w, dim, bias, mask, ws_arr, sh_arr = _prepare(st, primals, biases, torch.bfloat16)
    dev = primals[0].device
    l = h * w
    kernels.check_cuda_tensor("dout", dout, (b, l, dim), dev, torch.bfloat16)
    n_work = kernels.bind("window_attention_train", "window_attention_train_backward_bf16_work",
                          [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int], ctypes.c_size_t)
    work = torch.empty(n_work(b, h, w, dim, len(st.window_sizes), ws_arr, st.gnum_heads), device=dev)
    bf = dict(device=dev, dtype=torch.bfloat16)
    dxq, dxkv = torch.empty(b, l, dim, **bf), torch.empty(b, l, dim, **bf)
    gq, gkv = torch.empty(dim * dim + dim, **bf), torch.empty(2 * dim * dim + 2 * dim, **bf)
    gln_q, gln_kv = torch.empty(2 * dim, **bf), torch.empty(2 * dim, **bf)
    dbias = torch.empty(bias.numel(), device=dev)
    fn = kernels.bind("window_attention_train", "window_attention_train_backward_bf16", core_argtypes(21))
    ptrs = [kernels.ptr(t) for t in (*primals, bias, mask, dout, work, dxq, dxkv, gq, gkv, gln_q, gln_kv, dbias)]
    err = fn(*ptrs, b, h, w, dim, len(st.window_sizes), ws_arr, sh_arr, st.gnum_heads, float(st.scale),
             *drop_args(st), kernels.stream_ptr(dev))
    kernels.check_launch(err, "window_attention_train_backward_bf16")
    backward_bf16_counter.launches += 1
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
    the per-group biases.  The primals all float32 or all bf16 (float32
    biases; module docstring), or float64 on the CPU; mixed dtypes raise.
    `seed` is a host int in [0, SEED_BOUND); with keep = 1 it is not read."""
    check_dtypes((xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b), biases)
    st = make_static(masks, seed, keep, window_sizes, shifts, gnum_heads, scale, hw_shape)
    return KernelCore.apply(_BLOCK, st, xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, *biases)
