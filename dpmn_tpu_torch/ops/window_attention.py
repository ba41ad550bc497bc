"""The eval forward of a PGRM window-attention block over the hand-written kernel.

Counterpart of dpmn_tpu/ops/pallas_window.py::fused_window_attention_block.
`window_attention_block` launches the CUDA kernel csrc/window_attention.cu for
CUDA tensors and runs the plain version `window_attention_block_plain` for CPU
tensors; both compute, from tokens xq, xkv (B, L = H*W, D):
  * LayerNorm norm1_q / norm1_kv (float32 statistics, var = E[x^2] - mean^2
    clamped at 0, eps 1e-6) when `ln` is given;
  * q = xq Wq^T + bq, kv = xkv Wkv^T + bkv;
  * per channel group (window ws, shift sh): the -sh roll, the window
    partition, per head softmax(scale * q k^T + relative bias [+ shift mask])
    v, and the output laid back either faithfully (the window-major rows read
    as raster rows, reference model/pgrm.py:263) or corrected (inverse
    partition and the +sh roll);
  * SKConv (reference model/pgrm.py:62-96) and, with `ln`, the x_kv residual.

Weights are a dict of torch-layout tensors: q_w (D, D), q_b, kv_w (2D, D),
kv_b, proj_w (D, D), proj_b, fc1_w (d, D), fc1_b, fc2_w (G*ch, d), fc2_b,
ph_w (D, ch), ph_b; `ln` holds qs, qb, ks, kb.  `biases` is per group
(heads, N, N) and `masks` per group (nW, N, N) or None.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import kernels


window_attention_counter = kernels.LaunchCounter()

_WEIGHTS = ("q_w", "q_b", "kv_w", "kv_b", "proj_w", "proj_b", "fc1_w", "fc1_b",
            "fc2_w", "fc2_b", "ph_w", "ph_b")
_LN = ("qs", "qb", "ks", "kb")


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6):
    """The JAX package's fused-path LayerNorm (pallas_window.py:191-202)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _window_partition(t: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B*nW, ws*ws, C), row-major window order."""
    b, h, w, c = t.shape
    t = t.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, ws * ws, c)


def _window_reverse(t: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) → (B, H, W, C)."""
    b = t.shape[0] // ((h // ws) * (w // ws))
    t = t.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, h, w, -1)


def skconv(x, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ph_w, ph_b, n_group: int) -> torch.Tensor:
    """SKConv (reference model/pgrm.py:62-96) on (B, L, dim) tokens, the
    concat of n_group channel groups, with torch-layout Linear weights:
    feats = proj(x); the GAP of gelu(feats); a softmax over the groups of
    fc2(gelu(fc1(.))); feats + proj_head(the gated sum of the groups)."""
    b, l, dim = x.shape
    channel = dim // n_group
    feats = F.linear(x, proj_w, proj_b)
    s = F.gelu(feats).mean(dim=1)
    a = F.linear(F.gelu(F.linear(s, fc1_w, fc1_b)), fc2_w, fc2_b).reshape(b, n_group, channel)
    a = torch.softmax(a, dim=1)
    feats_v = torch.einsum("blmc,bmc->blc", x.reshape(b, l, n_group, channel), a)
    return feats + F.linear(feats_v, ph_w, ph_b)


def window_attention_block_plain(xq, xkv, weights: dict, biases: Sequence[torch.Tensor],
                                 masks: Sequence[Optional[torch.Tensor]], window_sizes: Sequence[int],
                                 shifts: Sequence[int], gnum_heads: int, scale: float, hw_shape,
                                 ln: Optional[dict] = None, layout: str = "faithful") -> torch.Tensor:
    """Plain PyTorch version of the block; returns (B, L, D)."""
    b, l, dim = xq.shape
    h, w = hw_shape
    n_group = len(window_sizes)
    channel = dim // n_group
    gch = channel // gnum_heads
    shortcut = xkv
    if ln is not None:
        xq = layer_norm(xq, ln["qs"], ln["qb"])
        xkv = layer_norm(xkv, ln["ks"], ln["kb"])
    q = (xq @ weights["q_w"].T + weights["q_b"]).reshape(b, h, w, dim)
    kv = (xkv @ weights["kv_w"].T + weights["kv_b"]).reshape(b, h, w, 2 * dim)
    k_all, v_all = kv[..., :dim], kv[..., dim:]
    groups = []
    for i, (ws, sh) in enumerate(zip(window_sizes, shifts)):
        sl = slice(i * channel, (i + 1) * channel)
        qg, kg, vg = q[..., sl], k_all[..., sl], v_all[..., sl]
        if sh > 0:
            qg, kg, vg = (torch.roll(t, (-sh, -sh), dims=(1, 2)) for t in (qg, kg, vg))
        n = ws * ws

        def heads(t):
            t = _window_partition(t, ws)
            return t.reshape(t.shape[0], n, gnum_heads, gch).permute(0, 2, 1, 3)

        qh, kh, vh = heads(qg), heads(kg), heads(vg)
        bw = qh.shape[0]
        attn = (qh * scale) @ kh.transpose(-1, -2) + biases[i][None]
        if sh > 0:
            nw = masks[i].shape[0]
            attn = (attn.reshape(bw // nw, nw, gnum_heads, n, n) + masks[i][None, :, None]).reshape(
                bw, gnum_heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ vh).permute(0, 2, 1, 3).reshape(bw, n, channel)
        if layout == "faithful":
            xg = out.reshape(b, h, w, channel)  # raw re-layout (model/pgrm.py:263)
        else:
            xg = _window_reverse(out, ws, h, w)
            if sh > 0:
                xg = torch.roll(xg, (sh, sh), dims=(1, 2))
        groups.append(xg)
    tokens = torch.cat(groups, dim=-1).reshape(b, l, dim)
    out = skconv(tokens, *(weights[k] for k in _WEIGHTS[4:]), n_group)
    return shortcut + out if ln is not None else out


def window_attention_block(xq, xkv, weights: dict, biases, masks, window_sizes, shifts,
                           gnum_heads: int, scale: float, hw_shape, ln: Optional[dict] = None,
                           layout: str = "faithful") -> torch.Tensor:
    """The block: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  Same signature and result as `window_attention_block_plain`.
    The kernel has no backward: on the card it raises if autograd would need
    one (training runs ops/window_attention_train.py instead)."""
    if xq.device.type == "cpu":
        return window_attention_block_plain(xq, xkv, weights, biases, masks, window_sizes, shifts,
                                            gnum_heads, scale, hw_shape, ln, layout)
    if layout not in ("faithful", "corrected"):
        raise ValueError(layout)
    b, l, dim = xq.shape
    h, w = hw_shape
    n_group = len(window_sizes)
    channel = dim // n_group
    gch = channel // gnum_heads
    dz = weights["fc1_w"].shape[0]
    if l != h * w or l % 64 != 0 or dim % 32 != 0 or dim > 96 or channel * n_group != dim:
        raise ValueError(f"window_attention kernel: unsupported geometry L={l} ({h}x{w}) D={dim} groups={n_group}")
    if gch != 16 or gch * gnum_heads != channel:
        raise ValueError(f"window_attention kernel: head dim {channel}/{gnum_heads}, the kernel takes 16")
    for ws in window_sizes:
        if ws not in (2, 4, 8) or h % ws or w % ws:
            raise ValueError(f"window_attention kernel: window {ws} on a {h}x{w} grid")
    dev = xq.device
    kernels.check_cuda_tensor("xq", xq, (b, l, dim), dev)
    kernels.check_cuda_tensor("xkv", xkv, (b, l, dim), dev)
    shapes = {"q_w": (dim, dim), "q_b": (dim,), "kv_w": (2 * dim, dim), "kv_b": (2 * dim,),
              "proj_w": (dim, dim), "proj_b": (dim,), "fc1_w": (dz, dim), "fc1_b": (dz,),
              "fc2_w": (dim, dz), "fc2_b": (dim,), "ph_w": (dim, channel), "ph_b": (dim,)}
    for k in _WEIGHTS:
        kernels.check_cuda_tensor(k, weights[k], shapes[k], dev)
    if ln is not None:
        for k in _LN:
            kernels.check_cuda_tensor(k, ln[k], (dim,), dev)
    bias = torch.cat([bb.reshape(-1) for bb in biases]).contiguous()
    shifted = [m.reshape(-1) for m, sh in zip(masks, shifts) if sh > 0]
    mask = torch.cat(shifted).contiguous() if shifted else bias.new_zeros(1)
    for i, (ws, sh) in enumerate(zip(window_sizes, shifts)):
        n = ws * ws
        if tuple(biases[i].shape) != (gnum_heads, n, n):
            raise ValueError(f"bias {i}: expected {(gnum_heads, n, n)}, got {tuple(biases[i].shape)}")
        if sh > 0 and tuple(masks[i].shape) != ((h // ws) * (w // ws), n, n):
            raise ValueError(f"mask {i}: wrong shape {tuple(masks[i].shape)}")
    kernels.check_cuda_tensor("bias", bias, device=dev)
    kernels.check_cuda_tensor("mask", mask, device=dev)
    kernels.refuse_autograd("window_attention_block",
                            (xq, xkv, *weights.values(), *biases, *(ln.values() if ln is not None else ())))

    def scratch(*shape):
        return torch.empty(*shape, device=dev, dtype=torch.float32)

    qbuf, kvbuf = scratch(b, l, dim), scratch(b, l, 2 * dim)
    attn, feats = scratch(b, l, dim), scratch(b, l, dim)
    partial, gate = scratch(b, l // 64, dim), scratch(b, n_group, channel)
    out = scratch(b, l, dim)
    ws_arr = (ctypes.c_int * n_group)(*window_sizes)
    sh_arr = (ctypes.c_int * n_group)(*shifts)
    null = ctypes.c_void_p(None)
    ln_ptrs = [kernels.ptr(ln[k]) for k in _LN] if ln is not None else [null] * 4

    fn = kernels.bind("window_attention", "window_attention_block_forward",
                      [ctypes.c_void_p] * 27 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    wp = [kernels.ptr(weights[k]) for k in _WEIGHTS]
    err = fn(kernels.ptr(xq), kernels.ptr(xkv), *ln_ptrs, *wp[:4], kernels.ptr(bias), kernels.ptr(mask),
             *wp[4:], kernels.ptr(qbuf), kernels.ptr(kvbuf), kernels.ptr(attn), kernels.ptr(feats),
             kernels.ptr(partial), kernels.ptr(gate), kernels.ptr(out),
             b, h, w, dim, n_group, ws_arr, sh_arr, gnum_heads, dz, float(scale),
             int(layout == "corrected"), kernels.stream_ptr(dev))
    kernels.check_launch(err, "window_attention_block_forward")
    window_attention_counter.launches += 1
    return out
