#!/usr/bin/env python3
"""Hold the training core's dropped attention against its own dumped masks.

    python -m dpmn_tpu_torch.tools.debug_train_dropout [--device cpu]

Counterpart of tools/debug_train_dropout.py.  It dumps the attention-dropout
masks of one seed with `dropout_mask` (kernel K9 on the card, its plain
version on the CPU), rebuilds the dropped forward in plain PyTorch with
those masks as explicit factors, and holds `window_attention_core` (kernel
K4 on the card, its plain version on the CPU) against the rebuild: the
forward, and the gradient of sum(tanh(out)) with respect to q.  It prints
the masks' keep fraction and the two max abs differences.  Geometry of the
JAX script: a 16x64 grid, dim 96, windows 2/4/8 shifted by 1/2/4, 2 heads
of 16 per group, keep 0.9, seed 7, batch 4; q, k ~ 0.5 N(0, 1), v ~ N(0, 1),
relative biases 0.1 N(0, 1), from numpy seed 0.  It runs on the card unless
--device cpu is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..models.pgrm import _shift_attn_mask
from ..ops.dropout_mask import dropout_mask
from ..ops.window_attention_core import window_attention_core

H, W, DIM = 16, 64, 96
WINDOWS, SHIFTS = (2, 4, 8), (1, 2, 4)
HEADS = 2
KEEP = 0.9
SEED = 7
SCALE = (DIM // len(WINDOWS) // HEADS) ** -0.5


def inputs(batch: int, device):
    """q, k, v (batch, H, W, DIM), the per-group relative biases (HEADS, N, N)
    and shift masks (nW, N, N), from numpy seed 0."""
    rng = np.random.RandomState(0)
    q = rng.randn(batch, H, W, DIM) * 0.5
    k = rng.randn(batch, H, W, DIM) * 0.5
    v = rng.randn(batch, H, W, DIM)
    biases = [rng.randn(HEADS, ws * ws, ws * ws) * 0.1 for ws in WINDOWS]
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    masks = [as_t(_shift_attn_mask(H, W, ws, sh)) for ws, sh in zip(WINDOWS, SHIFTS)]
    return as_t(q), as_t(k), as_t(v), [as_t(b) for b in biases], masks


def rebuild_with_masks(q, k, v, biases, masks, drop_masks):
    """The dropped forward with explicit keep factors: per group the -sh
    roll, the window partition, softmax(SCALE q k^T + bias + shift mask)
    times the group's (B, heads, nW, N, N) mask, times v; the output in the
    faithful raw layout, (B, H*W, DIM)."""
    b = q.shape[0]
    channel = DIM // len(WINDOWS)
    gch = channel // HEADS
    outs = []
    for g, (ws, sh) in enumerate(zip(WINDOWS, SHIFTS)):
        sl = slice(g * channel, (g + 1) * channel)
        hb, wb, n = H // ws, W // ws, ws * ws

        def part(t):  # (B, H, W, channel) → (B, heads, nW, N, gch)
            t = torch.roll(t[..., sl], (-sh, -sh), dims=(1, 2)).reshape(b, hb, ws, wb, ws, HEADS, gch)
            return t.permute(0, 5, 1, 3, 2, 4, 6).reshape(b, HEADS, hb * wb, n, gch)

        qw, kw, vw = part(q) * SCALE, part(k), part(v)
        scores = qw @ kw.transpose(-1, -2) + biases[g][None, :, None] + masks[g][None, None]
        out = (torch.softmax(scores, dim=-1) * drop_masks[g]) @ vw  # (B, heads, nW, N, gch)
        outs.append(out.permute(0, 2, 3, 1, 4).reshape(b, H * W, channel))
    return torch.cat(outs, dim=-1)


def check(device=None, batch: int = 4) -> dict:
    """Dump the masks of SEED, run the core and the rebuild at KEEP; returns
    the keep fraction, the forward's and the q-gradient's max abs
    differences, and the largest |q-gradient| of the rebuild.  The tests
    pass a smaller batch."""
    dev = resolve_device(device)
    q, k, v, biases, masks = inputs(batch, dev)
    drop = dropout_mask(SEED, batch, KEEP, WINDOWS, HEADS, (H, W), dev)
    kept = sum(int((m > 0).sum()) for m in drop) / sum(m.numel() for m in drop)

    def core(qq):
        return window_attention_core(qq.reshape(batch, H * W, DIM), k.reshape(batch, H * W, DIM),
                                     v.reshape(batch, H * W, DIM), biases, masks, SEED, KEEP, WINDOWS, SHIFTS, HEADS,
                                     SCALE, (H, W))

    results = {}
    for name, fn in (("core", core), ("rebuild", lambda qq: rebuild_with_masks(qq, k, v, biases, masks, drop))):
        leaf = q.clone().requires_grad_()
        out = fn(leaf)
        (grad,) = torch.autograd.grad(torch.tanh(out).sum(), leaf)
        results[name] = (out.detach(), grad)
    (o_core, g_core), (o_ref, g_ref) = results["core"], results["rebuild"]
    return {"keep_fraction": kept, "fwd_max_abs": (o_core - o_ref).abs().max().item(),
            "grad_max_abs": (g_core - g_ref).abs().max().item(), "grad_scale": g_ref.abs().max().item()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help='"cpu" for the plain versions; the card by default')
    args = ap.parse_args(argv)
    r = check(args.device)
    print("mask keep fraction:", r["keep_fraction"])
    print("fwd core vs explicit-mask ref: max abs diff", r["fwd_max_abs"])
    print("grad core vs explicit-mask ref: max abs diff", r["grad_max_abs"], " (ref grad scale", r["grad_scale"], ")")
    return r


if __name__ == "__main__":
    main()
