#!/usr/bin/env python3
"""The bf16 backwards of the training cores K3 and K5 on the card: a call's
device time, its sub-kernels and its launches.

    python -m dpmn_tpu_torch.tools.bf16_backward_split [--cores block full] [--tag NAME]

At B = 64 on the flagship geometry (16x64 grid, dim 96, windows 2/4/8, 6
heads), keep 0.9, for each shift set (none, and 1/2/4): the bf16 backward's
device time a call by CUDA events (20 calls after 3), the float32 backward on
the same values beside it, and torch.profiler's split of a call by kernel
(device ms and launches).  Prints one JSON object a core with the times per
train step (6 unshifted + 6 shifted calls), the card's name and power limit
first.  It reaches the kernels through the wrappers' `_forward_cuda` and
`_backward_cuda` alone, so the same file times another tree of the package
when run from that tree's root (PERF.md's parent → change comparisons, in
one call: parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
import subprocess

import torch

B, H, W, DIM = 64, 16, 64, 96
MODULES = {"block": "window_attention_train", "full": "window_attention_full"}


def inputs(core, shift, dev, gen):
    """The core's bf16 primals (K3 its 10, K5 its 18), float32 biases and
    masks, and its static arguments, from one flagship block."""
    from dpmn_tpu_torch.models.pgrm import SwinTransformerBlock
    from dpmn_tpu_torch.system import init_weights

    blk = SwinTransformerBlock(DIM, (H, W), 6, [2, 4, 8], list(shift))
    init_weights(blk, seed=6)
    a = blk.attn
    bf = lambda t: t.detach().to(dev, torch.bfloat16)
    rnd = lambda *shape: 0.1 * torch.randn(*shape, generator=gen)
    prim = [bf(torch.randn(B, H * W, DIM, generator=gen)), bf(torch.randn(B, H * W, DIM, generator=gen)),
            bf(1 + rnd(DIM)), bf(rnd(DIM)), bf(1 + rnd(DIM)), bf(rnd(DIM)), bf(a.q.weight), bf(rnd(DIM)),
            bf(a.kv.weight), bf(rnd(2 * DIM))]
    if core == "full":
        prim += [bf(t) if t.dim() == 2 else bf(rnd(*t.shape)) for t in a.SKConv.weights()]
    biases = [rnd(*b.shape).to(dev) for b in a.biases()]
    masks = [m.to(dev) if m is not None else None for m in a.masks()]
    return prim, biases, masks, (a.win, a.shf, a.gnum_heads, a.scale, a.hw)


def event_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def split(fn, iters=5, warmup=2, attempts=3):
    """{kernel: [device ms, launches]} a call of fn, by torch.profiler over one
    cycle of `iters` runs after `warmup`; a profile with no device event is
    taken again, up to `attempts` times ({} after that)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        cycle = schedule(wait=0, warmup=warmup, active=iters, repeat=1)
        with profile(activities=[ProfilerActivity.CUDA], schedule=cycle) as prof:
            for _ in range(warmup + iters):
                fn()
                torch.cuda.synchronize()
                prof.step()
        out = {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            m = re.search(r"::(\w+)(<[^()]*>)?\(", e.name)
            name = (m.group(1) + (m.group(2) if m.group(2) and len(m.group(2)) <= 24 else "")) if m else e.name[:60]
            ms, n = out.get(name, (0.0, 0.0))
            out[name] = [ms + e.device_time / 1e3 / iters, n + 1 / iters]
        if out:
            return out
    return {}


def run(core, dev):
    from dpmn_tpu_torch.ops import window_attention_train as wt

    mod = importlib.import_module(f"dpmn_tpu_torch.ops.{MODULES[core]}")
    gen = torch.Generator().manual_seed(5)
    cot = torch.randn(B, H * W, DIM, generator=gen).to(dev, torch.bfloat16)
    ms = f32 = 0.0
    total = {}
    for shift in ((0, 0, 0), (1, 2, 4)):
        prim, biases, masks, static = inputs(core, shift, dev, gen)
        st = wt.make_static(masks, 4321, 0.9, *static)
        p32 = [t.float().contiguous() for t in prim]
        kept = mod._forward_cuda(st, prim, biases)[1]
        kept32 = mod._forward_cuda(st, p32, biases)[1]
        ms += 6 * event_ms(lambda: mod._backward_cuda(st, prim, biases, cot, kept))
        f32 += 6 * event_ms(lambda: mod._backward_cuda(st, p32, biases, cot.float(), kept32))
        for name, (t, n) in split(lambda: mod._backward_cuda(st, prim, biases, cot, kept)).items():
            acc = total.setdefault(name, [0.0, 0.0])
            acc[0] += 6 * t
            acc[1] += n / 2  # launches a call, averaged over the two shift sets
    return {"core": core, "bf16_backward_ms_per_step": ms, "float32_backward_ms_per_step": f32,
            "launches_per_call": round(sum(n for _, n in total.values()), 3),
            "split_ms_per_step": {k: [round(t, 4), round(n, 3)] for k, (t, n) in
                                  sorted(total.items(), key=lambda kv: -kv[1][0])}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cores", nargs="+", default=["block", "full"], choices=sorted(MODULES))
    ap.add_argument("--tag", default="", help="a label printed with each result (e.g. the tree's name)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda:0")
    for core in args.cores:
        print(json.dumps({"tag": args.tag, **run(core, dev)}), flush=True)


if __name__ == "__main__":
    main()
