#!/usr/bin/env python3
"""The bf16 training cores K3, K4, K5 and the bf16 serving block K1 on the
card: a call's device time, its sub-kernels and its launches.

    python -m dpmn_tpu_torch.tools.bf16_backward_split [--cores block attention full] [--forward] [--tag NAME]
    python -m dpmn_tpu_torch.tools.bf16_backward_split --pair

At B = 64 on the flagship geometry (16x64 grid, dim 96, windows 2/4/8, 6
heads), keep 0.9, for each shift set (none, and 1/2/4): the bf16 backward's
(with --forward, the bf16 forward's) device time a call by CUDA events (20
calls after 3), the float32 kernel on the same values beside it, the
library's own count of kernel launches a call (`<lib>_kernel_launches`,
host-side) and torch.profiler's split of a call by kernel (device ms and
launches).  With --forward also the bf16 forward at keep 1 (no dropout
draw), the float32 forward's split and the host's wall time of a bf16
forward call of the wrapper (its checks, table pointers, allocations and
launches; the device idle before the timed calls), and the core "eval"
(K1's bf16 forward, no dropout) is taken.
Prints one JSON object a core with the times per train step or forward (6
unshifted + 6 shifted calls), the card's name and power limit first, and
the registers and spill bytes of the library's forward kernels that the
build in this process reported (nvcc -Xptxas -v; none where the libraries
were already built).  It reaches the kernels through the wrappers' entry
points alone, so the same file times another tree of the package when run
from that tree's root (PERF.md's parent → change comparisons, in one call:
parent, change, change, parent).

With --pair it times K3's bf16 forward two ways over the same values, keep
0.9, both shift sets: the one launch (`window_block_fwd_bf16_kernel`) and
the two-launch composition of the same tree's kernels (`ln_proj_bf16_cuda`,
ln_proj_bf16_kernel<D, bf16> writing q and kv, then K4's bf16 forward,
window_attn_fwd_train_kernel, on q and kv's halves), in the order one,
composition, composition, one: ms a step by CUDA events and the profiler's
split of each (device ms a step).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import shutil
import subprocess

import torch

B, H, W, DIM = 64, 16, 64, 96
MODULES = {"block": "window_attention_train", "attention": "window_attention_core",
           "full": "window_attention_full", "eval": "window_attention"}


def inputs(core, shift, dev, gen):
    """The core's bf16 primals (K3 its 10, K4 q and the halves of one kv
    tensor, K5 its 18), float32 biases and masks, and its static arguments,
    from one flagship block."""
    from dpmn_tpu_torch.models.pgrm import SwinTransformerBlock
    from dpmn_tpu_torch.system import init_weights

    blk = SwinTransformerBlock(DIM, (H, W), 6, [2, 4, 8], list(shift))
    init_weights(blk, seed=6)
    a = blk.attn
    bf = lambda t: t.detach().to(dev, torch.bfloat16)
    rnd = lambda *shape: 0.1 * torch.randn(*shape, generator=gen)
    if core == "attention":
        kv = bf(torch.randn(B, H * W, 2 * DIM, generator=gen))
        prim = [bf(torch.randn(B, H * W, DIM, generator=gen)), kv[..., :DIM], kv[..., DIM:]]
    else:
        prim = [bf(torch.randn(B, H * W, DIM, generator=gen)), bf(torch.randn(B, H * W, DIM, generator=gen)),
                bf(1 + rnd(DIM)), bf(rnd(DIM)), bf(1 + rnd(DIM)), bf(rnd(DIM)), bf(a.q.weight), bf(rnd(DIM)),
                bf(a.kv.weight), bf(rnd(2 * DIM))]
        if core == "full":
            prim += [bf(t) if t.dim() == 2 else bf(rnd(*t.shape)) for t in a.SKConv.weights()]
    biases = [rnd(*b.shape).to(dev) for b in a.biases()]
    masks = [m.to(dev) if m is not None else None for m in a.masks()]
    return prim, biases, masks, (a.win, a.shf, a.gnum_heads, a.scale, a.hw)


def eval_block(shift, dev, gen):
    """K1's forward on bf16 and on float32 io over the same values: two
    closures of one flagship block (faithful layout)."""
    from dpmn_tpu_torch.models.pgrm import SwinTransformerBlock
    from dpmn_tpu_torch.ops.window_attention import window_attention_block
    from dpmn_tpu_torch.system import init_weights

    blk = SwinTransformerBlock(DIM, (H, W), 6, [2, 4, 8], list(shift))
    init_weights(blk, seed=2)
    kw = blk.to(dev).attn.block_args(blk.ln_params())
    bf = lambda d: None if d is None else {k: t.detach().bfloat16() for k, t in d.items()}
    kw16 = dict(kw, weights=bf(kw["weights"]), ln=bf(kw["ln"]), biases=[b.detach().bfloat16() for b in kw["biases"]])
    kw32 = dict(kw, weights={k: t.float() for k, t in kw16["weights"].items()},
                ln={k: t.float() for k, t in kw16["ln"].items()}, biases=[b.float() for b in kw16["biases"]])
    xq, xkv = (torch.randn(B, H * W, DIM, generator=gen).to(dev).bfloat16() for _ in range(2))
    xq32, xkv32 = xq.float(), xkv.float()
    return (lambda: window_attention_block(xq, xkv, **kw16), lambda: window_attention_block(xq32, xkv32, **kw32))


def event_ms(fn, iters=20, warmup=3):
    with torch.no_grad():
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


def host_ms(fn, iters=100, warmup=3):
    """The host's wall time a call of fn, with the device idle before the
    timed calls."""
    import time

    with torch.no_grad():
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
    return ms


def split(fn, iters=5, warmup=2, attempts=3):
    """{kernel: [device ms, launches]} a call of fn, by torch.profiler over one
    cycle of `iters` runs after `warmup`; a profile with no device event is
    taken again, up to `attempts` times ({} after that)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with torch.no_grad():
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


def launches(lib, fn):
    """Kernels the library `lib` launched in one synchronised call of fn (its
    host-side count; None where the library exports none)."""
    from dpmn_tpu_torch.ops import kernels

    try:
        count = kernels.bind(lib, f"{lib}_kernel_launches", [], ctypes.c_ulonglong)
    except AttributeError:
        return None
    torch.cuda.synchronize()
    before = count()
    with torch.no_grad():
        fn()
    torch.cuda.synchronize()
    return count() - before


def registers(lib):
    """[kernel, registers, spill bytes] of the forward kernels (the attention
    forward, LN + projection, SKConv) in this process's build of `lib`."""
    from dpmn_tpu_torch.ops import kernels

    rows, cur = [], None
    for line in kernels.ptxas_report.get(lib, "").splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            cur = [m.group(1), 0, 0]
            rows.append(cur)
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur[2] = int(m.group(1)) + int(m.group(2))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur[1] = int(m.group(1))
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    names = subprocess.run([tool], input="\n".join(r[0] for r in rows), capture_output=True,
                           text=True).stdout.splitlines() if rows else []
    names = [re.sub(r"\(anonymous namespace\)::|^void |\(.*", "", n) for n in names]
    return [[n, r, sp] for n, (_, r, sp) in zip(names, rows)
            if re.search(r"window_attn_fwd_kernel|ln_proj_bf16_kernel|skconv_(proj|out)_kernel", n)]


def run(core, dev, forward):
    from dpmn_tpu_torch.ops import window_attention_train as wt

    lib = MODULES[core]
    mod = importlib.import_module(f"dpmn_tpu_torch.ops.{lib}")
    gen = torch.Generator().manual_seed(5)
    cot = torch.randn(B, H * W, DIM, generator=gen).to(dev, torch.bfloat16)
    ms = f32 = keep1 = 0.0
    hosts = []
    total, total32, counts = {}, {}, []
    for shift in ((0, 0, 0), (1, 2, 4)):
        if core == "eval":
            call, call32 = eval_block(shift, dev, gen)
        else:
            prim, biases, masks, static = inputs(core, shift, dev, gen)
            st = wt.make_static(masks, 4321, 0.9, *static)
            p32 = [t.float().contiguous() for t in prim]
            if forward:
                st1 = wt.make_static(masks, 4321, 1.0, *static)
                call = lambda st=st, prim=prim, biases=biases: mod._forward_cuda(st, prim, biases)
                call32 = lambda st=st, p32=p32, biases=biases: mod._forward_cuda(st, p32, biases)
                keep1 += 6 * event_ms(lambda: mod._forward_cuda(st1, prim, biases))
                hosts.append(host_ms(call))
            else:
                kept = mod._forward_cuda(st, prim, biases)[1]
                kept32 = mod._forward_cuda(st, p32, biases)[1]
                call = lambda st=st, prim=prim, biases=biases, kept=kept: mod._backward_cuda(st, prim, biases, cot,
                                                                                             kept)
                call32 = lambda st=st, p32=p32, biases=biases, kept32=kept32: mod._backward_cuda(
                    st, p32, biases, cot.float(), kept32)
        ms += 6 * event_ms(call)
        f32 += 6 * event_ms(call32)
        counts.append(launches(lib, call))
        for into, fn in ((total, call), (total32, call32)) if forward or core == "eval" else ((total, call),):
            for name, (t, n) in split(fn).items():
                acc = into.setdefault(name, [0.0, 0.0])
                acc[0] += 6 * t
                acc[1] += n / 2  # launches a call, averaged over the two shift sets
    kind = "forward" if forward or core == "eval" else "backward"
    out = {"core": core, f"bf16_{kind}_ms_per_step": ms, f"float32_{kind}_ms_per_step": f32,
           "kernel_launches_per_call": counts,
           "profiled_launches_per_call": round(sum(n for _, n in total.values()), 3),
           "split_ms_per_step": {k: [round(t, 4), round(n, 3)] for k, (t, n) in
                                 sorted(total.items(), key=lambda kv: -kv[1][0])}}
    if forward and core != "eval":
        out["bf16_forward_keep1_ms_per_step"] = keep1
        out["bf16_forward_host_ms_per_call"] = hosts
    if kind == "forward":
        out["float32_split_ms_per_step"] = {k: [round(t, 4), round(n, 3)] for k, (t, n) in
                                            sorted(total32.items(), key=lambda kv: -kv[1][0])}
        out["registers_spills"] = registers(lib)
    return out


def pair(dev):
    """K3's bf16 forward as one launch and as ln_proj + K4's forward: the
    four readings (one, composition, composition, one) of ms a step by
    events, and each way's split."""
    from dpmn_tpu_torch.ops import window_attention_core as wc
    from dpmn_tpu_torch.ops import window_attention_train as wt

    gen = torch.Generator().manual_seed(5)
    readings, splits = [0.0] * 4, {"one": {}, "composition": {}}
    for shift in ((0, 0, 0), (1, 2, 4)):
        prim, biases, masks, static = inputs("block", shift, dev, gen)
        st = wt.make_static(masks, 4321, 0.9, *static)

        def composition(st=st, prim=prim, biases=biases):
            q, kv = wt.ln_proj_bf16_cuda(prim)
            return wc._forward_cuda(st, [q, kv[..., :DIM], kv[..., DIM:]], biases)

        ways = {"one": lambda st=st, prim=prim, biases=biases: wt._forward_cuda(st, prim, biases),
                "composition": composition}
        for i, way in enumerate(("one", "composition", "composition", "one")):
            readings[i] += 6 * event_ms(ways[way])
        for way, fn in ways.items():
            for name, (t, n) in split(fn).items():
                acc = splits[way].setdefault(name, [0.0, 0.0])
                acc[0] += 6 * t
                acc[1] += n / 2
    return {"core": "pair", "one_ms_per_step": [readings[0], readings[3]],
            "composition_ms_per_step": [readings[1], readings[2]],
            **{f"{way}_split_ms_per_step": {k: [round(t, 4), round(n, 3)] for k, (t, n) in
                                            sorted(d.items(), key=lambda kv: -kv[1][0])}
               for way, d in splits.items()}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cores", nargs="+", default=["block", "full"], choices=sorted(MODULES))
    ap.add_argument("--forward", action="store_true", help="time the bf16 forward instead of the backward")
    ap.add_argument("--tag", default="", help="a label printed with each result (e.g. the tree's name)")
    ap.add_argument("--pair", action="store_true",
                    help="time K3's bf16 forward as one launch against ln_proj + K4's forward (no --cores)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if "eval" in args.cores and not args.forward:
        raise SystemExit("the core 'eval' (K1) has no backward: pass --forward")
    from dpmn_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"tag": args.tag, "build_s": kernels.build_all()}), flush=True)
    dev = torch.device("cuda:0")
    if args.pair:
        print(json.dumps({"tag": args.tag, **pair(dev)}), flush=True)
        return
    for core in args.cores:
        print(json.dumps({"tag": args.tag, **run(core, dev, args.forward)}), flush=True)


if __name__ == "__main__":
    main()
