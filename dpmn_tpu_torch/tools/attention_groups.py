#!/usr/bin/env python3
"""Where the one-launch attention forward's time goes, on the card.

    python -m dpmn_tpu_torch.tools.attention_groups [--train | --block] [VARIANT ...]

Times kernel K7's entry point `grouped_window_attention` at B = 64 on the
flagship 16x64 grid, float32 and bf16: each window size alone (8, 4, 2; 32
channels, 2 heads, shifted) and the three together (96 channels, shifts
4/2/1), the kernel's device time a launch by torch.profiler beside the
bytes' bound at 3.35 TB/s.  With --train it times the training cores' form
instead, K4's bf16 forward (`window_attention_core`'s bf16 entry point: bf16
q and the halves of one kv tensor, float32 bias and mask, bf16 out) at keep
0.9 and 1, unshifted and shifted, each window size alone and the three
together, and prints the forward kernels' registers and spills from the
build; its library is built with the forward entry points alone
(`trim_to_forward`), in every variant alike.  With --block it times K3's
one-launch bf16 forward at the flagship geometry with its parts taken out
(BLOCK_ABLATIONS: the LN or its divisions, the projections, the attention,
the next unit's gather; the image-major work list; 1 CTA an SM), and the
launches' grid sizes.  `base` is the package as it is; every other variant
is a copy of the package under `_build/ablation/` with one part of the
attention forward taken out of its source (ABLATIONS, TRAIN_ABLATIONS or
BLOCK_ABLATIONS), built and timed in a process of its own.  Those copies
compute wrong results: they measure time only (the work-list and CTA
variants excepted).  With no variant it runs every one, `base` first and
last.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CASES = (((8,), (4,)), ((4,), (2,)), ((2,), (1,)), ((2, 4, 8), (1, 2, 4)))

_QK_BF16 = "      qk_tile_bf16<NT, false, HD>(s, Qs + 16 * mi * ldq + hd * HD, ldq, Qs + N * ldq + hd * HD, ldq);\n"
_QK_F32 = "      qk_tile<NT>(s, Qs + 16 * mi * ldq + hd * HD, ldq, Qs + N * ldq + hd * HD, ldq, HD);\n"
_PV_BF16 = "      pv_tile_bf16<NT, false, HD>(o, s, Qs + 2 * N * ldq + hd * HD, ldv);\n"
_PV_F32 = "      pv_tile<NT, CT>(o, s, Qs + 2 * N * ldq + hd * HD, ldv);\n"
_PV_NONE = ("      for (int e = 0; e < 4; ++e) o[0][e] = s[e][e] + s[NT - 1][e], o[CT - 1][e] += s[e + 1][e] * s[2][e];\n")
# variant: [(source under csrc/, text, replacement)], each text found exactly once
ABLATIONS = {
    "stage": [("window_common.cuh",
               "      if (ahead) attn_stage_any<HD>(a, a.grp[sn], next, sm + (buf ^ 1) * a.buf_elems);\n", "")],
    "wait": [("window_common.cuh", "      cp_async_wait(ahead ? 1 : 0);\n", "")],
    "compute": [("window_common.cuh",
                 "      if (gr.ws == 8)\n        attn_step_tc<64, DROP, HD>(a, gr, u - gr.unit0, sm + buf * a.buf_elems);\n"
                 "      else\n        attn_step_tc<16, DROP, HD>(a, gr, u - gr.unit0, sm + buf * a.buf_elems);\n", "")],
    "qk": [("window_common.cuh", _QK_BF16, "      s[0][0] = __bfloat162float(Qs[lane]);\n"),
           ("window_common.cuh", _QK_F32, "      s[0][0] = Qs[lane];\n")],
    "softmax": [("window_common.cuh", "    softmax_rows<true>(s);\n", "")],
    "pv": [("window_common.cuh", _PV_BF16, _PV_NONE), ("window_common.cuh", _PV_F32, _PV_NONE)],
    "bias": [("window_common.cuh", "        float2 add = ldg_pair(bh + off);\n        if (gr.sh > 0) {",
              "        float2 add = make_float2(0.f, 0.f);\n        if (false) {")],
    "store": [("window_common.cuh", "          store4(orow + 8 * c + (odd ? 2 * t4 + 6 : 2 * t4), val, a.vec);",
               "          if (val.x == 12345.f) store4(orow + 8 * c + (odd ? 2 * t4 + 6 : 2 * t4), val, a.vec);")],
    "ctas2": [("window_common.cuh", "__launch_bounds__(THREADS, sizeof(T) == 2 && sizeof(BT) == 2 && HD == 16 ? 3 : 2)",
               "__launch_bounds__(THREADS, 2)")],
}

# The training form's variants (--train), for window_attn_fwd_train_kernel:
# K7's parts of its 64-token steps, the 2x2 steps' table reads too, and its
# two staged steps grown to a ring of 3 or 4
_TRAIN_QK = ("    qk_tile_bf16<NT, true, HD>(s, slot + 16 * mi * ldq + hd * HD, ldq, slot + (STEP + k0) * ldq + hd * HD, ldq,\n"
             "                               a.scale);\n")
_TRAIN_PV = "    pv_tile_bf16<NT, true, HD>(o, s, slot + (2 * STEP + k0) * ldq + hd * HD, ldq);\n"
_TRAIN_TABLES = ("        float2 add = ldg_pair(bh + off);  // the head's bias, then where shifted the window's mask\n"
                 "        if (gr.sh > 0) {\n"
                 "          const float2 mm = __ldg(reinterpret_cast<const float2*>(gr.mask + (int64_t)widx")
_TRAIN4_BIAS = "      acc += __ldg(brow + j);\n"
_TRAIN4_MASK = "      if (gr.sh > 0) acc += __ldg(gr.mask + ((int64_t)widx * 4 + i) * 4 + j);  // the window's mask\n"
TRAIN_ABLATIONS = {
    "stage": [("window_common.cuh", "    if (u < a.n_units) train_stage(a, u, ch, slot(k));\n", "")],
    "wait": [("window_common.cuh", "    cp_async_wait(TRAIN_STAGES - 1);\n", "")],
    "compute": [("window_common.cuh", "    train_step_any<DROP, HD>(a, train_unit(a, u), slot(k));\n", "")],
    "softmax": [("window_common.cuh", "    softmax_rows<true, NT>(s);\n", "")],
    "tables": [("window_common.cuh", _TRAIN_TABLES, _TRAIN_TABLES.replace("ldg_pair(bh + off)", "make_float2(0.f, 0.f)")
                .replace("gr.sh > 0", "false")),
               ("window_common.cuh", _TRAIN4_BIAS, ""), ("window_common.cuh", _TRAIN4_MASK, "")],
    "products": [("window_common.cuh", _TRAIN_QK, "    s[0][0] = __bfloat162float(slot[lane]);\n"),
                 ("window_common.cuh", _TRAIN_PV, _PV_NONE)],
    "store": [("window_common.cuh", "          store4(orow + 8 * c + 2 * t4 + (odd ? 6 : 0), val, a.vec);",
               "          if (val.x == 12345.f) store4(orow + 8 * c + 2 * t4 + (odd ? 6 : 0), val, a.vec);")],
    "ctas3": [("window_common.cuh", "__launch_bounds__(THREADS, 2)\n    window_attn_fwd_train_kernel",
               "__launch_bounds__(THREADS, 3)\n    window_attn_fwd_train_kernel")],
    "stages3": [("window_common.cuh", "constexpr int TRAIN_STAGES = 2;", "constexpr int TRAIN_STAGES = 3;")],
    "stages4": [("window_common.cuh", "constexpr int TRAIN_STAGES = 2;", "constexpr int TRAIN_STAGES = 4;")],
}

TRAIN_LIB = "window_attention_core"
# K3's one-launch bf16 forward (--block): its parts taken out one at a time
BLOCK_LIB = "window_attention_train"
BLOCK_ABLATIONS = {
    "ln": [("window_common.cuh", "      ln_row_quad(xs + (st * STEP + r) * S, true, D, st ? a.ks : a.qs, st ? a.kb : a.qb);\n", "")],
    "ln_div": [("window_common.cuh", "  const float mean = sum / c;\n  const float var = fmaxf(sq / c - mean * mean, 0.f);\n"
                "  const float rstd = 1.0f / sqrtf(var + 1e-6f);",
                "  const float mean = sum * (1.f / 96);\n  const float var = fmaxf(sq * (1.f / 96) - mean * mean, 0.f);\n"
                "  const float rstd = rsqrtf(var + 1e-6f);")],
    "proj": [("window_common.cuh", "    for (int j0 = warp; j0 < ntot; j0 += 16) {",
              "    for (int j0 = warp; j0 < 0; j0 += 16) {")],
    "attn": [("window_common.cuh", "    train_step_any<DROP, HD>(a, t, slot);\n", "")],
    "gather": [("window_common.cuh", "    if (u + gridDim.x < a.n_units) gather(u + gridDim.x);\n", "")],
    "imajor": [("window_common.cuh", "  const int g = u / per_group, r = u - g * per_group, b = r / spi;\n",
                "  const int b = u / (a.n_group * spi), r2 = u - b * a.n_group * spi, g = r2 / spi, r = b * spi + r2 - g * spi;\n")],
    "ctas1": [("window_common.cuh", "__launch_bounds__(THREADS, HD == 32 ? 1 : 2)\n    window_block_fwd_bf16_kernel",
               "__launch_bounds__(THREADS, 1)\n    window_block_fwd_bf16_kernel")],
}


def trim_to_forward(source: str, keep=lambda name: "backward" not in name) -> str:
    """The library source with only the extern "C" functions whose names
    `keep` takes (by default every one but the backwards), so that a variant
    builds the forward alone."""
    out, pos = [], 0
    for m in re.finditer(r'extern "C" [^(]*?(\w+)\(', source):
        if m.start() < pos:
            continue
        depth, i = 0, source.index("{", m.end())
        while True:
            depth += {"{": 1, "}": -1}.get(source[i], 0)
            i += 1
            if depth == 0:
                break
        if not keep(m.group(1)):
            out.append(source[pos:m.start()])
            pos = i
    return "".join(out) + source[pos:]


def ablated_copy(variant: str, mode: str = "") -> Path:
    """A copy of the package with the variant's parts taken out (mode
    "train": TRAIN_ABLATIONS, K4's library trimmed to its forwards;
    "block": BLOCK_ABLATIONS, K3's library to its bf16 forward); returns the
    directory to run it from."""
    root = PACKAGE / "_build" / "ablation" / ((mode + "-" if mode else "") + variant)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, root / PACKAGE.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if mode:
        lib = TRAIN_LIB if mode == "train" else BLOCK_LIB
        keep = (lambda n: "backward" not in n) if mode == "train" else (lambda n: "forward_bf16" in n or "launches" in n)
        path = root / PACKAGE.name / "csrc" / f"{lib}.cu"
        path.write_text(trim_to_forward(path.read_text(), keep))
    edits = {"train": TRAIN_ABLATIONS, "block": BLOCK_ABLATIONS}.get(mode, ABLATIONS)
    for name, text, replacement in edits.get(variant, []):
        path = root / PACKAGE.name / "csrc" / name
        source = path.read_text()
        if source.count(text) != 1:
            raise RuntimeError(f"ablation {variant}: its text occurs {source.count(text)} times in {name}")
        path.write_text(source.replace(text, replacement))
    return root


def device_ms(fn, iters: int = 10, kernel: str = "window_attn_fwd_kernel", grid: bool = False):
    """The device time a launch of the kernels named `kernel` over `iters`
    calls of fn (torch.profiler; a dropped event is not counted); with
    `grid`, (ms, the launches' grid sizes from the profiler's trace)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    ms = sum(times) / len(times) / 1e3 if times else float("nan")
    if not grid:
        return ms
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    events = json.load(open(path)).get("traceEvents", [])
    os.remove(path)
    grids = sorted({tuple(e["args"]["grid"]) for e in events
                    if kernel in e.get("name", "") and "grid" in e.get("args", {})})
    return ms, grids


def measure(variant: str) -> None:
    """Build this package's K7 library and print the variant's times."""
    from ..models.pgrm import WindowAttention
    from ..ops import kernels
    from ..ops.grouped_window_attention import grouped_window_attention

    kernels.SOURCES = ("grouped_window_attention",)  # the one library timed here
    kernels.build_all()
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for windows, shifts in CASES:
            dim = 32 * len(windows)
            attn = WindowAttention(dim, list(windows), list(shifts), 2 * len(windows), (16, 64)).to(dev)
            q, k, v = ((0.5 * torch.randn(64, 16, 64, dim, generator=gen)).to(dev, dtype) for _ in range(3))
            args = ([b.detach().to(dtype) for b in attn.biases()], attn.masks(), attn.win, attn.shf,
                    attn.gnum_heads, attn.scale)
            ms = device_ms(lambda: grouped_window_attention(q, k, v, *args))
            bound = 4 * q.numel() * q.element_size() / 3.35e9
            print(f"{variant} {str(dtype)[6:]} windows={windows}: {ms:.4f} ms a launch (bound {bound:.4f})",
                  flush=True)


def forward_registers(report: str):
    """[kernel, registers, spill bytes] of each attention-forward instance in
    nvcc's -Xptxas -v report (mangled names)."""
    rows, cur = [], None
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            cur = [m.group(1), 0, 0] if "fwd" in m.group(1) else None
            if cur:
                rows.append(cur)
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur[2] = int(m.group(1)) + int(m.group(2))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur[1] = int(m.group(1))
    return rows


def measure_train(variant: str) -> None:
    """Build this package's K4 library and print the variant's times of its
    bf16 forward, the training cores' form."""
    from ..models.pgrm import WindowAttention
    from ..ops import kernels
    from ..ops import window_attention_core as core
    from ..ops import window_attention_train as wt

    kernels.SOURCES = (TRAIN_LIB,)
    kernels.build_all()
    print(json.dumps({"variant": variant, "registers_spills": forward_registers(kernels.ptxas_report.get(TRAIN_LIB, ""))}),
          flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    for windows, shifts in CASES:
        dim = 32 * len(windows)
        for shifted in (False, True):
            attn = WindowAttention(dim, list(windows), list(shifts) if shifted else [0] * len(windows),
                                   2 * len(windows), (16, 64)).to(dev)
            q = (0.5 * torch.randn(64, 16 * 64, dim, generator=gen)).to(dev, torch.bfloat16)
            kv = (0.5 * torch.randn(64, 16 * 64, 2 * dim, generator=gen)).to(dev, torch.bfloat16)
            prim = [q, kv[..., :dim], kv[..., dim:]]
            biases = [b.detach().float() for b in attn.biases()]
            for keep in (0.9, 1.0):
                st = wt.make_static(attn.masks(), 4321, keep, attn.win, attn.shf, attn.gnum_heads, attn.scale, attn.hw)
                ms = device_ms(lambda: core._forward_cuda(st, prim, biases), kernel="fwd")
                bound = 4 * q.numel() * q.element_size() / 3.35e9
                print(f"{variant} train windows={windows} shifted={shifted} keep={keep}: {ms:.4f} ms a launch "
                      f"(bound {bound:.4f})", flush=True)


def measure_block(variant: str) -> None:
    """Build this package's K3 library and print the variant's times of its
    one-launch bf16 forward at the flagship geometry (B = 64, dim 96,
    windows 2 / 4 / 8, 6 heads), unshifted and shifted, keep 0.9 and 1,
    beside its bytes (xq, xkv read once, out written once) and its grid."""
    from ..models.pgrm import SwinTransformerBlock
    from ..ops import kernels
    from ..ops import window_attention_train as wt
    from ..system import init_weights

    kernels.SOURCES = (BLOCK_LIB,)
    kernels.build_all()
    print(json.dumps({"variant": variant, "registers_spills": forward_registers(kernels.ptxas_report.get(BLOCK_LIB, ""))}),
          flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    dim = 96
    for shifts in ((0, 0, 0), (1, 2, 4)):
        blk = SwinTransformerBlock(dim, (16, 64), 6, [2, 4, 8], list(shifts))
        init_weights(blk, seed=6)
        a = blk.attn
        bf = lambda t: t.detach().to(dev, torch.bfloat16)
        rnd = lambda *shape: 0.1 * torch.randn(*shape, generator=gen)
        prim = [bf(torch.randn(64, 1024, dim, generator=gen)), bf(torch.randn(64, 1024, dim, generator=gen)),
                bf(1 + rnd(dim)), bf(rnd(dim)), bf(1 + rnd(dim)), bf(rnd(dim)), bf(a.q.weight), bf(rnd(dim)),
                bf(a.kv.weight), bf(rnd(2 * dim))]
        biases = [rnd(*b.shape).to(dev) for b in a.biases()]
        masks = [m.to(dev) if m is not None else None for m in a.masks()]
        for keep in (0.9, 1.0):
            st = wt.make_static(masks, 4321, keep, a.win, a.shf, a.gnum_heads, a.scale, a.hw)
            ms, grids = device_ms(lambda: wt._forward_cuda(st, prim, biases), kernel="block_fwd", grid=True)
            bound = 3 * prim[0].numel() * 2 / 3.35e9
            print(f"{variant} block shifts={shifts} keep={keep}: {ms:.4f} ms a launch (bound {bound:.4f}; grid "
                  f"{grids})", flush=True)


def main(argv=None) -> None:
    args = list(argv if argv is not None else sys.argv[1:])
    mode = "train" if "--train" in args else "block" if "--block" in args else ""
    ablations = {"train": TRAIN_ABLATIONS, "block": BLOCK_ABLATIONS}.get(mode, ABLATIONS)
    variants = [a for a in args if a not in ("--train", "--block")] or ["base", *ablations, "base"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    for variant in variants:
        cwd = PACKAGE.parent if variant == "base" and not mode else ablated_copy(variant, mode)
        fn = {"train": "measure_train", "block": "measure_block"}.get(mode, "measure")
        code = f"from {PACKAGE.name}.tools.attention_groups import {fn}; {fn}({variant!r})"
        subprocess.run([sys.executable, "-c", code], cwd=cwd, check=True, timeout=600)


if __name__ == "__main__":
    main()
