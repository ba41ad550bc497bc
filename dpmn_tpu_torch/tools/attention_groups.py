#!/usr/bin/env python3
"""Where the one-launch attention forward's time goes, on the card.

    python -m dpmn_tpu_torch.tools.attention_groups [VARIANT ...]

Times kernel K7's entry point `grouped_window_attention` at B = 64 on the
flagship 16x64 grid, float32 and bf16: each window size alone (8, 4, 2; 32
channels, 2 heads, shifted) and the three together (96 channels, shifts
4/2/1), the kernel's device time a launch by torch.profiler beside the
bytes' bound at 3.35 TB/s.  `base` is the package as it is; every other
variant is a copy of the package under `_build/ablation/` with one part of
the attention forward taken out of its source (ABLATIONS), built and timed
in a process of its own.  Those copies compute wrong results: they measure
time only.  With no argument it runs every variant, `base` first and last.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CASES = (((8,), (4,)), ((4,), (2,)), ((2,), (1,)), ((2, 4, 8), (1, 2, 4)))

_QK_BF16 = ("      qk_tile_bf16<NT, p_rounded_once<T, BT>(), HD>(s, Qs + 16 * mi * ldq + hd * HD, ldq, Qs + N * ldq + hd * HD,\n"
            "                                                   ldq, a.scale);\n")
_QK_F32 = "      qk_tile<NT>(s, Qs + 16 * mi * ldq + hd * HD, ldq, Qs + N * ldq + hd * HD, ldq, HD);\n"
_PV_BF16 = "      pv_tile_bf16<NT, p_rounded_once<T, BT>(), HD>(o, s, Qs + 2 * N * ldq + hd * HD, ldv);\n"
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


def ablated_copy(variant: str) -> Path:
    """A copy of the package with the variant's parts taken out; returns the
    directory to run it from."""
    root = PACKAGE / "_build" / "ablation" / variant
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, root / PACKAGE.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name, text, replacement in ABLATIONS[variant]:
        path = root / PACKAGE.name / "csrc" / name
        source = path.read_text()
        if source.count(text) != 1:
            raise RuntimeError(f"ablation {variant}: its text occurs {source.count(text)} times in {name}")
        path.write_text(source.replace(text, replacement))
    return root


def device_ms(fn, iters: int = 10) -> float:
    """The attention forward's device time a launch over `iters` calls of fn
    (torch.profiler; a dropped event is not counted)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and "window_attn_fwd_kernel" in e.name]
    return sum(times) / len(times) / 1e3 if times else float("nan")


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


def main(argv=None) -> None:
    variants = list(argv if argv is not None else sys.argv[1:]) or ["base", *ABLATIONS, "base"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    for variant in variants:
        cwd = PACKAGE.parent if variant == "base" else ablated_copy(variant)
        code = f"from {PACKAGE.name}.tools.attention_groups import measure; measure({variant!r})"
        subprocess.run([sys.executable, "-c", code], cwd=cwd, check=True, timeout=600)


if __name__ == "__main__":
    main()
