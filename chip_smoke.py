#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dpmn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, on a machine with a card

Phases, each of which raises (and so exits non-zero) on failure:
  1. setup: the card's name and power limit, torch / CUDA versions, and the
     build of every CUDA kernel under dpmn_tpu_torch/csrc (nvcc, in parallel):
     each kernel's registers and spills (nvcc -Xptxas -v), and for the
     products on the tensor cores (LN + projections, SKConv's two products
     and its backward's two token passes, the projection backward, the
     weight gradient, the attention forward (every group in one launch) and
     the backward of the 4x4 and 8x8 windows and the per-window tiles K8 of
     more than 8 tokens on mma.sync; the Mlp conv pair's mix on wgmma) no
     spill and HMMA or HGMMA instructions in their machine code (cuobjdump
     -sass), and bf16 m16n8k16 products in the bf16 attention forward;
  2. the window-attention kernel against its plain PyTorch version on the
     card at B = 64 and the flagship geometry: both shift sets, both layouts;
     the device time of each of its sub-kernels (torch.profiler) beside the
     sub-kernel's bound, and F.layer_norm + F.linear twice (TF32 off) beside
     the LN + projection kernel as that part's library time;
  3. the GRU-scan kernel K2 against its plain versions at the three
     main-path shapes: both directions in one launch (gru_bidir; the
     gru_encoding input broadcast along time) and each direction alone
     (gru_scan), with torch.nn.GRU(bidirectional=True) (cuDNN) timed beside
     the launch and beside the port's whole BiGRU layer;
  4. the eval path: the flagship DPMNSystem.sr_forward at B = 64 with seeded
     random weights — launch counts of each kernel over one forward, output
     shape and finiteness, images/s; then the same weights on 2 images on the
     CPU (plain versions) against the card;
  4b. the serving modes of the eval forward on the same system: K1 on bf16
     io against its plain version at B = 64 (both shift sets, both layouts;
     its 12 calls' time and sub-kernel split beside their bounds); then
     sr_forward(glyph_from_psn=True), sr_forward with bf16 students and
     sr_forward_bf16 in both glyph modes, each with exact launch counts over
     one forward, images/s and peak memory; the share of the students' ids
     that bf16 keeps, bf16 SR against float32 SR (mean abs < 0.05), PSNR /
     SSIM and the CRNN judge's word agreement between them, and the card
     against the CPU on 2 images for glyph_from_psn=True;
  4c. the judges on the same system: one B = 64 batch of SR through the
     test-mode forward sr_forward(glyph_from_psn=True) (the path that
     test() and every validation pass of dpmn_tpu/train.py take), then each of ASTER,
     MORAN and CRNN (seeded random weights) reads it: its words, images/s
     over timed calls after warm-up (CUDA events) and peak memory; the
     device's busy share of one ASTER predict (torch.profiler; recorded,
     not gated); each judge on the card against the same judge on the CPU
     on 2 images (words equal, ASTER's beam ids equal); no kernel of the
     port launched by any judge;
  5. the training window-attention kernel K3, forward and backward, against
     autograd through its plain version at B = 64 and the flagship geometry:
     both shift sets, both layouts, dropout off and at keep 0.9 from one seed;
     times of kernel and plain version, and the bounds; the sub-kernel split
     of forward and backward as in phase 2;
  6. the train path with train_core "block" (K3): the flagship
     DPMNSystem.train_step at B = 64 (fp32, dropout 0.1) — launch counts over
     one step, finite loss and grad_norm, images/s, ms/step and peak memory;
     then the same weights at rates 0 on 2 images on the CPU against the card
     (loss, grad_norm, every gradient, the students' ids);
  7. K4 (the attention core on projected q, k, v) as phase 5 does K3, with
     F.scaled_dot_product_attention's forward and backward timed beside it
     and the sub-kernel split of its forward and backward (each backward
     group's launch beside its bound) and the host's time a call of its
     wrappers;
     then the train path with train_core "attention", as phase 6;
  8. K5 (K3 with SKConv fused in, faithful layout) as phase 5 does K3, with
     the sub-kernel split of its forward and backward; then the train path
     with train_core "full", as phase 6;
  9. K8, the per-window attention tiles: its entry point once at each of the
     flagship's three folded window shapes at B = 64 (with a shift mask) and
     at the JAX test's (10, 16, 8), launches counted, against the plain
     version, with its device time (torch.profiler);
     F.scaled_dot_product_attention timed beside it (K8 must be faster at
     each flagship shape);
 10. K7, the eval attention on projected q, k, v: its entry point at B = 64
     on both shift sets, float32 then bf16, launches counted, against the
     plain version (bf16 also against the float32 kernel); SDPA on the
     partitioned windows beside it; its device time and launches a call
     (torch.profiler) and the host's time a call of its wrapper;
 11. K6, the faithful Mlp conv pair, at B = 64, hidden 384, s = 32, against
     the plain version; the cuDNN depthwise + GELU + 1x1 pair that the port's
     Mlp runs timed beside it (K6 must be faster); the rate of TF32 work its
     3xTF32 mix reaches, its tensor-core bound and its sub-kernel split;
 12. K9, the dropout-mask dump: the masks of one seed at B = 64 (exactly the
     plain version's) and the port's debug_train_dropout tool at its own
     geometry on the card (K4's forward and q-gradient against the rebuild
     from the dumped masks, within K3's tolerances), launches counted; its
     device time and launches a call and the host's time a call;
 13. one JSON line with every kernel's numbers, then the final JSON line.

Times are CUDA-event times after warm-up, with the inputs resident in L2
where they fit.  `ms`, `plain_ms`, `library_ms` and `bound_ms` in the kernels
line are per call of the path that launches the kernel: K1 and K2 per
flagship forward (the sum over their launches in one sr_forward at B = 64),
K3, K4 and K5 per flagship train step on their path (12 forward and 12
backward launches); the standalone kernels K6-K9 per run of their phase's
path (the launches it counts).  Bounds use the published H100 SXM peaks:
3.35 TB/s and 67 TFLOP/s float32 on the CUDA cores; a sub-kernel's bound
counts a product it runs on the tensor cores as 3xTF32 at 3 x its operations
over 495 TFLOP/s.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12  # dense, on the tensor cores
BF16_FLOP_PER_S = 989e12  # dense, on the tensor cores
# the sub-kernels whose products run on the tensor cores (3xTF32, or bf16
# for K1's bf16 LN + projection): mma.sync (HMMA in their machine code),
# K6's on wgmma (HGMMA)
TC_KERNELS = ("ln_proj_kernel", "ln_proj_bf16_kernel", "skconv_proj_kernel", "skconv_out_kernel", "proj_ln_bwd_kernel", "wgrad_kernel",
              "window_attn_bwd_tc_kernel", "skconv_bwd_a_kernel", "skconv_bwd_b_kernel", "mlp_convs_kernel",
              "window_attn_fwd_kernel", "tile_attn_tc_kernel")
B = 64
K1_TOL = 1e-4  # max abs error: float32, other summation orders over <= 96-term sums
K2_TOL = 1e-5  # max abs error of a tanh-bounded state after <= 64 float32 steps
K3_TOL = 1e-4  # forward max abs error: as K1
K3_GRAD_RTOL, K3_GRAD_ATOL = 1e-4, 1e-5  # per gradient: max abs <= rtol * max|ref| + atol (sums over 65536 tokens)
# K4 and K5 are held as K3: forward max abs K3_TOL, each gradient as above
K6_TOL = 1e-4  # max abs error: float32 sums of 9 and 384 terms in other orders
K7_TOL = 1e-4  # float32 max abs error, as K1; bf16: one bf16 rounding of max|out| (2^-7 of it)
BF16_ROUNDING = 2.0**-7  # K1 and K7 on bf16 io: max abs <= this x max|out| (tests/test_torch_window_attention_bf16.py)
SERVE_MEAN_TOL = 0.05  # bf16 SR against float32 SR, mean abs (tests/test_prefetch_bf16.py)
K7_BF16_RTOL, K7_BF16_ATOL = 0.1, 0.15  # bf16 against the float32 kernel (tests/test_pallas_window.py)
K8_TOL = 1e-5  # max abs error: float32 sums of <= 64 terms in other orders
JUDGE_RTOL = 1e-4  # the judges' features / logits, card vs CPU: max abs <= this x max|ref| (cuDNN's
# float32 convolution and RNN algorithms against the CPU's, through up to 31 layers)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
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
    """The host's wall time a call of fn, the device idle before the timed
    calls: the enqueue work of a call (checks, allocations, launches), which
    back-to-back calls cannot hide when a call's device work is shorter."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def bound_ms(nbytes, flops, tc_flops=0.0, bf16_flops=0.0):
    """The larger of the bytes at 3.35 TB/s and the operations: float32 on
    the CUDA cores at 67 TFLOP/s, plus tc_flops run as 3xTF32 on the tensor
    cores (3 x tc_flops at 495 TFLOP/s), plus bf16_flops on bf16 operands at
    989 TFLOP/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / FP32_FLOP_PER_S + 3 * tc_flops / TF32_FLOP_PER_S + bf16_flops / BF16_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_split(fn, iters=5, warmup=2, attempts=3):
    """Device time of every kernel that fn() launches, by name, under
    torch.profiler over `iters` runs that follow `warmup` profiled runs (the
    first runs under the profiler lose device events):
    {name: (ms, launches)} per run of fn.  A profile that recorded no device
    event at all is taken again, up to `attempts` times; after that the split
    is not measured ({}): CUPTI dropped every event of a process's later
    profiles in some runs on the H100 machine, the parent's script included.
    No number of the kernels line comes from a split."""
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
        split = {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            m = re.search(r"::(\w+)(<[^()]*>)?\(", e.name)  # the kernel's name, short template arguments kept
            name = (m.group(1) + (m.group(2) if m.group(2) and len(m.group(2)) <= 24 else "")) if m else e.name[:60]
            ms, n = split.get(name, (0.0, 0.0))
            split[name] = (ms + e.device_time / 1e3 / iters, n + 1 / iters)
        if split:
            return split
        log("  torch.profiler recorded no device time; profiling again")
    log(f"  torch.profiler recorded no device time in {attempts} attempts: split not measured")
    return {}


def add_split(total, split, times):
    for name, (ms, n) in split.items():
        a, b = total.get(name, (0.0, 0.0))
        total[name] = (a + times * ms, b + times * n)


def log_split(tag, split, parts, library=None):
    """Each sub-kernel's device time (ms and launches per path, and ms a
    launch, which stays right where the profiler drops some of a run's
    events) beside the bound of its part; parts: {kernel name: (bytes,
    float32 operations on CUDA cores, operations on tensor cores[, bf16
    operations on tensor cores])} per path,
    keyed by a kernel's name without template arguments, or by its name up
    to a comma of its template arguments (one instantiation's part, e.g.
    one window size's).  `library`: (kernel name, ms, what) logged beside
    that kernel."""
    if not split:
        log(f"{tag} sub-kernel split: not measured (torch.profiler recorded no device time)")
    for name, (ms, n) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        base = name.split("<")[0]
        line = f"{tag} sub-kernel {name}: {ms:.4f} ms, {n:g} launches a path ({ms / n:.4f} ms a launch)"
        key = next((k for k in parts if k.endswith(",") and name.replace(" ", "").startswith(k)),
                   base if base in parts else None)
        if key:
            nbytes, flops, tc, bf = (*parts[key], 0.0)[:4]
            b_ms, b_by = bound_ms(nbytes, flops, tc, bf)
            kind = "bf16 on tensor cores" if bf else "3xTF32 on tensor cores" if tc else "float32 on CUDA cores"
            line += (f"; part {key} (all its launches): bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB, "
                     f"{(flops + tc + bf) / 1e9:.2f} GFLOP, {kind})")
        if library and base == library[0]:
            line += f"; library {library[1]:.4f} ms ({library[2]})"
        log(line)


def ln_linear_library(xq, xkv, ln, q_w, q_b, kv_w, kv_b):
    """One PyTorch call per step of the LN + projection part: F.layer_norm
    and F.linear of both streams (TF32 off)."""
    import torch.nn.functional as F

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    dim = xq.shape[-1]
    return lambda: (F.linear(F.layer_norm(xq, (dim,), ln[0], ln[1], 1e-6), q_w, q_b),
                    F.linear(F.layer_norm(xkv, (dim,), ln[2], ln[3], 1e-6), kv_w, kv_b))


def ln_proj_part(t, dim):
    """(bytes, CUDA-core operations, tensor-core operations) of one LN +
    projection call on t tokens: xq, xkv in, q, kv out, the weights."""
    return 4 * (5 * t * dim + 3 * dim * dim + 3 * dim), 0.0, 2 * t * dim * 3 * dim


def attn_fwd_parts(t, dim, win, io_bytes=4):
    """{kernel: part} of the attention forward, one launch for every group:
    q, k, v read and out written; two N-long passes (scores, P v) per token
    and channel, on the tensor cores for windows of 16 and 64 tokens
    (3xTF32), on the CUDA cores for 4."""
    ch = dim // len(win)
    flops = {ws: 2 * 2 * t * ch * ws * ws for ws in win}
    return {"window_attn_fwd_kernel": (io_bytes * 4 * t * dim, sum(f for ws, f in flops.items() if ws == 2),
                                       sum(f for ws, f in flops.items() if ws != 2))}


def attn_bwd_parts(t, dim, win, h, w, gh=2):
    """{kernel: part} of the attention backward, one part per group's launch
    (q, k, v, dout read, dq, dk, dv written for the group's channels, its
    dbias partials written; five N-long passes per token and channel), the
    2x2 windows' on the CUDA cores, the others on the tensor cores; and
    sum_rows_kernel's reading of the partials (bytes only)."""
    ch = dim // len(win)
    batch = t // (h * w)
    parts, partials = {}, 0
    for ws in win:
        n = ws * ws
        floats = batch * attn_bwd_chunks(n, gh, (h // ws) * (w // ws)) * gh * n * n
        partials += floats
        flops = 5 * 2 * t * ch * n
        key = "window_attn_bwd4_kernel" if n == 4 else f"window_attn_bwd_tc_kernel<{n},"
        parts[key] = (4 * (7 * t * ch + floats), flops if n == 4 else 0.0, 0.0 if n == 4 else flops)
    return parts, partials


def phase_setup():
    from dpmn_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} cudnn {torch.backends.cudnn.allow_tf32}")
    secs = kernels.build_all()
    log(f"build: {secs:.1f} s for {', '.join(kernels.SOURCES)}")
    if not kernels.ptxas_report:
        log("  ptxas: every library was up to date, nothing compiled (no registers or spills to report)")
    for name, report in kernels.ptxas_report.items():
        funcs = ptxas_functions(report)
        log(f"  ptxas {name} (registers / bytes spilled): " + ", ".join(f"{f} {r} / {sp}" for f, r, sp in funcs))
        spilled = [f for f, _, sp in funcs if sp and base_name(f) in TC_KERNELS]
        if spilled:
            raise AssertionError(f"tensor-core kernels spill: {spilled}")
    check_hmma(kernels)
    return card


def demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True, timeout=60).stdout
        short = [re.sub(r"\(anonymous namespace\)::|<unnamed>::|^void |\(.*", "",
                        re.sub(r"\((int|bool|unsigned int|float)\)", "", line)) for line in out.splitlines()]
        return short if len(short) == len(names) else names
    except OSError:
        return names


def base_name(func):
    """A kernel's name without template arguments."""
    return func.split("<")[0].split("::")[-1].strip()


def ptxas_functions(report):
    """[(kernel, registers, spill bytes)] from nvcc -Xptxas -v output."""
    rows, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = [m.group(1), 0, 0]
            rows.append(cur)
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur[2] = int(m.group(1)) + int(m.group(2))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur[1] = int(m.group(1))
    return [(f, r, s) for f, (_, r, s) in zip(demangle([r[0] for r in rows]), rows)]


def check_hmma(kernels):
    """Each tensor-core sub-kernel holds HMMA (mma.sync) or HGMMA (wgmma)
    instructions (cuobjdump -sass), and the bf16 attention forward (K7's)
    and K1's bf16 LN + projection (one an embedding width: 32, 64, 96) bf16
    m16n8k16 products (HMMA.16816.F32.BF16)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    found, bf16 = {}, {}
    for name in ("window_attention", "window_attention_train", "window_attention_core", "window_attention_full",
                 "grouped_window_attention", "window_tile_attention", "gru_scan", "mlp_convs"):
        sass = subprocess.run([tool, "-sass", str(kernels._target(name))], capture_output=True, text=True,
                              check=True, timeout=120).stdout
        funcs = re.split(r"\n\s*Function : ", sass)[1:]
        names = demangle([f.split(None, 1)[0] for f in funcs])
        for func, body in zip(names, funcs):
            if base_name(func) in TC_KERNELS + ("gru_large_kernel",):
                found[f"{name}: {func}"] = (body.count("HMMA"), body.count("HGMMA"))
                if base_name(func) == "ln_proj_bf16_kernel" or (base_name(func) == "window_attn_fwd_kernel"
                                                                and "bfloat16" in func):
                    bf16[func] = body.count("HMMA.16816.F32.BF16")
    by_lib = {}
    for func, (hmma, hgmma) in found.items():
        lib, name = func.split(": ", 1)
        by_lib.setdefault(lib, []).append(f"{name} {hmma}" + (f" (HGMMA {hgmma})" if hgmma else ""))
    for lib, rows in by_lib.items():
        log(f"  sass {lib}: HMMA instructions: {', '.join(rows)}")
    log(f"  sass bf16 m16n8k16 products (HMMA.16816.F32.BF16): {bf16}")
    missing = [f for f, n in found.items() if sum(n) == 0]
    absent = [k for k in TC_KERNELS if not any(base_name(f.split(": ", 1)[1]) == k for f in found)]
    if missing or absent or len(bf16) < 4 or not all(bf16.values()):
        raise AssertionError(f"no HMMA or HGMMA in {missing}; tensor-core kernels not found: {absent}; bf16 "
                             f"m16n8k16 products: {bf16}")


def phase_window_attention(dev):
    """K1 vs its plain version; returns its kernels-line entry (timing fields
    per forward: 6 unshifted + 6 shifted faithful calls)."""
    from dpmn_tpu_torch.models.pgrm import SwinTransformerBlock
    from dpmn_tpu_torch.ops.window_attention import window_attention_block, window_attention_block_plain
    from dpmn_tpu_torch.system import init_weights

    h, w, dim = 16, 64, 96
    gen = torch.Generator().manual_seed(1)
    xq = torch.randn(B, h * w, dim, generator=gen).to(dev)
    xkv = torch.randn(B, h * w, dim, generator=gen).to(dev)
    worst, times, kws = 0.0, {}, {}
    for shift in ((0, 0, 0), (1, 2, 4)):
        for faithful in (True, False):
            blk = SwinTransformerBlock(dim, (h, w), 6, [2, 4, 8], list(shift), faithful=faithful)
            init_weights(blk, seed=2)
            with torch.no_grad():  # non-trivial norms and biases
                for ln in (blk.norm1_q, blk.norm1_kv):
                    ln.weight.add_(0.1 * torch.randn(dim, generator=gen))
                    ln.bias.add_(0.1 * torch.randn(dim, generator=gen))
                for i in range(3):
                    getattr(blk.attn, f"relative_position_bias_table_{i}").normal_(0, 0.02, generator=gen)
            blk = blk.to(dev)
            kw = blk.attn.block_args(blk.ln_params())
            with torch.no_grad():
                out = window_attention_block(xq, xkv, **kw)
                ref = window_attention_block_plain(xq, xkv, **kw)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                rel = ((out - ref).abs() / ref.abs().clamp_min(1e-3)).max().item()
                ok = torch.isfinite(out).all().item() and err <= K1_TOL
                log(f"K1 shift={shift} layout={kw['layout']}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
                    f"(tol {K1_TOL:g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"window_attention kernel disagrees with its plain version: {err}")
                worst = max(worst, err)
                if faithful:
                    kws[shift] = kw
                    times[shift] = (cuda_ms(lambda: window_attention_block(xq, xkv, **kw)),
                                    cuda_ms(lambda: window_attention_block_plain(xq, xkv, **kw), iters=5))
    l, n_sum, ch = h * w, 4 + 16 + 64, dim // 3
    # the sub-kernels of one forward's 12 calls (6 of each shift set) and
    # the bounds of their parts
    t = B * l
    split = {}
    with torch.no_grad():
        for kw in kws.values():
            add_split(split, kernel_split(lambda: window_attention_block(xq, xkv, **kw)), 6)
        parts = {"ln_proj_kernel": ln_proj_part(t, dim),
                 **attn_fwd_parts(t, dim, (2, 4, 8)),
                 "skconv_proj_kernel": (4 * (2 * t * dim + t // 64 * dim + dim * dim), 0.0, 2 * t * dim * dim),
                 "skconv_gate_kernel": (4 * t // 64 * dim, 0.0, 0.0),
                 "skconv_out_kernel": (4 * (4 * t * dim + dim * ch), 2 * t * dim, 2 * t * ch * dim)}
        wts, ln = kw["weights"], kw["ln"]
        lib = ln_linear_library(xq, xkv, [ln[k] for k in ("qs", "qb", "ks", "kb")], wts["q_w"], wts["q_b"],
                                wts["kv_w"], wts["kv_b"])
        l_ms = 12 * cuda_ms(lib)
    log_split("K1", split, {k: tuple(12 * v for v in p) for k, p in parts.items()},
              ("ln_proj_kernel", l_ms, "F.layer_norm + F.linear of both streams, TF32 off, 12 calls"))
    flops = B * (2 * l * dim * 3 * dim + 4 * l * ch * n_sum + 2 * l * dim * dim + 2 * l * ch * dim)
    nbytes = 3 * B * l * dim * 4
    b_ms, b_by = bound_ms(nbytes, flops)
    for shift, (k_ms, p_ms) in times.items():
        log(f"K1 B={B} shift={shift}: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}; "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    per_fwd = lambda i: 6 * (times[(0, 0, 0)][i] + times[(1, 2, 4)][i])
    return {"name": "window_attention_block", "route": "cuda",
            "source": "dpmn_tpu_torch/csrc/window_attention.cu",
            "replaces": "dpmn_tpu/ops/pallas_window.py:500", "max_abs_err": worst,
            "ms": per_fwd(0), "plain_ms": per_fwd(1), "bound_ms": 12 * b_ms, "bound_by": b_by,
            "library_ms": None}


def phase_gru(dev):
    """K2 vs its plain versions at the main-path shapes: the fused launch
    `gru_bidir` (both directions) and `gru_scan` (each direction alone), the
    faithful gru_encoding's projection broadcast along time (stride 0) as the
    path passes it.  torch.nn.GRU(bidirectional=True) is timed beside the
    fused launch on the same x_proj, with identity input weights, so cuDNN
    runs the same recurrence (its time includes that extra input GEMM); then
    the like-for-like pair: the port's whole BiGRU (input GEMMs + kernel)
    against nn.GRU on the same x with the same weights; last, the
    cooperative regime's floor per step (the encoding launch at H = 64).
    Returns K2's kernels-line entry (timing fields per flagship forward)."""
    from dpmn_tpu_torch.ops.gru import BiGRU, gru_bidir, gru_bidir_plain, gru_scan, gru_scan_plain

    # (N, T, H, GRU input size, launches per forward): the vertical and
    # horizontal SRB sweeps (5 SRBs each) and the faithful gru_encoding
    shapes = [(64 * B, 16, 32, 64, 5), (16 * B, 64, 32, 64, 5), (64, B, 512, 1024, 1)]
    gen = torch.Generator().manual_seed(3)
    worst, tot = 0.0, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    by_time = {"bytes": 0.0, "operations": 0.0}
    for n, t, hd, isz, count in shapes:
        bcast = hd == 512  # gru_encoding: one projection at every step
        xps = [(0.5 * torch.randn(n, 1 if bcast else t, 3 * hd, generator=gen)).to(dev) for _ in range(2)]
        if bcast:
            xps = [x.expand(-1, t, -1) for x in xps]
        w_hh = [(torch.rand(3 * hd, hd, generator=gen) * 2 - 1).div(hd**0.5).to(dev) for _ in range(2)]
        b_hh = [(torch.rand(3 * hd, generator=gen) * 2 - 1).div(hd**0.5).to(dev) for _ in range(2)]
        args = (*xps, *w_hh, *b_hh)
        checks = [("gru_bidir", gru_bidir(*args), gru_bidir_plain(*args))]
        for d, reverse in ((0, False), (1, True)):
            checks.append((f"gru_scan reverse={reverse}", gru_scan(xps[d], w_hh[d], b_hh[d], reverse),
                           gru_scan_plain(xps[d], w_hh[d], b_hh[d], reverse)))
        torch.cuda.synchronize()
        for tag, out, ref in checks:
            err = (out - ref).abs().max().item()
            ok = torch.isfinite(out).all().item() and err <= K2_TOL
            log(f"K2 {tag} N={n} T={t} H={hd} time stride {xps[0].stride(1)}: max_abs_err {err:.3e} "
                f"(tol {K2_TOL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag} kernel disagrees with its plain version: {err}")
            worst = max(worst, err)
        lib = torch.nn.GRU(3 * hd, hd, batch_first=True, bidirectional=True).to(dev)
        with torch.no_grad():
            for d, sfx in enumerate(("l0", "l0_reverse")):
                getattr(lib, f"weight_ih_{sfx}").copy_(torch.eye(3 * hd))
                getattr(lib, f"bias_ih_{sfx}").zero_()
                getattr(lib, f"weight_hh_{sfx}").copy_(w_hh[d])
                getattr(lib, f"bias_hh_{sfx}").copy_(b_hh[d])
            same = (xps[0], xps[0], *w_hh, *b_hh)  # nn.GRU feeds one input to both directions
            x_lib = xps[0].contiguous()
            lib_err = (lib(x_lib)[0] - gru_bidir(*same)).abs().max().item()
            k_ms = cuda_ms(lambda: gru_bidir(*args))
            p_ms = cuda_ms(lambda: gru_bidir_plain(*args), iters=3)
            l_ms = cuda_ms(lambda: lib(x_lib))
            # like for like: the port's BiGRU (input GEMMs + kernel) and
            # nn.GRU, the same weights, on the same x
            port = BiGRU(isz, hd)
            ref = torch.nn.GRU(isz, hd, batch_first=True, bidirectional=True)
            for name, param in ref.named_parameters():
                param.uniform_(-hd**-0.5, hd**-0.5, generator=gen)
                getattr(port, name).copy_(param)
            port, ref = port.to(dev), ref.to(dev)
            x = torch.randn(n, 1 if bcast else t, isz, generator=gen).to(dev)
            steps = t if bcast else None
            x_ref = x.expand(-1, t, -1).contiguous()
            pair_err = (port(x, steps) - ref(x_ref)[0]).abs().max().item()
            m_ms = cuda_ms(lambda: port(x, steps))
            r_ms = cuda_ms(lambda: ref(x_ref))
        x_elems = sum(n * (1 if bcast else t) * 3 * hd for _ in xps)  # each input read once
        nbytes = 4 * (x_elems + 2 * (w_hh[0].numel() + b_hh[0].numel()) + n * t * 2 * hd)
        b_ms, by_s = bound_ms(nbytes, 2 * 2 * n * t * 3 * hd * hd)
        log(f"K2 N={n} T={t} H={hd} both directions, one launch: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
            f"library_ms {l_ms:.4f} (torch.nn.GRU bidirectional on x_proj, |diff| {lib_err:.1e}) bound_ms "
            f"{b_ms:.4f} ({by_s}; {nbytes / 1e6:.1f} MB); whole layer on x (I={isz}): BiGRU {m_ms:.4f} ms, "
            f"torch.nn.GRU {r_ms:.4f} ms (|diff| {pair_err:.1e}); {count} per forward")
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms), ("bound_ms", b_ms)):
            tot[key] += count * v
        by_time[by_s] += count * b_ms
    # the cooperative regime's floor per step (gi loads, gate math, grid
    # sync): the gru_encoding launch at H = 64, 64x fewer operations
    xps, w_hh, b_hh = [torch.randn(64, 1, 192, generator=gen).to(dev).expand(-1, B, -1) for _ in range(2)], [
        (0.1 * torch.randn(192, 64, generator=gen)).to(dev) for _ in range(2)], [
        (0.1 * torch.randn(192, generator=gen)).to(dev) for _ in range(2)]
    with torch.no_grad():
        f_ms = cuda_ms(lambda: gru_bidir(*xps, *w_hh, *b_hh))
    log(f"K2 N=64 T={B} H=64 both directions: kernel_ms {f_ms:.4f} ({f_ms / B * 1e3:.2f} us a step: the cooperative "
        f"regime's floor per step)")
    return {"name": "gru_scan", "route": "cuda", "source": "dpmn_tpu_torch/csrc/gru_scan.cu",
            "replaces": "dpmn_tpu/ops/pallas_kernels.py:76", "max_abs_err": worst, **tot,
            "bound_by": max(by_time, key=by_time.get)}


def counters():
    from dpmn_tpu_torch.ops import window_attention_core as wc
    from dpmn_tpu_torch.ops import window_attention_full as wf
    from dpmn_tpu_torch.ops import window_attention_train as wt
    from dpmn_tpu_torch.ops.dropout_mask import dropout_mask_counter
    from dpmn_tpu_torch.ops.grouped_window_attention import grouped_window_attention_counter
    from dpmn_tpu_torch.ops.gru import gru_bidir_counter, gru_scan_counter
    from dpmn_tpu_torch.ops.mlp_convs import mlp_convs_counter
    from dpmn_tpu_torch.ops.window_attention import window_attention_counter
    from dpmn_tpu_torch.ops.window_tile_attention import window_tile_attention_counter

    return {"window_attention_block": window_attention_counter, "gru_scan": gru_scan_counter,
            "gru_bidir": gru_bidir_counter,
            "window_attention_train_forward": wt.forward_counter,
            "window_attention_train_backward": wt.backward_counter,
            "window_attention_core_forward": wc.forward_counter,
            "window_attention_core_backward": wc.backward_counter,
            "window_attention_full_forward": wf.forward_counter,
            "window_attention_full_backward": wf.backward_counter,
            "window_tile_attention": window_tile_attention_counter,
            "grouped_window_attention": grouped_window_attention_counter,
            "mlp_convs": mlp_convs_counter, "dropout_mask": dropout_mask_counter}


def expected_counts(**launches):
    """Every counter at 0 but those given."""
    return {name: launches.get(name, 0) for name in counters()}


def reset_counts():
    for c in counters().values():
        c.launches = 0


def read_counts():
    return {name: c.launches for name, c in counters().items()}


def check_counts(tag, launches, **expected):
    """Raise unless the counts read after a path's run are exactly
    `expected` (every other counter 0)."""
    want = expected_counts(**expected)
    log(f"{tag}: launches in the path's run {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches}")


def phase_path(dev, card):
    """The flagship sr_forward at B = 64; returns the launch counts of one
    forward, the system on the card, the same system on the CPU, the batches
    and the counted forward's SR (of batches[1])."""
    from dpmn_tpu_torch.config import TrainCfg, flagship_args
    from dpmn_tpu_torch.system import DPMNSystem

    t0 = time.perf_counter()
    system = DPMNSystem(TrainCfg(batch_size=B), flagship_args(), device=dev, seed=0)
    log(f"path: flagship system built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in system.parameters()) / 1e6:.1f} M parameters)")
    rng = np.random.RandomState(0)
    batches = [rng.rand(B, 16, 64, 4).astype(np.float32) for _ in range(6)]
    out = system.sr_forward(batches[0])  # warm-up
    torch.cuda.synchronize()

    reset_counts()
    out = system.sr_forward(batches[1])
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"path: launches in one forward {launches} (expected 12 window-attention blocks, 11 GRU-scan "
        f"launches through gru_bidir, both directions each: 5 SRBs x 2 sweeps + gru_encoding; no training kernel)")
    if launches != expected_counts(window_attention_block=12, gru_bidir=11):
        raise AssertionError(f"main path launch counts {launches}")
    if tuple(out.shape) != (B, 32, 128, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"bad output: shape {tuple(out.shape)}, finite {torch.isfinite(out).all().item()}")
    sr32 = out

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for x in batches[2:]:
        out = system.sr_forward(x)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / len(batches[2:])
    log(f"path: flagship sr_forward B={B}: {dt * 1e3:.2f} ms/batch, {B / dt:.1f} images/s on {card}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the same weights on 2 images: card against the CPU (plain versions).
    # Both hold at float32 tolerance: the PSN output has no threshold, and the
    # SR is held once the student's ids agree exactly.  Downstream uint8
    # truncation (parse_visionlan_input, to_mask) and the students' argmax
    # could flip on a value within rounding of a threshold; with these seeds
    # nothing lies that close, so a flip here is a fault.
    cpu = DPMNSystem(TrainCfg(batch_size=2), flagship_args(), device="cpu", seed=0)
    x2 = batches[1][:2]
    with torch.no_grad():
        xg = torch.from_numpy(x2).permute(0, 3, 1, 2).contiguous()
        psn_c = cpu._psn_forward(xg)
        psn_g = system._psn_forward(xg.to(dev)).cpu()
        from dpmn_tpu_torch.models.visionlan import parse_visionlan_input

        ids_c = cpu.students[0](parse_visionlan_input(psn_c[:, :3]))[0].argmax(-1)
        ids_g = system.students[0](parse_visionlan_input(psn_g.to(dev)[:, :3]))[0].argmax(-1).cpu()
    sr_c, sr_g = cpu.sr_forward(x2), system.sr_forward(x2).cpu()
    psn_err = (psn_c - psn_g).abs().max().item()
    d = (sr_c - sr_g).abs()
    ids_agree = (ids_c == ids_g).float().mean().item()
    log(f"path: card vs CPU on 2 images: PSN max_abs_err {psn_err:.3e} (tol 1e-4); student-0 ids agree "
        f"{ids_agree:.3f} (must be 1); SR max_abs_err {d.max().item():.3e} mean_abs_err {d.mean().item():.3e} "
        f"(tol max 1e-4)")
    if not (psn_err <= 1e-4 and ids_agree == 1.0 and d.max().item() <= 1e-4 and torch.isfinite(sr_g).all()):
        raise AssertionError("card and CPU disagree on the main path")
    return launches, system, cpu, batches, sr32


def bf16_block_args(kw):
    """`window_attention_block` keyword arguments with the weights, the LN
    parameters and the relative biases in bf16 (the masks stay float32)."""
    bf = lambda d: None if d is None else {k: t.bfloat16() for k, t in d.items()}
    return dict(kw, weights=bf(kw["weights"]), ln=bf(kw["ln"]), biases=[b.bfloat16() for b in kw["biases"]])


def phase_window_attention_bf16(dev):
    """K1 on bf16 io against its plain version at B = 64 (both shift sets,
    both layouts) at one bf16 rounding of max|out|; its times and bound per
    forward (6 unshifted + 6 shifted faithful calls) and its sub-kernel
    split.  Returns its kernels-line entry (launches filled in by the
    serving phase)."""
    from dpmn_tpu_torch.models.pgrm import SwinTransformerBlock
    from dpmn_tpu_torch.ops.window_attention import window_attention_block, window_attention_block_plain
    from dpmn_tpu_torch.system import init_weights

    h, w, dim = 16, 64, 96
    gen = torch.Generator().manual_seed(1)
    xq = torch.randn(B, h * w, dim, generator=gen).to(dev).bfloat16()
    xkv = torch.randn(B, h * w, dim, generator=gen).to(dev).bfloat16()
    worst, times, kws = 0.0, {}, {}
    for shift in ((0, 0, 0), (1, 2, 4)):
        for faithful in (True, False):
            blk = SwinTransformerBlock(dim, (h, w), 6, [2, 4, 8], list(shift), faithful=faithful)
            init_weights(blk, seed=2)
            with torch.no_grad():
                for ln in (blk.norm1_q, blk.norm1_kv):
                    ln.weight.add_(0.1 * torch.randn(dim, generator=gen))
                    ln.bias.add_(0.1 * torch.randn(dim, generator=gen))
                for i in range(3):
                    getattr(blk.attn, f"relative_position_bias_table_{i}").normal_(0, 0.02, generator=gen)
            kw = bf16_block_args(blk.to(dev).attn.block_args(blk.ln_params()))
            with torch.no_grad():
                out = window_attention_block(xq, xkv, **kw)
                ref = window_attention_block_plain(xq, xkv, **kw)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                tol = BF16_ROUNDING * ref.float().abs().max().item()
                ok = out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all().item() and err <= tol
                log(f"K1 bf16 shift={shift} layout={kw['layout']}: max_abs_err {err:.3e} (tol {tol:.3e}: 2^-7 "
                    f"max|out|); equal values {(out == ref).float().mean().item():.4f} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"bf16 window_attention kernel disagrees with its plain version: {err}")
                worst = max(worst, err)
                if faithful:
                    kws[shift] = kw
                    times[shift] = (cuda_ms(lambda: window_attention_block(xq, xkv, **kw)),
                                    cuda_ms(lambda: window_attention_block_plain(xq, xkv, **kw), iters=5))
    l, n_sum, ch, t = h * w, 4 + 16 + 64, dim // 3, B * h * w
    split = {}
    with torch.no_grad():
        for kw in kws.values():
            add_split(split, kernel_split(lambda: window_attention_block(xq, xkv, **kw)), 6)
    parts = {"ln_proj_bf16_kernel": (2 * (2 * t * dim + 3 * dim * dim + 3 * dim) + 4 * 3 * t * dim, 0.0, 0.0,
                                     2 * t * dim * 3 * dim),
             **attn_fwd_parts(t, dim, (2, 4, 8)),
             "skconv_proj_kernel": (4 * (2 * t * dim + t // 64 * dim) + 2 * dim * dim, 0.0, 2 * t * dim * dim),
             "skconv_gate_kernel": (4 * t // 64 * dim, 0.0, 0.0),
             "skconv_out_kernel": (4 * 2 * t * dim + 2 * (2 * t * dim + dim * ch), 2 * t * dim, 2 * t * ch * dim)}
    log_split("K1 bf16", split, {k: tuple(12 * v for v in p) for k, p in parts.items()})
    proj = B * 2 * l * dim * 3 * dim  # on bf16 operands
    flops = B * (4 * l * ch * n_sum + 2 * l * dim * dim + 2 * l * ch * dim)  # float32
    nbytes = 3 * B * l * dim * 2
    b_ms, b_by = bound_ms(nbytes, flops, 0.0, proj)
    for shift, (k_ms, p_ms) in times.items():
        log(f"K1 bf16 B={B} shift={shift}: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}; "
            f"{nbytes / 1e6:.1f} MB, {proj / 1e9:.2f} GFLOP bf16 + {flops / 1e9:.2f} GFLOP float32)")
    per_fwd = lambda i: 6 * (times[(0, 0, 0)][i] + times[(1, 2, 4)][i])
    return {"name": "window_attention_block_bf16", "route": "cuda",
            "source": "dpmn_tpu_torch/csrc/window_attention.cu",
            "replaces": "dpmn_tpu/ops/pallas_window.py:500", "max_abs_err": worst,
            "ms": per_fwd(0), "plain_ms": per_fwd(1), "bound_ms": 12 * b_ms, "bound_by": b_by,
            "library_ms": None}


def glyph_ids(system, fn):
    """fn()'s result and the ids of every glyph render it made."""
    ids = []
    hook = system.glyph.register_forward_hook(lambda m, inp, out: ids.append(inp[0].cpu()))
    try:
        out = fn()
    finally:
        hook.remove()
    return out, ids


def phase_serving(dev, card, system, cpu, batches, sr32):
    """The serving modes of the eval forward on phase 4's system (sr32: its
    float32 SR of batches[1]); returns the launch counts of one
    sr_forward_bf16 (the bf16 K1's entry)."""
    from dpmn_tpu_torch.evaluator import CRNNEvaluator
    from dpmn_tpu_torch.models.visionlan import parse_visionlan_input
    from dpmn_tpu_torch.utils.metrics import psnr, ssim

    def with_students16(fn):
        def run(x):
            system.student_dtype = "bfloat16"
            try:
                return fn(x)
            finally:
                system.student_dtype = None
        return run

    modes = {"sr_forward glyph_from_psn": lambda x: system.sr_forward(x, glyph_from_psn=True),
             "sr_forward bf16 students": with_students16(lambda x: system.sr_forward(x)),
             "sr_forward_bf16": lambda x: system.sr_forward_bf16(x),
             "sr_forward_bf16 glyph_from_psn": lambda x: system.sr_forward_bf16(x, glyph_from_psn=True)}
    outs, bf16_launches = {"sr_forward": sr32}, None
    for name, fn in modes.items():
        fn(batches[0])  # warm-up: makes the mode's bf16 copy or stacked students
        torch.cuda.synchronize()
        reset_counts()
        out = fn(batches[1])
        torch.cuda.synchronize()
        launches = read_counts()
        check_counts(f"serving {name}", launches, window_attention_block=12, gru_bidir=11)
        if out.dtype != torch.float32 or tuple(out.shape) != (B, 32, 128, 3) or not torch.isfinite(out).all():
            raise AssertionError(f"serving {name}: bad output {out.dtype} {tuple(out.shape)}")
        if name == "sr_forward_bf16":
            bf16_launches = launches
        outs[name] = out
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for x in batches[2:]:
            fn(x)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / len(batches[2:])
        log(f"serving {name} B={B}: {dt * 1e3:.2f} ms/batch, {B / dt:.1f} images/s on {card}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the students' ids that bf16 keeps, on the PSN output of a batch
    with torch.no_grad():
        x = system._nchw(batches[1])
        img = system._psn_forward(x)
        vl = parse_visionlan_input(img[:, :3])
        students16 = system.student_bf16.get().students
        keep = [(s32(vl)[0].argmax(-1) == s16(vl.bfloat16())[0].argmax(-1)).float().mean().item()
                for s32, s16 in zip(system.students, students16)]
    log(f"serving: bf16 students keep {', '.join(f'{k:.4f}' for k in keep)} of the float32 ids (each student, "
        f"B={B} x 25 positions)")

    judge = CRNNEvaluator(device=dev, seed=5)
    for glyph_mode, (a, b) in (("", ("sr_forward", "sr_forward_bf16")),
                               (" glyph_from_psn", ("sr_forward glyph_from_psn", "sr_forward_bf16 glyph_from_psn"))):
        sr32, sr16 = outs[a], outs[b]
        d = (sr16 - sr32).abs()
        words32, words16 = judge.predict(sr32), judge.predict(sr16)
        agree = float(np.mean([u == v for u, v in zip(words32, words16)]))
        ok = d.mean().item() < SERVE_MEAN_TOL
        log(f"serving: bf16 SR against float32 SR{glyph_mode}: mean_abs {d.mean().item():.4e} (tol "
            f"{SERVE_MEAN_TOL}) max_abs {d.max().item():.4e}; PSNR {psnr(sr16, sr32).item():.3f} dB, SSIM "
            f"{ssim(sr16, sr32).item():.5f}; CRNN judge words agree {agree:.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"bf16 serving drifts from float32{glyph_mode}: {d.mean().item()}")

    # glyph_from_psn in float32: the card against the CPU on 2 images
    x2 = batches[1][:2]
    sr_c, ids_c = glyph_ids(cpu, lambda: cpu.sr_forward(x2, glyph_from_psn=True))
    sr_g, ids_g = glyph_ids(system, lambda: system.sr_forward(x2, glyph_from_psn=True).cpu())
    d = (sr_c - sr_g).abs().max().item()
    same = len(ids_c) == len(ids_g) == 1 and torch.equal(ids_c[0], ids_g[0])
    log(f"serving: glyph_from_psn card vs CPU on 2 images: ids of the one render of {system.b1} x 2 words equal "
        f"{same}; SR max_abs_err {d:.3e} (tol 1e-4)")
    if not (same and d <= 1e-4):
        raise AssertionError("card and CPU disagree on glyph_from_psn")
    return bf16_launches


def busy_share(fn, attempts=3):
    """The device's busy time in one fn() under torch.profiler (the union of
    its device events' intervals, `profile_path.device_busy_ms`), with the
    run's wall time, the device events' count and their device time by
    name; after one profiled warm-up run (the first run under the profiler
    loses device events).  None where the profile recorded no device event
    in `attempts` tries."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from dpmn_tpu_torch.profile_path import device_busy_ms, device_events

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                prof.step()
        events = device_events(prof)
        if not events:
            log("  torch.profiler recorded no device time; profiling again")
            continue
        by_name = {}
        for e in events:
            ms, n = by_name.get(e.name[:60], (0.0, 0))
            by_name[e.name[:60]] = (ms + e.device_time / 1e3, n + 1)
        return device_busy_ms(events), wall, len(events), by_name
    return None


@torch.no_grad()
def judge_values(kind, judge, images):
    """A judge's last float values before its words, on NHWC images: ASTER's
    encoder features (after the STN, TPS and the BiLSTM), MORAN's logits of
    both directions, CRNN's logits."""
    from dpmn_tpu_torch.models.aster import parse_aster_input
    from dpmn_tpu_torch.models.crnn import parse_crnn_input
    from dpmn_tpu_torch.models.moran import parse_moran_input

    x = images.permute(0, 3, 1, 2)
    m = judge.model
    if kind == "aster":
        return m.encoder(m.rectify(parse_aster_input(x))[0])
    if kind == "moran":
        return torch.cat(m(parse_moran_input(x)), dim=1)
    return m(parse_crnn_input(x))


def phase_judges(dev, card, system, batches):
    """The three judges on phase 4's system, reading the test-mode SR of one
    B = 64 batch; raises unless each judge reads the same words on the card
    as on the CPU (2 images) and no kernel of the port was launched."""
    from dpmn_tpu_torch.evaluator import build_evaluator

    sr = system.sr_forward(batches[1], glyph_from_psn=True)
    torch.cuda.synchronize()
    if tuple(sr.shape) != (B, 32, 128, 3) or not torch.isfinite(sr).all():
        raise AssertionError(f"judges: bad SR {tuple(sr.shape)}")
    reset_counts()
    for kind, seed in (("aster", 11), ("moran", 12), ("crnn", 13)):
        judge = build_evaluator(kind, device=dev, seed=seed)
        words = judge.predict(sr)
        if len(words) != B:
            raise AssertionError(f"judges: {kind} read {len(words)} words of {B} images")
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: judge.predict(sr), iters=5, warmup=2)
        peak = torch.cuda.max_memory_allocated()
        log(f"judges: {kind} B={B}: {ms:.2f} ms/batch, {B / ms * 1e3:.1f} images/s on {card}; peak memory "
            f"{peak / 2**30:.3f} GiB, {(peak - resident) / 2**30:.3f} GiB above the {resident / 2**30:.3f} GiB "
            f"resident (the system, the judges); {len(set(words))} distinct words, e.g. {words[:2]}")
        if kind == "aster":
            share = busy_share(lambda: judge.predict(sr))
            if share is None:
                log("judges: aster busy share not measured (torch.profiler recorded no device time)")
            else:
                busy, wall, n, by_name = share
                log(f"judges: aster one predict under torch.profiler: wall {wall:.2f} ms, device busy {busy:.2f} ms "
                    f"({100 * busy / wall:.1f} % busy, {n} device events)")
                for name, (t, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
                    log(f"judges: aster device time {t:.3f} ms in {cnt} x {name}")
        cpu = build_evaluator(kind, device="cpu", seed=seed)
        x2 = sr[:2]
        same = judge.predict(x2) == cpu.predict(x2.cpu())
        if kind == "aster":
            same = same and bool((judge.predict_ids(x2) == cpu.predict_ids(x2.cpu())).all())
        ref = judge_values(kind, cpu, x2.cpu())
        err = (judge_values(kind, judge, x2).cpu() - ref).abs().max().item()
        tol = JUDGE_RTOL * ref.abs().max().item()
        log(f"judges: {kind} card vs CPU on 2 images: words{' and beam ids' if kind == 'aster' else ''} equal "
            f"{same}; {'features' if kind == 'aster' else 'logits'} max_abs_err {err:.3e} (tol {tol:.3e})")
        if not (same and err <= tol):
            raise AssertionError(f"card and CPU disagree on the {kind} judge")
    check_counts("judges", read_counts())


def k3_cost(batch, hw_shape, dim, window_sizes):
    """Bytes (each input read once, each output written once) and float32
    operations of one K3 forward and one backward call, from the shapes:
    the projections (2 t c 3c), and per token and channel one N-long dot per
    attention product (forward: scores and P v; backward: the recomputed
    scores, dP, dV, dQ and dK); the backward adds dx and dW of the
    projections (2 x 2 t c 3c)."""
    t = batch * hw_shape[0] * hw_shape[1]
    channel = dim // len(window_sizes)
    proj = 2 * t * dim * 3 * dim
    attn_pass = 2 * t * channel * sum(ws * ws for ws in window_sizes)
    io = 4 * t * dim
    return {"fwd_bytes": 3 * io, "fwd_flops": proj + 2 * attn_pass,
            "bwd_bytes": 5 * io, "bwd_flops": 3 * proj + 5 * attn_pass}


def k4_cost(batch, hw_shape, dim, window_sizes):
    """Bytes and float32 operations of one K4 forward and one backward call:
    the attention passes of k3_cost without LN or projections; q, k, v and
    out move in the forward, q, k, v, dout, dq, dk and dv in the backward."""
    t = batch * hw_shape[0] * hw_shape[1]
    attn_pass = 2 * t * (dim // len(window_sizes)) * sum(ws * ws for ws in window_sizes)
    io = 4 * t * dim
    return {"fwd_bytes": 4 * io, "fwd_flops": 2 * attn_pass, "bwd_bytes": 7 * io, "bwd_flops": 5 * attn_pass}


def k5_cost(batch, hw_shape, dim, window_sizes):
    """Bytes and float32 operations of one K5 forward and one backward call:
    K3's, plus SKConv's products (proj 2 t c c, proj_head 2 t ch c; the
    per-image fc layers are negligible) once in the forward; in the backward
    the tokens' P v pass, SKConv's forward again and its backward (twice its
    forward's products)."""
    cost = k3_cost(batch, hw_shape, dim, window_sizes)
    t = batch * hw_shape[0] * hw_shape[1]
    channel = dim // len(window_sizes)
    skconv = 2 * t * dim * dim + 2 * t * channel * dim
    attn_pass = 2 * t * channel * sum(ws * ws for ws in window_sizes)
    return dict(cost, fwd_flops=cost["fwd_flops"] + skconv, bwd_flops=cost["bwd_flops"] + attn_pass + 3 * skconv)


def hold_against_plain(tag, out, ref, grads, ref_grads):
    """Forward max abs within K3_TOL and each gradient within K3_GRAD_RTOL of
    its largest value + K3_GRAD_ATOL; returns (forward max abs, worst
    gradient max abs)."""
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    gerr = max(((g - r).abs().max() / (K3_GRAD_RTOL * r.abs().max() + K3_GRAD_ATOL)).item()
               for g, r in zip(grads, ref_grads))
    ok = bool(torch.isfinite(out).all()) and err <= K3_TOL and gerr <= 1.0
    log(f"{tag}: forward max_abs_err {err:.3e} (tol {K3_TOL:g}); worst gradient at {gerr:.3f} of its tolerance "
        f"(max abs <= {K3_GRAD_RTOL:g} * max|ref| + {K3_GRAD_ATOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: kernel disagrees with its plain version: {err}, {gerr}")
    return err, max((g - r).abs().max().item() for g, r in zip(grads, ref_grads))


def sdpa_groups(a, b_det, masks, h, w, gen, dev):
    """The attention core of one call as F.scaled_dot_product_attention takes
    it: per group the window-partitioned q, k, v (B*nW, heads, N, 16) with
    bias + shift mask as attn_mask, and a cotangent."""
    args = []
    for g, (ws, sh) in enumerate(zip(a.win, a.shf)):
        n, nw = ws * ws, (h // ws) * (w // ws)
        qkv = [torch.randn(B * nw, a.gnum_heads, n, 16, generator=gen).to(dev).requires_grad_() for _ in range(3)]
        mask = b_det[g][None].expand(B * nw, -1, -1, -1)
        if sh > 0:
            mask = (b_det[g][None, None] + masks[g][None, :, None]).expand(B, -1, -1, -1, -1).reshape(
                B * nw, a.gnum_heads, n, n)
        args.append((qkv, mask.contiguous(), torch.randn(B * nw, a.gnum_heads, n, 16, generator=gen).to(dev)))
    return args


def phase_k3(dev):
    """K3 forward and backward against autograd through the plain version at
    B = 64; returns the kernels-line entries of its two entry points (timing
    fields per train step: 6 unshifted + 6 shifted calls, keep 0.9).  No
    PyTorch call computes LN + projections + grouped window attention with
    dropout; phase 7 times SDPA on the attention core alone as K4's library
    call."""
    from dpmn_tpu_torch.models.pgrm import SwinTransformerBlock
    from dpmn_tpu_torch.ops import window_attention_train as wt
    from dpmn_tpu_torch.system import init_weights

    h, w, dim, seed = 16, 64, 96, 1234
    gen = torch.Generator().manual_seed(4)
    xq = torch.randn(B, h * w, dim, generator=gen).to(dev)
    xkv = torch.randn(B, h * w, dim, generator=gen).to(dev)
    cot = torch.randn(B, h * w, dim, generator=gen).to(dev)
    worst_fwd, worst_grad, times, split_fwd, split_bwd = 0.0, 0.0, {}, {}, {}
    for shift in ((0, 0, 0), (1, 2, 4)):
        blk = SwinTransformerBlock(dim, (h, w), 6, [2, 4, 8], list(shift))
        init_weights(blk, seed=5)
        a = blk.attn
        leaf = lambda t: t.detach().clone().to(dev).requires_grad_()
        rnd = lambda *shape: leaf(0.1 * torch.randn(*shape, generator=gen))
        prim = [leaf(xq), leaf(xkv), leaf(1 + 0.1 * torch.randn(dim, generator=gen)), rnd(dim),
                leaf(1 + 0.1 * torch.randn(dim, generator=gen)), rnd(dim), leaf(a.q.weight), rnd(dim),
                leaf(a.kv.weight), rnd(2 * dim)]
        biases = [rnd(*b.shape) for b in a.biases()]
        masks = [m.to(dev) if m is not None else None for m in a.masks()]
        static = (a.win, a.shf, a.gnum_heads, a.scale, a.hw)
        for layout in ("faithful", "corrected"):
            for keep in (1.0, 0.9):
                def run(fn):
                    out = fn(*prim, biases, masks, seed, keep, *static)
                    if layout == "corrected":
                        out = wt.corrected_relayout(out, a.win, a.shf, a.hw)
                    return out, torch.autograd.grad(out, prim + biases, cot)

                out, grads = run(wt.window_attention_block_core)
                ref, ref_grads = run(wt.window_attention_block_core_plain)
                err, gerr = hold_against_plain(f"K3 shift={shift} layout={layout} keep={keep}", out, ref, grads,
                                               ref_grads)
                worst_fwd, worst_grad = max(worst_fwd, err), max(worst_grad, gerr)
        # times at the main path's call: faithful layout, keep 0.9
        keep = 0.9
        st = wt.make_static(masks, seed, keep, *static)
        p_det = [t.detach() for t in prim]
        b_det = [t.detach() for t in biases]
        k_fwd = cuda_ms(lambda: wt._forward_cuda(st, p_det, b_det))
        k_bwd = cuda_ms(lambda: wt._backward_cuda(st, p_det, b_det, cot))
        p_fwd = cuda_ms(lambda: wt.window_attention_block_core_plain(*p_det, b_det, masks, seed, keep, *static),
                        iters=5)
        out = wt.window_attention_block_core_plain(*prim, biases, masks, seed, keep, *static)
        p_bwd = cuda_ms(lambda: torch.autograd.grad(out, prim + biases, cot, retain_graph=True), iters=5)
        del out
        times[shift] = (k_fwd, k_bwd, p_fwd, p_bwd)
        add_split(split_fwd, kernel_split(lambda: wt._forward_cuda(st, p_det, b_det)), 6)
        add_split(split_bwd, kernel_split(lambda: wt._backward_cuda(st, p_det, b_det, cot)), 6)
    # the sub-kernels of one step's 12 + 12 calls and the bounds of their parts
    t, win = B * h * w, (2, 4, 8)
    ln_part = ln_proj_part(t, dim)
    fwd_parts = {"ln_proj_kernel": ln_part, **attn_fwd_parts(t, dim, win)}
    wparts = -(-t // 512) * (3 * dim * dim + 3 * dim)  # the weight gradients' per-chunk partials
    attn_parts, dbias_part = attn_bwd_parts(t, dim, win, h, w)
    bwd_parts = {"ln_proj_kernel": ln_part, **attn_parts,
                 "proj_ln_bwd_kernel": (4 * (3 * t * dim + 4 * t * dim + t // 64 * 4 * dim), 0.0, 2 * t * 3 * dim * dim),
                 "wgrad_kernel": (4 * (2 * t * dim + 3 * t * dim + wparts), 0.0, 2 * t * 3 * dim * dim),
                 "sum_rows_kernel": (4 * (dbias_part + wparts + t // 64 * 4 * dim), dbias_part + wparts, 0.0)}
    with torch.no_grad():
        lib = ln_linear_library(p_det[0], p_det[1], p_det[2:6], *p_det[6:10])
        l_ms = 12 * cuda_ms(lib)
    scale12 = lambda parts: {k: tuple(12 * v for v in p) for k, p in parts.items()}
    library = ("ln_proj_kernel", l_ms, "F.layer_norm + F.linear of both streams, TF32 off, 12 calls")
    log_split("K3 forward", split_fwd, scale12(fwd_parts), library)
    log_split("K3 backward", split_bwd, scale12(bwd_parts), library)
    return kernel_entries("K3", "window_attention_train", times, k3_cost(B, (h, w), dim, (2, 4, 8)),
                          worst_fwd, worst_grad, library=False)


def attn_bwd_chunks(n, gh, nw):
    """Blocks per image of a group's attention backward (csrc/window_train_common.cuh)."""
    if n == 4:
        return -(-nw // max(1, 32 // gh))
    wpb = 1 if n * gh >= 128 else 128 // (n * gh)
    return -(-nw // (4 * wpb))


# launches of one flagship train step under each core: 12 blocks (6 PGRMs x 2)
# forward and backward, 11 fused bidirectional GRU scans in the frozen PSN,
# no eval block
TRAIN_LAUNCHES = {
    "block": expected_counts(gru_bidir=11, window_attention_train_forward=12, window_attention_train_backward=12),
    "attention": expected_counts(gru_bidir=11, window_attention_core_forward=12, window_attention_core_backward=12),
    "full": expected_counts(gru_bidir=11, window_attention_full_forward=12, window_attention_full_backward=12),
}


def phase_train(dev, card, train_core, timed):
    """The flagship train_step at B = 64 with `train_core`: a warm-up step,
    one step whose launches are counted, `timed` timed steps; then card
    against CPU on 2 images.  Returns the launch counts of one step."""
    from dpmn_tpu_torch.config import TrainCfg, flagship_args
    from dpmn_tpu_torch.system import DPMNSystem

    tag = f"train[{train_core}]"
    t0 = time.perf_counter()
    system = DPMNSystem(TrainCfg(batch_size=B), flagship_args(), device=dev, seed=0, train_core=train_core)
    log(f"{tag}: flagship system built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in system.trainable_parameters()) / 1e6:.1f} M trainable parameters)")
    rng = np.random.RandomState(1)
    batches = [(rng.rand(B, 32, 128, 4).astype(np.float32), rng.rand(B, 16, 64, 4).astype(np.float32))
               for _ in range(2 + timed)]
    m = system.train_step(*batches[0], seed=0)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    m = system.train_step(*batches[1], seed=1)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"{tag}: launches in one step {launches} (expected {TRAIN_LAUNCHES[train_core]})")
    if launches != TRAIN_LAUNCHES[train_core]:
        raise AssertionError(f"{tag}: launch counts {launches}")
    loss, gnorm = m["loss"].item(), m["grad_norm"].item()
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        raise AssertionError(f"{tag}: loss {loss}, grad_norm {gnorm}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i, (hr, lr) in enumerate(batches[2:]):
        m = system.train_step(hr, lr, seed=2 + i)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed
    log(f"{tag}: flagship train_step B={B} fp32 dropout 0.1: {dt * 1e3:.2f} ms/step, {B / dt:.1f} images/s on {card}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; last loss {m['loss'].item():.4f} "
        f"grad_norm {m['grad_norm'].item():.4f}")
    del system

    # card against the CPU on 2 images, rates 0, the same weights.  Float32
    # gradients at B = 2 are determined only to a few % of a leaf: the CMM's
    # 1x4 bottleneck sees 8 values per channel, and a leaky-ReLU input within
    # rounding of 0 changes slope there, which moves every gradient upstream
    # (tests/test_torch_train.py); the biases ahead of a BatchNorm have a
    # gradient of 0 up to rounding.  So each leaf is held in norm, within 5 %
    # of its own norm plus 1e-4 of the whole gradient's, all of them together
    # within 1e-3, and loss and grad_norm tightly.
    zero = dict(drop_rate="0,", attn_drop_rate="0,", drop_path_rate="0,")
    systems = {d: DPMNSystem(TrainCfg(batch_size=2), flagship_args(**zero), device=d, seed=0, train_core=train_core)
               for d in (dev, "cpu")}
    hr, lr = batches[1][0][:2], batches[1][1][:2]
    res = {}
    for d, s in systems.items():
        ids = []
        hook = s.glyph.register_forward_hook(lambda mod, inp, out: ids.append(inp[0].cpu()))
        loss, grads = s._micro_grads(hr, lr, 0)
        hook.remove()
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).item()
        res[d] = (loss.item(), norm, [g.cpu() for g in grads], ids)
    (lg, ng, gg, ig), (lc, nc, gc, ic) = res[dev], res["cpu"]
    ids_ok = len(ig) == len(ic) == 3 and all(torch.equal(a, b) for a, b in zip(ig, ic))
    names = [n for n, p in systems["cpu"].named_parameters()
             if any(p is q for q in systems["cpu"].trainable_parameters())]
    worst, worst_name = max((((a - b).norm() / (5e-2 * b.norm() + 1e-4 * nc)).item(), n)
                            for n, a, b in zip(names, gg, gc))
    total = (torch.sqrt(sum(((a - b).double() ** 2).sum() for a, b in zip(gg, gc))) / nc).item()
    l_rel, n_rel = abs(lg - lc) / abs(lc), abs(ng - nc) / nc
    log(f"{tag}: card vs CPU on 2 images at rates 0: loss {lg:.6f} vs {lc:.6f} (rel {l_rel:.2e}, tol 1e-5); grad_norm "
        f"{ng:.4f} vs {nc:.4f} (rel {n_rel:.2e}, tol 1e-4); gradients: worst leaf {worst_name} at {worst:.3f} of its "
        f"tolerance (|diff| <= 5e-2 |ref| + 1e-4 grad_norm, in norm), all together {total:.2e} of their norm (tol "
        f"1e-3); students' ids equal {ids_ok}")
    if not (l_rel <= 1e-5 and n_rel <= 1e-4 and worst <= 1.0 and total <= 1e-3 and ids_ok):
        raise AssertionError(f"{tag}: card and CPU disagree on the train path")
    return launches


def phase_k4(dev):
    """K4 forward and backward against autograd through its plain version at
    B = 64 on q, k, v drawn at random: both shift sets, both layouts (the
    relayout runs after the core), keep 1 and 0.9; returns the kernels-line
    entries of its two entry points (timing fields per train step: 6
    unshifted + 6 shifted calls, faithful, keep 0.9)."""
    import torch.nn.functional as F

    from dpmn_tpu_torch.models.pgrm import SwinTransformerBlock
    from dpmn_tpu_torch.ops import window_attention_core as wc
    from dpmn_tpu_torch.ops import window_attention_train as wt

    h, w, dim, seed = 16, 64, 96, 4321
    gen = torch.Generator().manual_seed(6)
    leaf = lambda t: t.detach().clone().to(dev).requires_grad_()
    qkv = [leaf(torch.randn(B, h * w, dim, generator=gen)) for _ in range(3)]
    cot = torch.randn(B, h * w, dim, generator=gen).to(dev)
    worst_fwd, worst_grad, times, split_fwd, split_bwd = 0.0, 0.0, {}, {}, {}
    for shift in ((0, 0, 0), (1, 2, 4)):
        a = SwinTransformerBlock(dim, (h, w), 6, [2, 4, 8], list(shift)).attn
        biases = [leaf(0.1 * torch.randn(*b.shape, generator=gen)) for b in a.biases()]
        masks = [m.to(dev) if m is not None else None for m in a.masks()]
        static = (a.win, a.shf, a.gnum_heads, a.scale, a.hw)
        for layout in ("faithful", "corrected"):
            for keep in (1.0, 0.9):
                def run(fn):
                    out = fn(*qkv, biases, masks, seed, keep, *static)
                    if layout == "corrected":
                        out = wt.corrected_relayout(out, a.win, a.shf, a.hw)
                    return out, torch.autograd.grad(out, qkv + biases, cot)

                out, grads = run(wc.window_attention_core)
                ref, ref_grads = run(wc.window_attention_core_plain)
                err, gerr = hold_against_plain(f"K4 shift={shift} layout={layout} keep={keep}", out, ref, grads,
                                               ref_grads)
                worst_fwd, worst_grad = max(worst_fwd, err), max(worst_grad, gerr)
        keep = 0.9
        st = wt.make_static(masks, seed, keep, *static)
        q_det = [t.detach() for t in qkv]
        b_det = [t.detach() for t in biases]
        k_fwd = cuda_ms(lambda: wc._forward_cuda(st, q_det, b_det))
        k_bwd = cuda_ms(lambda: wc._backward_cuda(st, q_det, b_det, cot))
        add_split(split_fwd, kernel_split(lambda: wc._forward_cuda(st, q_det, b_det)), 6)
        add_split(split_bwd, kernel_split(lambda: wc._backward_cuda(st, q_det, b_det, cot)), 6)
        p_fwd = cuda_ms(lambda: wc.window_attention_core_plain(*q_det, b_det, masks, seed, keep, *static), iters=5)
        out = wc.window_attention_core_plain(*qkv, biases, masks, seed, keep, *static)
        p_bwd = cuda_ms(lambda: torch.autograd.grad(out, qkv + biases, cot, retain_graph=True), iters=5)
        del out
        # the library call: F.scaled_dot_product_attention on the
        # window-partitioned q, k, v of the call's three groups, bias + shift
        # mask as attn_mask (no dropout), forward and backward timed apart
        sdpa_args = sdpa_groups(a, b_det, masks, h, w, gen, dev)
        l_fwd = cuda_ms(lambda: [F.scaled_dot_product_attention(*qkv_g, attn_mask=m, scale=a.scale)
                                 for qkv_g, m, _ in sdpa_args])
        outs = [F.scaled_dot_product_attention(*qkv_g, attn_mask=m, scale=a.scale) for qkv_g, m, _ in sdpa_args]
        l_bwd = cuda_ms(lambda: [torch.autograd.grad(o, qkv_g, do, retain_graph=True)
                                 for o, (qkv_g, _, do) in zip(outs, sdpa_args)])
        del outs
        times[shift] = (k_fwd, k_bwd, p_fwd, p_bwd, l_fwd, l_bwd)
        log(f"K4 shift={shift}: host ms a call: forward {host_ms(lambda: wc._forward_cuda(st, q_det, b_det)):.4f}, "
            f"backward {host_ms(lambda: wc._backward_cuda(st, q_det, b_det, cot)):.4f}, of each the bias and mask "
            f"tables' packing {host_ms(lambda: wt.pack_tables(st, b_det, dev)):.4f}")
    # the sub-kernels of one step's 12 + 12 calls (per group) and the bounds of their parts
    t, win = B * h * w, (2, 4, 8)
    attn_parts, dbias_part = attn_bwd_parts(t, dim, win, h, w)
    scale12 = lambda parts: {k: tuple(12 * v for v in p) for k, p in parts.items()}
    log_split("K4 forward", split_fwd, scale12(attn_fwd_parts(t, dim, win)))
    log_split("K4 backward", split_bwd, scale12({**attn_parts, "sum_rows_kernel": (4 * dbias_part, dbias_part, 0.0)}))
    return kernel_entries("K4", "window_attention_core", times, k4_cost(B, (h, w), dim, (2, 4, 8)),
                          worst_fwd, worst_grad, library=True)


def phase_k5(dev):
    """K5 forward and backward against autograd through its plain version at
    B = 64: faithful layout (the only one it takes), both shift sets, keep 1
    and 0.9; returns the kernels-line entries of its two entry points (timing
    fields per train step, keep 0.9)."""
    from dpmn_tpu_torch.models.pgrm import SwinTransformerBlock
    from dpmn_tpu_torch.ops import window_attention_full as wf
    from dpmn_tpu_torch.ops import window_attention_train as wt
    from dpmn_tpu_torch.system import init_weights

    h, w, dim, seed = 16, 64, 96, 2468
    gen = torch.Generator().manual_seed(8)
    leaf = lambda t: t.detach().clone().to(dev).requires_grad_()
    xq = leaf(torch.randn(B, h * w, dim, generator=gen))
    xkv = leaf(torch.randn(B, h * w, dim, generator=gen))
    cot = torch.randn(B, h * w, dim, generator=gen).to(dev)
    worst_fwd, worst_grad, times, split_fwd, split_bwd = 0.0, 0.0, {}, {}, {}
    for shift in ((0, 0, 0), (1, 2, 4)):
        blk = SwinTransformerBlock(dim, (h, w), 6, [2, 4, 8], list(shift))
        init_weights(blk, seed=9)
        a = blk.attn
        rnd = lambda *shape: leaf(0.1 * torch.randn(*shape, generator=gen))
        prim = [xq, xkv, leaf(1 + 0.1 * torch.randn(dim, generator=gen)), rnd(dim),
                leaf(1 + 0.1 * torch.randn(dim, generator=gen)), rnd(dim), leaf(a.q.weight), rnd(dim),
                leaf(a.kv.weight), rnd(2 * dim)] + [leaf(t) if t.dim() == 2 else rnd(*t.shape)
                                                    for t in a.SKConv.weights()]
        biases = [rnd(*b.shape) for b in a.biases()]
        masks = [m.to(dev) if m is not None else None for m in a.masks()]
        static = (a.win, a.shf, a.gnum_heads, a.scale, a.hw)
        for keep in (1.0, 0.9):
            def run(fn):
                out = fn(*prim, biases, masks, seed, keep, *static)
                return out, torch.autograd.grad(out, prim + biases, cot)

            out, grads = run(wf.window_attention_full_core)
            ref, ref_grads = run(wf.window_attention_full_core_plain)
            err, gerr = hold_against_plain(f"K5 shift={shift} keep={keep}", out, ref, grads, ref_grads)
            worst_fwd, worst_grad = max(worst_fwd, err), max(worst_grad, gerr)
        keep = 0.9
        st = wt.make_static(masks, seed, keep, *static)
        p_det = [t.detach() for t in prim]
        b_det = [t.detach() for t in biases]
        kept = wf._forward_cuda(st, p_det, b_det)[1]
        k_fwd = cuda_ms(lambda: wf._forward_cuda(st, p_det, b_det))
        k_bwd = cuda_ms(lambda: wf._backward_cuda(st, p_det, b_det, cot, kept))
        p_fwd = cuda_ms(lambda: wf.window_attention_full_core_plain(*p_det, b_det, masks, seed, keep, *static),
                        iters=5)
        out = wf.window_attention_full_core_plain(*prim, biases, masks, seed, keep, *static)
        p_bwd = cuda_ms(lambda: torch.autograd.grad(out, prim + biases, cot, retain_graph=True), iters=5)
        del out
        times[shift] = (k_fwd, k_bwd, p_fwd, p_bwd)
        add_split(split_fwd, kernel_split(lambda: wf._forward_cuda(st, p_det, b_det)), 6)
        add_split(split_bwd, kernel_split(lambda: wf._backward_cuda(st, p_det, b_det, cot, kept)), 6)
    fwd_parts, bwd_parts = k5_parts(B * h * w, dim, (2, 4, 8), h, w)
    scale12 = lambda parts: {k: tuple(12 * v for v in p) for k, p in parts.items()}
    log_split("K5 forward", split_fwd, scale12(fwd_parts))
    log_split("K5 backward", split_bwd, scale12(bwd_parts))
    return kernel_entries("K5", "window_attention_full", times, k5_cost(B, (h, w), dim, (2, 4, 8)),
                          worst_fwd, worst_grad, library=False)


def k5_parts(t, dim, win, h, w):
    """{sub-kernel: (bytes, CUDA-core operations, tensor-core operations)}
    of one K5 forward and one backward call on t tokens: K3's parts, and
    SKConv's: forward feats = t Wp^T (+ the GAP sums), the gate, out = feats
    + fv Wph^T; backward pass A (dfv = dout Wph, fv, the dw sums, dWph =
    dout^T fv), the gate and fc backward, pass B (feats again, dt = dfeats
    Wp + dfv w, dWp = dfeats^T t); the weight-gradient partials of the
    persistent passes (one row a CTA, at most 132) in sum_rows."""
    ch = dim // len(win)
    io = 4 * t * dim
    grid = min(132, t // 64)
    parts_wgrad = grid * (dim * dim + dim + dim * ch + dim)
    wparts = -(-t // 512) * (3 * dim * dim + 3 * dim)
    attn_parts, dbias_part = attn_bwd_parts(t, dim, win, h, w)
    fwd = {"ln_proj_kernel": ln_proj_part(t, dim), **attn_fwd_parts(t, dim, win),
           "skconv_proj_kernel": (2 * io + 4 * t // 64 * dim, 0.0, 2 * t * dim * dim),
           "skconv_gate_kernel": (4 * t // 64 * dim, 0.0, 0.0),
           "skconv_out_kernel": (3 * io, 2 * t * dim, 2 * t * ch * dim)}
    bwd = {"ln_proj_kernel": ln_proj_part(t, dim),
           "skconv_bwd_a_kernel": (2 * io + 4 * t * ch + 4 * (t // 64 + grid) * dim, 4 * t * dim,
                                   2 * 2 * t * dim * ch),
           "skconv_gate_bwd_kernel": (4 * (t // 64 * 2 * dim), 0.0, 0.0),
           "skconv_bwd_b_kernel": (3 * io + 4 * t * ch + 4 * grid * dim * dim, 4 * t * dim, 3 * 2 * t * dim * dim),
           **attn_parts,
           "proj_ln_bwd_kernel": (4 * (3 * t * dim + 4 * t * dim + t // 64 * 4 * dim), 0.0, 2 * t * 3 * dim * dim),
           "wgrad_kernel": (4 * (2 * t * dim + 3 * t * dim + wparts), 0.0, 2 * t * 3 * dim * dim),
           "sum_rows_kernel": (4 * (dbias_part + wparts + parts_wgrad + t // 64 * 4 * dim),
                               dbias_part + wparts + parts_wgrad, 0.0)}
    return fwd, bwd


# the pallas_call lines of the TPU kernels K3-K9 replace (K3-K5: forward, backward)
REPLACES = {"window_attention_train": ("dpmn_tpu/ops/pallas_window_train.py:399",
                                       "dpmn_tpu/ops/pallas_window_train.py:525"),
            "window_attention_core": ("dpmn_tpu/ops/pallas_window_train.py:147",
                                      "dpmn_tpu/ops/pallas_window_train.py:229"),
            "window_attention_full": ("dpmn_tpu/ops/pallas_window_train.py:766",
                                      "dpmn_tpu/ops/pallas_window_train.py:952"),
            "mlp_convs": "dpmn_tpu/ops/pallas_mlp.py:76",
            "grouped_window_attention": "dpmn_tpu/ops/pallas_window.py:135",
            "window_tile_attention": "dpmn_tpu/ops/pallas_kernels.py:140",
            "dropout_mask": "tools/debug_train_dropout.py:39"}


def kernel_entries(tag, name, times, cost, worst_fwd, worst_grad, library):
    """Log the per-call times against the bounds; return the kernels-line
    entries of a training core's forward and backward, per train step (6
    unshifted + 6 shifted calls).  times[shift] = (kernel fwd, kernel bwd,
    plain fwd, plain bwd[, library fwd, library bwd]) in ms per call."""
    fb_ms, fb_by = bound_ms(cost["fwd_bytes"], cost["fwd_flops"])
    bb_ms, bb_by = bound_ms(cost["bwd_bytes"], cost["bwd_flops"])
    for shift, t in times.items():
        lib = f"; library (SDPA) fwd {t[4]:.4f} bwd {t[5]:.4f}" if library else ""
        log(f"{tag} B={B} shift={shift} keep=0.9: forward kernel_ms {t[0]:.4f} plain_ms {t[2]:.4f} bound_ms "
            f"{fb_ms:.4f} ({fb_by}; {cost['fwd_bytes'] / 1e6:.1f} MB, {cost['fwd_flops'] / 1e9:.2f} GFLOP); backward "
            f"kernel_ms {t[1]:.4f} plain_ms {t[3]:.4f} bound_ms {bb_ms:.4f} ({bb_by}; {cost['bwd_bytes'] / 1e6:.1f} MB, "
            f"{cost['bwd_flops'] / 1e9:.2f} GFLOP){lib}")
    per_step = lambda i: 6 * (times[(0, 0, 0)][i] + times[(1, 2, 4)][i])
    common = {"route": "cuda", "source": f"dpmn_tpu_torch/csrc/{name}.cu"}
    fwd = {"name": f"{name}_forward", **common, "replaces": REPLACES[name][0], "max_abs_err": worst_fwd,
           "ms": per_step(0), "plain_ms": per_step(2), "bound_ms": 12 * fb_ms, "bound_by": fb_by,
           "library_ms": per_step(4) if library else None}
    bwd = {"name": f"{name}_backward", **common, "replaces": REPLACES[name][1], "max_abs_err": worst_grad,
           "ms": per_step(1), "plain_ms": per_step(3), "bound_ms": 12 * bb_ms, "bound_by": bb_by,
           "library_ms": per_step(5) if library else None}
    return fwd, bwd


def standalone_entry(name, max_abs_err, launches, ms, plain_ms, bound, library_ms, suffix=""):
    """The kernels-line entry of a standalone kernel (K6-K9): `bound` is a
    {"bytes": ms, "operations": ms} split of its bound; bound_by names the
    larger part."""
    return {"name": name + suffix, "route": "cuda", "source": f"dpmn_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": sum(bound.values()), "bound_by": max(bound, key=bound.get),
            "library_ms": library_ms}


def flagship_attention(shift, gen, dev):
    """A flagship WindowAttention (16x64 grid, dim 96, windows 2/4/8, 6 heads)
    with relative-position tables drawn from `gen`, on the card."""
    from dpmn_tpu_torch.models.pgrm import WindowAttention

    a = WindowAttention(96, [2, 4, 8], list(shift), 6, (16, 64))
    with torch.no_grad():
        for i in range(3):
            getattr(a, f"relative_position_bias_table_{i}").normal_(0, 0.1, generator=gen)
    return a.to(dev)


def phase_k8(dev):
    """K8's entry point once at each of the flagship's three folded window
    shapes at B = 64 (W = B x nW x heads windows of one shifted block's
    group, bias and shift mask materialized per window) and at the JAX
    test's (10, 16, 8) without a mask; returns its kernels-line entry
    (timing fields summed over the four calls).  Library call:
    F.scaled_dot_product_attention on (W, 1, N, C) with bias + mask added
    beforehand as its float attn_mask, scale 1."""
    import torch.nn.functional as F

    from dpmn_tpu_torch.ops.window_tile_attention import window_tile_attention, window_tile_attention_plain

    gen = torch.Generator().manual_seed(10)
    a = flagship_attention((1, 2, 4), gen, dev)
    cases = []
    for ws, bias, mask in zip(a.win, a.biases(), a.masks()):
        n, nw = ws * ws, mask.shape[0]
        w = B * nw * a.gnum_heads
        fold = lambda t: t.expand(B, nw, a.gnum_heads, n, n).reshape(w, n, n).contiguous()
        cases.append(((w, n, 16), fold(bias.detach()[None, None]), fold(mask[None, :, None])))
    cases.append(((10, 16, 8), (0.1 * torch.randn(10, 16, 16, generator=gen)).to(dev), None))
    inputs = []
    for (w, n, c), bias, mask in cases:
        q = (c**-0.5 * torch.randn(w, n, c, generator=gen)).to(dev)  # pre-scaled
        k, v = (torch.randn(w, n, c, generator=gen).to(dev) for _ in range(2))
        inputs.append((q, k, v, bias, mask))
    reset_counts()
    outs = [window_tile_attention(*args) for args in inputs]
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts("K8", launches, window_tile_attention=len(inputs))
    worst, tot, bound = 0.0, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}, {"bytes": 0.0, "operations": 0.0}
    slower = []
    for (q, k, v, bias, mask), out in zip(inputs, outs):
        w, n, c = q.shape
        ref = window_tile_attention_plain(q, k, v, bias, mask)
        err = (out - ref).abs().max().item()
        attn_mask = (bias if mask is None else bias + mask)[:, None]
        lib = lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None], attn_mask=attn_mask,
                                                     scale=1.0)
        lib_err = (lib()[:, 0] - ref).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and err <= K8_TOL
        nbytes = 4 * (4 * w * n * c + (1 if mask is None else 2) * w * n * n)
        flops = 4 * w * n * n * c
        b_ms, b_by = bound_ms(nbytes, flops)
        k_ms, p_ms, l_ms = cuda_ms(lambda: window_tile_attention(q, k, v, bias, mask)), cuda_ms(
            lambda: window_tile_attention_plain(q, k, v, bias, mask), iters=5), cuda_ms(lib)
        # the kernel's own device time (torch.profiler): at the small shapes the
        # entry point's time is the host's work of a call
        split = kernel_split(lambda: window_tile_attention(q, k, v, bias, mask))
        device = f"{sum(ms for ms, _ in split.values()):.4f}" if split else "not measured"
        log(f"K8 (W, N, C)=({w}, {n}, {c}) mask={mask is not None}: max_abs_err {err:.3e} (tol {K8_TOL:g}) "
            f"{'ok' if ok else 'FAIL'}; kernel_ms {k_ms:.4f} (device {device}) plain_ms {p_ms:.4f} library_ms "
            f"{l_ms:.4f} (SDPA, |diff| {lib_err:.1e}) bound_ms {b_ms:.4f} ({b_by}; {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.3f} GFLOP)")
        if not ok:
            raise AssertionError(f"K8 disagrees with its plain version: {err}")
        if mask is not None and k_ms >= l_ms:  # a flagship shape
            slower.append(f"(W, N, C)=({w}, {n}, {c}): {k_ms:.4f} ms against SDPA's {l_ms:.4f}")
        worst = max(worst, err)
        for key, t in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms)):
            tot[key] += t
        bound[b_by] += b_ms
    if slower:
        raise AssertionError(f"K8 is not faster than SDPA at {'; '.join(slower)}")
    return standalone_entry("window_tile_attention", worst, launches["window_tile_attention"], tot["ms"],
                            tot["plain_ms"], bound, tot["library_ms"])


def device_and_host(fn):
    """A standalone entry point's device time a launch and launches a call
    by kernel (torch.profiler, which drops some events: fewer than 1 launch
    a call recorded) and the host's time a call, as a log fragment; no
    number of the kernels line comes from here."""
    split = kernel_split(fn)
    device = ", ".join(f"{name} {ms / n:.4f} ms a launch, {n:g} launches a call recorded"
                       for name, (ms, n) in split.items()) or "not measured"
    return f"device {device}; host {host_ms(fn):.4f} ms a call"


def k7_cost(a, dtype, h, w):
    """Bytes and float32 operations of one K7 call at B: K4's forward (q, k,
    v and out, in the io type) plus the bias tables (io type) and shift
    masks (float32) read once."""
    cost = k4_cost(B, (h, w), 96, a.win)
    io = torch.tensor([], dtype=dtype).element_size()
    tables = io * sum(b.numel() for b in a.biases()) + 4 * sum(m.numel() for m in a.masks() if m is not None)
    return cost["fwd_bytes"] * io // 4 + tables, cost["fwd_flops"]


def sdpa_windows(a, q, k, v, dtype):
    """One K7 call's attention as F.scaled_dot_product_attention takes it: per
    group the rolled, window-partitioned q, k, v (B*nW, heads, N, 16) and
    bias [+ shift mask] as a float attn_mask, in the io type."""
    from dpmn_tpu_torch.ops.window_attention import _window_partition

    args = []
    for g, (ws, sh, bias, mask) in enumerate(zip(a.win, a.shf, a.biases(), a.masks())):
        n = ws * ws

        def part(t):
            t = t[..., g * 32:(g + 1) * 32]
            if sh > 0:
                t = torch.roll(t, (-sh, -sh), dims=(1, 2))
            t = _window_partition(t, ws)
            return t.reshape(t.shape[0], n, a.gnum_heads, 16).permute(0, 2, 1, 3).contiguous()

        bw = B * (16 // ws) * (64 // ws)
        m = bias.detach()[None].expand(bw, -1, -1, -1)
        if sh > 0:
            m = (bias.detach()[None, None] + mask[None, :, None]).expand(B, -1, -1, -1, -1).reshape(bw, -1, n, n)
        args.append((part(q), part(k), part(v), m.to(dtype).contiguous()))
    return args


def phase_k7(dev):
    """K7's entry point at B = 64 on both shift sets, float32 then bf16, each
    dtype's pair of calls counted as one run of its path; returns the
    kernels-line entries of both io types (timing fields summed over the
    pair of calls)."""
    import torch.nn.functional as F

    from dpmn_tpu_torch.ops.grouped_window_attention import grouped_window_attention, grouped_window_attention_plain

    h, w = 16, 64
    gen = torch.Generator().manual_seed(11)
    attns = [flagship_attention(shift, gen, dev) for shift in ((0, 0, 0), (1, 2, 4))]
    q32, k32, v32 = ((0.5 * torch.randn(B, h, w, 96, generator=gen)).to(dev) for _ in range(3))
    entries, out32 = [], {}
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        calls = [(q, k, v, [b.detach().to(dtype) for b in a.biases()], a.masks(), a.win, a.shf, a.gnum_heads,
                  a.scale) for a in attns]
        reset_counts()
        outs = [grouped_window_attention(*args) for args in calls]
        torch.cuda.synchronize()
        launches = read_counts()
        check_counts(f"K7 {dtype}", launches, grouped_window_attention=len(calls))
        worst, tot, bound = 0.0, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}, {"bytes": 0.0, "operations": 0.0}
        for a, args, out in zip(attns, calls, outs):
            ref = grouped_window_attention_plain(*args)
            err = (out.float() - ref.float()).abs().max().item()
            tol = K7_TOL if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
            ok = bool(torch.isfinite(out).all()) and out.dtype == dtype and err <= tol
            extra = ""
            if dtype == torch.float32:
                out32[tuple(a.shf)] = out
            else:
                f32 = out32[tuple(a.shf)]
                excess = ((out.float() - f32).abs() - (K7_BF16_ATOL + K7_BF16_RTOL * f32.abs())).max().item()
                ok = ok and excess <= 0
                extra = (f"; against the float32 kernel max abs {(out.float() - f32).abs().max().item():.3e} "
                         f"(rtol {K7_BF16_RTOL:g}, atol {K7_BF16_ATOL:g})")
            sdpa = sdpa_windows(a, q, k, v, dtype)
            lib = lambda: [F.scaled_dot_product_attention(qg, kg, vg, attn_mask=m, scale=a.scale)
                           for qg, kg, vg, m in sdpa]
            nbytes, flops = k7_cost(a, dtype, h, w)
            b_ms, b_by = bound_ms(nbytes, flops)
            k_ms, p_ms, l_ms = cuda_ms(lambda: grouped_window_attention(*args)), cuda_ms(
                lambda: grouped_window_attention_plain(*args), iters=5), cuda_ms(lib)
            log(f"K7 {dtype} B={B} shift={tuple(a.shf)}: max_abs_err {err:.3e} (tol {tol:.3e}){extra} "
                f"{'ok' if ok else 'FAIL'}; kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms {l_ms:.4f} (SDPA on "
                f"the partitioned windows) bound_ms {b_ms:.4f} ({b_by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
                f"GFLOP); {device_and_host(lambda: grouped_window_attention(*args))}")
            if not ok:
                raise AssertionError(f"K7 {dtype} disagrees with its plain version or the float32 kernel: {err}")
            worst = max(worst, err)
            for key, t in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms)):
                tot[key] += t
            bound[b_by] += b_ms
        entries.append(standalone_entry("grouped_window_attention", worst, launches["grouped_window_attention"],
                                        tot["ms"], tot["plain_ms"], bound, tot["library_ms"], suffix))
    return entries


def phase_k6(dev):
    """K6's entry point once at B = 64 and the flagship Mlp (HW 1024, s 32,
    hidden 384) with random weights; returns its kernels-line entry.
    Library call: the cuDNN depthwise conv, GELU and 1x1 conv that the
    port's Mlp runs (its own modules; TF32 off), which is also what the plain
    version computes."""
    import torch.nn.functional as F

    from dpmn_tpu_torch.models.pgrm import Mlp
    from dpmn_tpu_torch.ops.mlp_convs import mlp_convs, mlp_convs_plain

    hw, hidden, s = 1024, 384, 32
    gen = torch.Generator().manual_seed(12)
    mlp = Mlp(96, hidden, (16, 64))
    with torch.no_grad():
        mlp.dwconv.weight.copy_(torch.randn(hidden, 1, 3, 3, generator=gen) / 3)
        mlp.pwconv.weight.copy_(torch.randn(hidden, hidden, 1, 1, generator=gen) / hidden**0.5)
        for conv in (mlp.dwconv, mlp.pwconv):
            conv.bias.copy_(0.1 * torch.randn(hidden, generator=gen))
    mlp = mlp.to(dev)
    x = torch.randn(B, hw, hidden, generator=gen).to(dev)
    with torch.no_grad():
        weights = (mlp.dwconv.weight, mlp.dwconv.bias, mlp.pwconv.weight, mlp.pwconv.bias)
        reset_counts()
        out = mlp_convs(x, *weights)
        torch.cuda.synchronize()
        launches = read_counts()
        check_counts("K6", launches, mlp_convs=1)
        ref = mlp_convs_plain(x, *weights)
        err = (out - ref).abs().max().item()
        lib = lambda: mlp.pwconv(F.gelu(mlp.dwconv(x.view(B, hidden, s, s)))).view(B, hw, hidden)
        lib_err = (lib() - out).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and err <= K6_TOL
        nbytes = 4 * (2 * B * hw * hidden + hidden * 9 + hidden * hidden + 2 * hidden)
        flops = 2 * B * hidden * hidden * hw + 2 * 9 * B * hidden * hw
        b_ms, b_by = bound_ms(nbytes, flops)
        k_ms, p_ms, l_ms = cuda_ms(lambda: mlp_convs(x, *weights)), cuda_ms(lambda: mlp_convs_plain(x, *weights),
                                                                            iters=5), cuda_ms(lib)
        split = kernel_split(lambda: mlp_convs(x, *weights))
    mix = 2 * B * hidden * hidden * hw  # the 1x1 mix, on the tensor cores as 3xTF32
    tc_ms, _ = bound_ms(0, 0, mix)
    log(f"K6 B={B} HW={hw} hidden={hidden}: max_abs_err {err:.3e} (tol {K6_TOL:g}) {'ok' if ok else 'FAIL'}; "
        f"kernel_ms {k_ms:.4f} ({flops / k_ms / 1e9:.1f} TFLOP/s; the mix's 3xTF32 at {3 * mix / k_ms / 1e9:.1f} "
        f"TFLOP/s of TF32 work) plain_ms {p_ms:.4f} library_ms {l_ms:.4f} (cuDNN depthwise + GELU + 1x1 of the port's "
        f"Mlp, |diff| {lib_err:.1e}) bound_ms {b_ms:.4f} ({b_by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
        f"tensor-core bound {tc_ms:.4f} (3 x {mix / 1e9:.2f} GFLOP at 495 TFLOP/s)")
    log_split("K6", split, {"mlp_convs_kernel": (nbytes, flops - mix, mix)})
    if not ok:
        raise AssertionError(f"K6 disagrees with its plain version: {err}")
    if k_ms >= l_ms:
        raise AssertionError(f"K6 ({k_ms:.4f} ms) is not faster than the cuDNN pair ({l_ms:.4f} ms)")
    return standalone_entry("mlp_convs", err, launches["mlp_convs"], k_ms, p_ms, {b_by: b_ms}, l_ms)


def phase_k9(dev):
    """K9's path: the masks of one seed at B = 64 and the flagship geometry,
    then the port's debug_train_dropout tool at its own geometry (B = 4,
    seed 7: one more dump, K4's forward and backward); returns its
    kernels-line entry (timing fields of the B = 64 dump).  The B = 64
    masks must equal the plain version's exactly; the tool's forward and
    q-gradient differences are held at K3's tolerances.  No PyTorch call
    computes these masks."""
    from dpmn_tpu_torch.ops.dropout_mask import dropout_mask, dropout_mask_plain
    from dpmn_tpu_torch.tools import debug_train_dropout as tool

    seed, keep = 4242, 0.9
    geo = (tool.WINDOWS, tool.HEADS, (tool.H, tool.W))
    reset_counts()
    masks = dropout_mask(seed, B, keep, *geo, dev)
    r = tool.check(dev)
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts("K9", launches, dropout_mask=2, window_attention_core_forward=1, window_attention_core_backward=1)
    ref = dropout_mask_plain(seed, B, keep, *geo, dev)
    err = max((a - b).abs().max().item() for a, b in zip(masks, ref))
    exact = all(torch.equal(a, b) for a, b in zip(masks, ref))
    kept = sum(int((m > 0).sum()) for m in masks) / sum(m.numel() for m in masks)
    tool_ok = (r["fwd_max_abs"] <= K3_TOL
               and r["grad_max_abs"] <= K3_GRAD_RTOL * r["grad_scale"] + K3_GRAD_ATOL)
    log(f"K9 B={B}: masks equal to the plain version's {exact} (max abs {err:g}), keep fraction {kept:.5f}; tool "
        f"(B=4, seed 7) keep fraction {r['keep_fraction']:.5f}, K4 forward vs the explicit-mask rebuild max abs "
        f"{r['fwd_max_abs']:.3e} (tol {K3_TOL:g}), q-gradient {r['grad_max_abs']:.3e} (tol {K3_GRAD_RTOL:g} * "
        f"{r['grad_scale']:.3f} + {K3_GRAD_ATOL:g}) {'ok' if exact and tool_ok else 'FAIL'}")
    if not (exact and tool_ok):
        raise AssertionError("K9: the dumped masks differ from the plain version's, or the core from the rebuild")
    times = {}
    for batch in (B, 4):
        nbytes = 4 * sum(m.numel() for m in masks) * batch // B
        b_ms, b_by = bound_ms(nbytes, 0)
        k_ms = cuda_ms(lambda: dropout_mask(seed, batch, keep, *geo, dev))
        p_ms = cuda_ms(lambda: dropout_mask_plain(seed, batch, keep, *geo, dev), iters=3)
        log(f"K9 B={batch}: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}; "
            f"{nbytes / 1e6:.1f} MB written; the integer hash chain not counted); "
            f"{device_and_host(lambda: dropout_mask(seed, batch, keep, *geo, dev))}")
        times[batch] = (k_ms, p_ms, {b_by: b_ms})
    # the entry times the B = 64 dump alone; the tool's B = 4 dump is only logged
    return standalone_entry("dropout_mask", err, launches["dropout_mask"], *times[B], None)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the machine with the card", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda:0")
    card = phase_setup()
    k1 = phase_window_attention(dev)
    k2 = phase_gru(dev)
    launches, system, cpu, batches, sr32 = phase_path(dev, card)
    # K2 counts the launches of both its entry points (the path goes through gru_bidir alone)
    k1["launches"], k2["launches"] = launches["window_attention_block"], launches["gru_bidir"] + launches["gru_scan"]
    k1_bf16 = phase_window_attention_bf16(dev)
    k1_bf16["launches"] = phase_serving(dev, card, system, cpu, batches, sr32)["window_attention_block"]
    phase_judges(dev, card, system, batches)
    del system, cpu
    torch.cuda.empty_cache()
    entries = [k1, k1_bf16, k2]
    for phase_kernel, core, name, timed in ((phase_k3, "block", "window_attention_train", 4),
                                            (phase_k4, "attention", "window_attention_core", 3),
                                            (phase_k5, "full", "window_attention_full", 3)):
        fwd, bwd = phase_kernel(dev)
        launches = phase_train(dev, card, core, timed)
        fwd["launches"], bwd["launches"] = launches[f"{name}_forward"], launches[f"{name}_backward"]
        entries += [fwd, bwd]
    entries.append(phase_k8(dev))
    entries += phase_k7(dev)
    entries.append(phase_k6(dev))
    entries.append(phase_k9(dev))
    log(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
