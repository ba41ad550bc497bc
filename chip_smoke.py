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
     -sass), and bf16 m16n8k16 products in the bf16 attention forwards (K7's,
     and the training cores' on bf16 io with a float32 bias: K4's
     window_attn_fwd_train_kernel, K3's and K5's one-launch
     window_block_fwd_bf16_kernel);
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
  8b. for each training core, K3, K4 and K5 on bf16 io (the bf16 AMP step's
     cores) forward and backward against autograd through the plain version
     at B = 64 and the flagship geometry: both shift sets, faithful layout,
     dropout off and at keep 0.9 (K4's k and v the halves of one kv
     tensor); the output within 2^-7 of max|out|, each gradient within 2^-6
     of its largest value, the dtypes (bf16, dbias float32); K3 also with 3
     heads a group and with a scale that is not a power of two; the times a
     call beside the float32 kernel on the same values (K4 also beside SDPA
     on bf16); the backwards of K3, K4 and K5 and K5's forward split by
     sub-kernel, their launches a call held exact by the library's own
     count; then the train path under train_dtype="bfloat16" with that
     core as phase 6, with exact launches (the bf16 kernel 12 + 12, no
     float32 training kernel, K2 11), the state float32 after the steps,
     the loss finite and falling over 5 steps on one repeated batch, and
     the card against the CPU on 2 images (hold_amp_card_vs_cpu);
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
 13. the driver (dpmn_tpu_torch.train.Trainer) end to end at the flagship
     geometry, B = 64, on an LMDB of the committed JPEG fixture's records
     (tests/fixtures/textzoom_jpeg.npz, 4 times over): the native LMDB reader
     against the Python one on every key and each record's decode against
     the fixture's digests of PIL's; Trainer.train over 8 steps with thread
     workers, one validation (ASTER, 2 batches) and one save, with exact
     launch counts of one loop step (K2 11, K3 12 + 12) and one validation
     batch (K1 12, K2 11), the loop's ms/step beside phase 6's bare step and
     its device busy share (torch.profiler); a fresh Trainer resumed from
     checkpoint.pt (its next two losses within 1e-5 of the writer's); one
     accum_train_step at batch 256 in 4 microbatches (ms, peak memory) and
     accumulation over 2 microbatches of 2 on the card against the CPU as in
     phase 6; test() over 4 batches with 0, 1 and 4 workers (images/s,
     against phase 4b's glyph_from_psn + phase 4c's ASTER); the CLI's --test
     in a subprocess that cannot import cv2, yaml or JAX;
 14. the other PSNs and the reference's checkpoints: the flagship with
     --arch tsrn, tpgsr and tbsrn (mask on) and tsrn on unmasked 3-channel
     LR at B = 64 — exact launches of one forward (K1 12; K2 10, 10, 0,
     10), ms and images/s over 4 timed batches, the PSN stage's ms (CUDA
     events), peak memory, and the card against the CPU on 2 images (SR
     within 1e-4, glyph ids equal); `tg` builds TSRN; then a seeded
     flagship written as the reference's .pth files (the inverse of the key
     maps, dead keys included) under the git-ignored chip_smoke_run/, read
     back by load_driver_weights(testing=True) bit for bit with the same
     forward (within 1e-6: the card's forward is not bitwise
     reproducible), and the CLI's --test --resume DIR --rec_path DIR on
     them with cv2, yaml and JAX blocked;
 15. the geometries the JAX package runs beyond the flagship's head dim 16
     (GEOMETRIES): the flagship at --num_heads 3 (head dim 32) and 12
     (head dim 8), and the JAX package's "mid" and "toy" geometries, each
     at B = 64: sr_forward, sr_forward_bf16 and the train steps listed
     there with exact launches, images/s and peak memory, and the card
     against the CPU on 2 images (SR and ids, each float32 step as phase 6
     and each bf16 AMP step as phase 8b holds the flagship's); then K1,
     K3-K5 on both io types, K7 and K2 at each geometry's blocks against
     their plain versions, with times and bounds;
 16. one JSON line with every kernel's numbers, then the final JSON line.

Times are CUDA-event times after warm-up, with the inputs resident in L2
where they fit.  `ms`, `plain_ms`, `library_ms` and `bound_ms` in the kernels
line are per call of the path that launches the kernel: K1 and K2 per
flagship forward (the sum over their launches in one sr_forward at B = 64),
K3, K4 and K5 per flagship train step on their path (12 forward and 12
backward launches; the bf16 entry points of K3, K4 and K5 per bf16 AMP
step, bounded by bf16 bytes, the products on bf16 operands at 989 TFLOP/s
and K5's SKConv in float32); the standalone kernels K6-K9 per run of their phase's
path (the launches it counts).  Bounds use the published H100 SXM peaks:
3.35 TB/s and 67 TFLOP/s float32 on the CUDA cores; a sub-kernel's bound
counts a product it runs on the tensor cores as 3xTF32 at 3 x its operations
over 495 TFLOP/s.  It imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12  # dense, on the tensor cores
BF16_FLOP_PER_S = 989e12  # dense, on the tensor cores
# the sub-kernels whose products run on the tensor cores (3xTF32, or bf16
# for K1's bf16 LN + projection and K3's and K5's bf16 backward): mma.sync
# (HMMA in their machine code), K6's on wgmma (HGMMA)
TC_KERNELS = ("ln_proj_kernel", "ln_proj_bf16_kernel", "skconv_proj_kernel", "skconv_out_kernel", "proj_ln_bwd_kernel", "wgrad_kernel",
              "window_attn_bwd_tc_kernel", "skconv_bwd_a_kernel", "skconv_bwd_b_kernel", "mlp_convs_kernel",
              "window_attn_fwd_kernel", "tile_attn_tc_kernel", "window_attn_bwd_tc_bf16_kernel",
              "proj_ln_bwd_bf16_kernel", "wgrad_bf16_kernel", "window_attn_fwd_train_kernel",
              "window_block_fwd_bf16_kernel")
# the training cores' bf16 forward kernels (K4's attention, K3's one launch,
# K5's front): bf16 m16n8k16 products in every instance
BF16_FWD_KERNELS = ("window_attn_fwd_train_kernel", "window_block_fwd_bf16_kernel")
# the bf16 backwards' product kernels: bf16 m16n8k16 and no TF32 product in
# their machine code (K3's and K5's libraries)
BF16_BWD_KERNELS = ("window_attn_bwd_tc_bf16_kernel", "proj_ln_bwd_bf16_kernel", "wgrad_bf16_kernel")
# the libraries that launch SKConv's token kernels on bf16 weights (K1's
# serving forward, K5's bf16 forward), at every embedding width 16-96.  Its
# products on bf16 weights take two TF32 passes where float32 weights take
# three (mma_2xtf32: the widened weight is exact in TF32).
# skconv_proj_kernel's runs over K = D, unrolled whole, so the bf16
# instance holds two thirds of the float32 one's HMMA.  skconv_out_kernel's
# runs over K = ch, a run-time count: the float32 instance keeps one k-step
# (3 x its m16n8 tile pairs), which nvcc unrolls in the bf16 instance (7
# steps at D = 96), so that instance holds a whole number of two-pass steps
# of as many tile pairs.
SKCONV_LIBS = ("window_attention", "window_attention_full")
# the widening and narrowing passes that no bf16 backward (K3, K4, K5)
# launches
WIDENING_KERNELS = ("convert_kernel", "bf16_rows_kernel")
# kernel launches of one bf16 backward call at the flagship geometry (three
# window groups): K4 each group's attention backward and dbias sum; K3 adds
# the LN + projection, the two projections' dx, LN sums, dW and dW sums; K5
# adds SKConv's six (pass A, its dW sum, the gate, the fc gradients, pass B,
# its dW sum)
BF16_BWD_LAUNCHES = {"block": 15, "attention": 6, "full": 21}
# kernel launches of one bf16 forward call: K3 one (LN, projections and the
# attention of every group), K4 one (the attention of every group), K5 K3's
# one with float32 tokens and SKConv's three
BF16_FWD_LAUNCHES = {"block": 1, "attention": 1, "full": 4}
B = 64
K1_TOL = 1e-4  # max abs error: float32, other summation orders over <= 96-term sums
K2_TOL = 1e-5  # max abs error of a tanh-bounded state after <= 64 float32 steps
K3_TOL = 1e-4  # forward max abs error: as K1
K3_GRAD_RTOL, K3_GRAD_ATOL = 1e-4, 1e-5  # per gradient: max abs <= rtol * max|ref| + atol (sums over 65536 tokens)
# K4 and K5 are held as K3: forward max abs K3_TOL, each gradient as above
K6_TOL = 1e-4  # max abs error: float32 sums of 9 and 384 terms in other orders
K7_TOL = 1e-4  # float32 max abs error, as K1; bf16: one bf16 rounding of max|out| (2^-7 of it)
BF16_ROUNDING = 2.0**-7  # K1 and K7 on bf16 io: max abs <= this x max|out| (tests/test_torch_window_attention_bf16.py)
# K3 on bf16 io (tests/test_torch_window_attention_train_bf16.py): the output as BF16_ROUNDING, each gradient
# within this x its largest value (a flipped rounding of dq / dkv moves a row of a weight gradient by one step)
K3_BF16_GRAD = 2.0**-6
SERVE_MEAN_TOL = 0.05  # bf16 SR against float32 SR, mean abs (tests/test_prefetch_bf16.py)
K7_BF16_RTOL, K7_BF16_ATOL = 0.1, 0.15  # bf16 against the float32 kernel (tests/test_pallas_window.py)
K8_TOL = 1e-5  # max abs error: float32 sums of <= 64 terms in other orders
JUDGE_RTOL = 1e-4  # the judges' features / logits, card vs CPU: max abs <= this x max|ref| (cuDNN's
# float32 convolution and RNN algorithms against the CPU's, through up to 31 layers)
MEASURED = {}  # ms (and GiB) of earlier phases that the driver phase sets its own beside


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


def bound_ms(nbytes, flops, tc_flops=0.0, bf16_flops=0.0, tc2_flops=0.0):
    """The larger of the bytes at 3.35 TB/s and the operations: float32 on
    the CUDA cores at 67 TFLOP/s, plus tc_flops run as 3xTF32 on the tensor
    cores (3 x tc_flops at 495 TFLOP/s), plus bf16_flops on bf16 operands at
    989 TFLOP/s, plus tc2_flops, float32 products whose other operand is
    bf16-valued (SKConv's on bf16 weights), as two TF32 passes (2 x
    tc2_flops at 495 TFLOP/s)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / FP32_FLOP_PER_S + (3 * tc_flops + 2 * tc2_flops) / TF32_FLOP_PER_S
             + bf16_flops / BF16_FLOP_PER_S) * 1e3
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
    operations on tensor cores[, two-pass TF32 operations]])} per path,
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
            nbytes, flops, tc, bf, tc2 = (*parts[key], 0.0, 0.0)[:5]
            b_ms, b_by = bound_ms(nbytes, flops, tc, bf, tc2)
            kind = ("bf16 on tensor cores" if bf else "3xTF32 on tensor cores" if tc else
                    "2xTF32 on tensor cores" if tc2 else "float32 on CUDA cores")
            line += (f"; part {key} (all its launches): bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB, "
                     f"{(flops + tc + bf + tc2) / 1e9:.2f} GFLOP, {kind})")
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


def k1_ops(batch, l, dim, win, bf16=False):
    """K1's operations a call on `batch` images of l tokens, as bound_ms's
    (flops, tc_flops, bf16_flops, tc2_flops).  Float32 io: every product
    on float32 operands.  bf16 io: the projections (2 l D 3D) on bf16
    operands (ln_proj_bf16_kernel); the attention's scores and P v (4 l ch N
    for a window of N tokens) on float32 q and kv (the bf16 form stores them
    in float32 and runs the float32 attention, block_forward in
    csrc/window_attention.cu), as the split counts them: the 2x2 windows' on
    the CUDA cores, the others' at 3xTF32; SKConv's products (2 l D D +
    2 l ch D) on bf16 weights, two TF32 passes."""
    ch = dim // len(win)
    proj = batch * 2 * l * dim * 3 * dim
    attn = {ws: batch * 4 * l * ch * ws * ws for ws in win}
    skconv = batch * (2 * l * dim * dim + 2 * l * ch * dim)
    if not bf16:
        return proj + sum(attn.values()) + skconv, 0.0, 0.0, 0.0
    return attn.get(2, 0.0), sum(f for ws, f in attn.items() if ws != 2), proj, skconv


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
    instructions (cuobjdump -sass), and every bf16 attention forward (K7's,
    each head dim 8, 16, 32; the training cores' BF16_FWD_KERNELS, each head
    dim and dropout flag) and K1's bf16 LN + projection (one an embedding
    width: 16, 32, 48, 64, 80, 96) bf16 m16n8k16 products
    (HMMA.16816.F32.BF16); every instance of the bf16 backwards' product
    kernels (BF16_BWD_KERNELS) holds bf16 m16n8k16 products and no TF32
    product (no 3xTF32 split on bf16 operands), and K3's, K4's and K5's
    libraries hold no widening or narrowing pass (WIDENING_KERNELS); K1's and
    K5's libraries hold SKConv's two token kernels on float32 and on bf16
    weights at every embedding width, and each bf16-weight instance takes
    two TF32 passes a product step where the float32 one takes three (see
    SKCONV_LIBS)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    found, bf16, bf16_bwd, widening = {}, {}, {}, []
    for name in ("window_attention", "window_attention_train", "window_attention_core", "window_attention_full",
                 "grouped_window_attention", "window_tile_attention", "gru_scan", "mlp_convs"):
        sass = subprocess.run([tool, "-sass", str(kernels._target(name))], capture_output=True, text=True,
                              check=True, timeout=120).stdout
        funcs = re.split(r"\n\s*Function : ", sass)[1:]
        names = demangle([f.split(None, 1)[0] for f in funcs])
        for func, body in zip(names, funcs):
            if name in ("window_attention_train", "window_attention_core", "window_attention_full") and \
                    base_name(func) in WIDENING_KERNELS:
                widening.append(f"{name}: {func}")
            if base_name(func) in BF16_BWD_KERNELS:
                bf16_bwd[f"{name}: {func}"] = (body.count("HMMA.16816.F32.BF16"), body.count("TF32"))
            if base_name(func) in TC_KERNELS + ("gru_large_kernel",):
                found[f"{name}: {func}"] = (body.count("HMMA"), body.count("HGMMA"))
                if base_name(func) in ("ln_proj_bf16_kernel",) + BF16_FWD_KERNELS or (
                        base_name(func) == "window_attn_fwd_kernel" and "bfloat16" in func):
                    bf16[func] = body.count("HMMA.16816.F32.BF16")
    by_lib = {}
    for func, (hmma, hgmma) in found.items():
        lib, name = func.split(": ", 1)
        by_lib.setdefault(lib, []).append(f"{name} {hmma}" + (f" (HGMMA {hgmma})" if hgmma else ""))
    for lib, rows in by_lib.items():
        log(f"  sass {lib}: HMMA instructions: {', '.join(rows)}")
    log(f"  sass bf16 m16n8k16 products (HMMA.16816.F32.BF16): {bf16}")
    log(f"  sass bf16 backwards (HMMA.16816.F32.BF16, TF32 instructions): {bf16_bwd}")
    skconv = {}
    for func, (hmma, _) in found.items():
        if m := re.search(r"^(\w+): (skconv_(?:proj|out)_kernel)<(\d+), (float|__nv_bfloat16)>", func):
            skconv.setdefault(m.group(1, 2, 3), {})[m.group(4)] = hmma
    log(f"  sass SKConv TF32 HMMA, float32 / bf16 weights: {skconv}")
    not_two_thirds = {}
    for lib in SKCONV_LIBS:
        for width in range(16, 97, 16):
            for kern in ("skconv_proj_kernel", "skconv_out_kernel"):
                n = skconv.get((lib, kern, str(width)), {})
                f32, bf = n.get("float", 0), n.get("__nv_bfloat16", 0)
                if kern == "skconv_proj_kernel":
                    bad = not f32 or 3 * bf != 2 * f32
                else:
                    bad = not f32 or f32 % 3 or not bf or bf % (2 * f32 // 3)
                if bad:
                    not_two_thirds[(lib, kern, width)] = n
    missing = [f for f, n in found.items() if sum(n) == 0]
    absent = [k for k in TC_KERNELS if not any(base_name(f.split(": ", 1)[1]) == k for f in found)]
    tf32 = [f for f, (n16, n32) in bf16_bwd.items() if n16 == 0 or n32]
    fwd_instances = sum(base_name(f) in BF16_FWD_KERNELS for f in bf16)
    if missing or absent or len(bf16) < 4 or fwd_instances < 12 or not all(bf16.values()) or tf32 or widening or \
            not_two_thirds:
        raise AssertionError(f"no HMMA or HGMMA in {missing}; tensor-core kernels not found: {absent}; bf16 "
                             f"m16n8k16 products: {bf16} ({fwd_instances} training-forward instances, want 12 "
                             f"or more); bf16 backward kernels without bf16 products or with "
                             f"TF32 ones: {tf32}; widening passes in K3's / K4's / K5's libraries: {widening}; "
                             f"SKConv instances missing, or on bf16 weights not two TF32 passes a step: "
                             f"{not_two_thirds}")


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
    l, ch = h * w, dim // 3
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
    flops = k1_ops(B, l, dim, (2, 4, 8))[0]
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
            "window_attention_train_forward_bf16": wt.forward_bf16_counter,
            "window_attention_train_backward_bf16": wt.backward_bf16_counter,
            "window_attention_core_forward": wc.forward_counter,
            "window_attention_core_backward": wc.backward_counter,
            "window_attention_core_forward_bf16": wc.forward_bf16_counter,
            "window_attention_core_backward_bf16": wc.backward_bf16_counter,
            "window_attention_full_forward": wf.forward_counter,
            "window_attention_full_backward": wf.backward_counter,
            "window_attention_full_forward_bf16": wf.forward_bf16_counter,
            "window_attention_full_backward_bf16": wf.backward_bf16_counter,
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
    l, ch, t = h * w, dim // 3, B * h * w
    split = {}
    with torch.no_grad():
        for kw in kws.values():
            add_split(split, kernel_split(lambda: window_attention_block(xq, xkv, **kw)), 6)
    parts = {"ln_proj_bf16_kernel": (2 * (2 * t * dim + 3 * dim * dim + 3 * dim) + 4 * 3 * t * dim, 0.0, 0.0,
                                     2 * t * dim * 3 * dim),
             **attn_fwd_parts(t, dim, (2, 4, 8)),
             "skconv_proj_kernel": (4 * (2 * t * dim + t // 64 * dim) + 2 * dim * dim, 0.0, 0.0, 0.0,
                                    2 * t * dim * dim),
             "skconv_gate_kernel": (4 * t // 64 * dim, 0.0, 0.0),
             "skconv_out_kernel": (4 * 2 * t * dim + 2 * (2 * t * dim + dim * ch), 2 * t * dim, 0.0, 0.0,
                                   2 * t * ch * dim)}
    log_split("K1 bf16", split, {k: tuple(12 * v for v in p) for k, p in parts.items()})
    ops = k1_ops(B, l, dim, (2, 4, 8), bf16=True)
    nbytes = 3 * B * l * dim * 2
    b_ms, b_by = bound_ms(nbytes, *ops)
    for shift, (k_ms, p_ms) in times.items():
        log(f"K1 bf16 B={B} shift={shift}: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}; "
            f"{nbytes / 1e6:.1f} MB; GFLOP: {ops[0] / 1e9:.2f} float32 on CUDA cores, {ops[1] / 1e9:.2f} 3xTF32, "
            f"{ops[2] / 1e9:.2f} bf16, {ops[3] / 1e9:.2f} 2xTF32 on bf16 weights)")
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
        MEASURED[f"serving {name}"] = dt * 1e3

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
        MEASURED[f"judge {kind}"] = ms
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
    it: per group the window-partitioned q, k, v (B*nW, heads, N, head dim)
    with bias + shift mask as attn_mask, and a cotangent."""
    args, hd = [], a.dim // len(a.win) // a.gnum_heads
    for g, (ws, sh) in enumerate(zip(a.win, a.shf)):
        n, nw = ws * ws, (h // ws) * (w // ws)
        qkv = [torch.randn(B * nw, a.gnum_heads, n, hd, generator=gen).to(dev).requires_grad_() for _ in range(3)]
        mask = b_det[g][None].expand(B * nw, -1, -1, -1)
        if sh > 0:
            mask = (b_det[g][None, None] + masks[g][None, :, None]).expand(B, -1, -1, -1, -1).reshape(
                B * nw, a.gnum_heads, n, n)
        args.append((qkv, mask.contiguous(), torch.randn(B * nw, a.gnum_heads, n, hd, generator=gen).to(dev)))
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


def bf16_core_case(dev, core, gen, shift, dim=96, windows=(2, 4, 8), heads=6, batch=B, hw=(16, 64),
                   bf=torch.bfloat16):
    """A training core's bf16 inputs (by default at the flagship's 16x64
    grid): its primals as bf16 leaves (K3 its 10, K4 q and the halves of one
    kv leaf, as the "attention" core hands them over, K5 its 18; `bf`
    float32 gives the float32 core's, K4's q, k, v then contiguous), float32
    bias leaves, the masks and the static arguments."""
    from dpmn_tpu_torch.models.pgrm import SwinTransformerBlock
    from dpmn_tpu_torch.system import init_weights

    h, w = hw
    blk = SwinTransformerBlock(dim, (h, w), heads, list(windows), list(shift))
    init_weights(blk, seed=6)
    a = blk.attn
    leaf = lambda t, dt=bf: t.detach().clone().to(dev, dt).requires_grad_()
    rnd = lambda *shape: 0.1 * torch.randn(*shape, generator=gen)
    if core == "attention":
        q, kv = leaf(torch.randn(batch, h * w, dim, generator=gen)), leaf(torch.randn(batch, h * w, 2 * dim, generator=gen))
        prim, leaves = [q, kv[..., :dim], kv[..., dim:]], [q, kv]
        if bf == torch.float32:  # the float32 kernel takes k and v contiguous
            prim = leaves = [q, leaf(kv[..., :dim].contiguous()), leaf(kv[..., dim:].contiguous())]
    else:
        prim = [leaf(torch.randn(batch, h * w, dim, generator=gen)), leaf(torch.randn(batch, h * w, dim, generator=gen)),
                leaf(1 + rnd(dim)), leaf(rnd(dim)), leaf(1 + rnd(dim)), leaf(rnd(dim)), leaf(a.q.weight),
                leaf(rnd(dim)), leaf(a.kv.weight), leaf(rnd(2 * dim))]
        if core == "full":
            prim += [leaf(t) if t.dim() == 2 else leaf(rnd(*t.shape)) for t in a.SKConv.weights()]
        leaves = prim
    biases = [leaf(rnd(*b.shape), torch.float32) for b in a.biases()]
    masks = [m.to(dev) if m is not None else None for m in a.masks()]
    return a, prim, leaves, biases, masks, [a.win, a.shf, a.gnum_heads, a.scale, a.hw]


BF16_CORES = {"block": ("window_attention_train", "window_attention_block_core"),
              "attention": ("window_attention_core", "window_attention_core"),
              "full": ("window_attention_full", "window_attention_full_core")}


def hold_bf16_core(tag, mod, fn_name, prim, leaves, biases, masks, seed, keep, static, cot):
    """The core's kernels on bf16 io against autograd through its plain
    version on the card: the output within 2^-7 of max|out|, each gradient
    within 2^-6 of its largest value, the dtypes bf16 (dbias float32).
    Returns (forward max abs, worst gradient max abs)."""
    def run(fn):
        out = fn(*prim, biases, masks, seed, keep, *static)
        return out, torch.autograd.grad(out, leaves + biases, cot)

    out, grads = run(getattr(mod, fn_name))
    ref, ref_grads = run(getattr(mod, fn_name + "_plain"))
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = BF16_ROUNDING * ref.float().abs().max().item()
    gerr = max(((g.float() - r.float()).abs().max() / (K3_BF16_GRAD * r.float().abs().max())).item()
               for g, r in zip(grads, ref_grads))
    bf = torch.bfloat16
    dtypes = [t.dtype for t in (out, *grads)] == [bf] * (1 + len(leaves)) + [torch.float32] * len(biases)
    ok = dtypes and bool(torch.isfinite(out.float()).all()) and err <= tol and gerr <= 1.0
    log(f"{tag}: forward max_abs_err {err:.3e} (tol {tol:.3e}: 2^-7 max|out|); worst gradient at {gerr:.3f} of its "
        f"tolerance (max abs <= 2^-6 max|ref|); dtypes {'bf16 (dbias float32)' if dtypes else 'WRONG'} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: kernel disagrees with its plain version")
    return err, max((g.float() - r.float()).abs().max().item() for g, r in zip(grads, ref_grads))


def phase_core_bf16(dev, core):
    """A training core on bf16 io (the bf16 AMP step's K3, K4 or K5) forward
    and backward against autograd through its plain version at B = 64, the
    flagship geometry, both shift sets, keep 1 and 0.9 (hold_bf16_core); K3
    also with 3 heads a group (two groups of 48 channels) and with a scale
    that is not a power of two, at B = 9.  Times a call beside the float32
    kernel on the same values, and for K4 beside SDPA on bf16.  K3's and
    K4's and K5's backward are also split by sub-kernel (torch.profiler),
    each part beside its bound, with their launches a call held to
    BF16_BWD_LAUNCHES and no widening pass among them; so are the three
    forwards (BF16_FWD_LAUNCHES: K3 and K4 one launch, K5 four).  Returns the
    kernels-line entries of its two entry points (per AMP train step: 6
    unshifted + 6 shifted calls, keep 0.9; the bound from bf16 bytes, the
    products on bf16 operands at the bf16 tensor-core peak and SKConv's
    (K5) as two TF32 passes in the forward and 3xTF32 in the backward, as
    its kernels run them)."""
    import importlib

    import torch.nn.functional as F

    name, fn_name = BF16_CORES[core]
    mod = importlib.import_module(f"dpmn_tpu_torch.ops.{name}")
    from dpmn_tpu_torch.ops import window_attention_train as wt

    h, w, dim, seed = 16, 64, 96, 4321
    tag = {"block": "K3", "attention": "K4", "full": "K5"}[core] + " bf16"
    gen = torch.Generator().manual_seed(5)
    bf = torch.bfloat16
    cot = torch.randn(B, h * w, dim, generator=gen).to(dev, bf)
    worst_fwd, worst_grad, times, split_bwd, split_fwd = 0.0, 0.0, {}, {}, {}
    if core == "block":
        # 3 heads a group (the thread-per-row attention backward), and a scale
        # that is not a power of two (head dim 12's), against the plain version
        for kw, scale in ((dict(windows=(2, 8), heads=6), None), ({}, 12**-0.5)):
            _, prim, leaves, biases, masks, static = bf16_core_case(dev, core, gen, (1, 4) if kw else (1, 2, 4),
                                                                    batch=9, **kw)
            static[3] = scale or static[3]
            cot9 = torch.randn(9, h * w, dim, generator=gen).to(dev, bf)
            hold_bf16_core(f"{tag} B=9 {static[2]} heads a group scale {static[3]:.6f}", mod, fn_name, prim, leaves,
                           biases, masks, seed, 0.9, static, cot9)
    for shift in ((0, 0, 0), (1, 2, 4)):
        a, prim, leaves, biases, masks, static = bf16_core_case(dev, core, gen, shift)
        for keep in (1.0, 0.9):
            err, gerr = hold_bf16_core(f"{tag} shift={shift} keep={keep}", mod, fn_name, prim, leaves, biases, masks,
                                       seed, keep, static, cot)
            worst_fwd, worst_grad = max(worst_fwd, err), max(worst_grad, gerr)
        keep = 0.9
        st = wt.make_static(masks, seed, keep, *static)
        p_det = [t.detach() for t in prim]
        b_det = [t.detach() for t in biases]
        p32 = [t.float().contiguous() for t in p_det]
        kept = mod._forward_cuda(st, p_det, b_det)[1]
        kept32 = mod._forward_cuda(st, p32, b_det)[1]
        k_fwd = cuda_ms(lambda: mod._forward_cuda(st, p_det, b_det))
        k_bwd = cuda_ms(lambda: mod._backward_cuda(st, p_det, b_det, cot, kept))
        f_fwd = cuda_ms(lambda: mod._forward_cuda(st, p32, b_det))
        f_bwd = cuda_ms(lambda: mod._backward_cuda(st, p32, b_det, cot.float(), kept32))
        plain = getattr(mod, fn_name + "_plain")
        p_fwd = cuda_ms(lambda: plain(*p_det, b_det, masks, seed, keep, *static), iters=5)
        out = plain(*prim, biases, masks, seed, keep, *static)
        p_bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves + biases, cot, retain_graph=True), iters=5)
        del out
        lib, l_fwd, l_bwd = "", 0.0, 0.0
        if core == "attention":
            # SDPA on bf16 over the partitioned windows (bias + mask as a bf16
            # attn_mask, no dropout), forward and backward timed apart
            sdpa_args = [([t.detach().to(bf).requires_grad_() for t in qkv_g], m.to(bf), do.to(bf))
                         for qkv_g, m, do in sdpa_groups(a, b_det, masks, h, w, gen, dev)]
            l_fwd = cuda_ms(lambda: [F.scaled_dot_product_attention(*qkv_g, attn_mask=m, scale=a.scale)
                                     for qkv_g, m, _ in sdpa_args])
            outs = [F.scaled_dot_product_attention(*qkv_g, attn_mask=m, scale=a.scale) for qkv_g, m, _ in sdpa_args]
            l_bwd = cuda_ms(lambda: [torch.autograd.grad(o, qkv_g, do, retain_graph=True)
                                     for o, (qkv_g, _, do) in zip(outs, sdpa_args)])
            del outs
            lib = f"; SDPA on bf16 forward {l_fwd:.4f}, backward {l_bwd:.4f}"
        times[shift] = (k_fwd, k_bwd, p_fwd, p_bwd, l_fwd, l_bwd)
        if core in BF16_BWD_LAUNCHES:
            call = lambda: mod._backward_cuda(st, p_det, b_det, cot, kept)
            split = kernel_split(call)
            check_bf16_launches(f"{tag} backward shift={shift}", name, call, split, BF16_BWD_LAUNCHES[core])
            add_split(split_bwd, split, 6)
        if core in BF16_FWD_LAUNCHES:
            call = lambda: mod._forward_cuda(st, p_det, b_det)
            split = kernel_split(call)
            check_bf16_launches(f"{tag} forward shift={shift}", name, call, split, BF16_FWD_LAUNCHES[core])
            add_split(split_fwd, split, 6)
        log(f"{tag} B={B} shift={shift} keep=0.9: forward {k_fwd:.4f} ms a call (float32 kernel on the same values "
            f"{f_fwd:.4f}), backward {k_bwd:.4f} (float32 {f_bwd:.4f}); plain forward {p_fwd:.4f}, backward "
            f"{p_bwd:.4f}{lib}")
    # bounds: bf16 bytes; the attention and projection products on bf16
    # operands; K5's SKConv products on bf16 weights, forward as two TF32
    # passes, backward at 3xTF32 on the tensor cores (skconv_bwd_a / _b)
    win, t = (2, 4, 8), B * h * w
    cost = {"block": k3_cost, "attention": k4_cost, "full": k5_cost}[core](B, (h, w), dim, win)
    skconv = 2 * t * dim * dim + 2 * t * (dim // 3) * dim if core == "full" else 0.0
    fb_ms, fb_by = bound_ms(cost["fwd_bytes"] / 2, 0.0, 0.0, cost["fwd_flops"] - skconv, skconv)
    bb_ms, bb_by = bound_ms(cost["bwd_bytes"] / 2, 0.0, 3 * skconv, cost["bwd_flops"] - 3 * skconv)
    log(f"{tag} bounds a call: forward {fb_ms:.4f} ms ({fb_by}; {cost['fwd_bytes'] / 2e6:.1f} MB, "
        f"{(cost['fwd_flops'] - skconv) / 1e9:.2f} GFLOP on bf16 operands, {skconv / 1e9:.2f} as 2xTF32), backward "
        f"{bb_ms:.4f} ({bb_by}; {cost['bwd_bytes'] / 2e6:.1f} MB, {(cost['bwd_flops'] - 3 * skconv) / 1e9:.2f} GFLOP "
        f"on bf16 operands, {3 * skconv / 1e9:.2f} at 3xTF32)")
    if core in BF16_BWD_LAUNCHES:
        log_split(f"{tag} backward", split_bwd, {k: tuple(12 * v for v in p)
                                                 for k, p in bf16_bwd_parts(core, t, dim, win, h, w).items()})
    if core in BF16_FWD_LAUNCHES:
        log_split(f"{tag} forward", split_fwd, {k: tuple(12 * v for v in p)
                                                for k, p in bf16_fwd_parts(core, t, dim, win).items()})
    per_step = lambda i: 6 * (times[(0, 0, 0)][i] + times[(1, 2, 4)][i])
    common = {"route": "cuda", "source": f"dpmn_tpu_torch/csrc/{name}.cu"}
    fwd = {"name": f"{name}_forward_bf16", **common, "replaces": REPLACES[name][0], "max_abs_err": worst_fwd,
           "ms": per_step(0), "plain_ms": per_step(2), "bound_ms": 12 * fb_ms, "bound_by": fb_by,
           "library_ms": per_step(4) if core == "attention" else None}
    bwd = {"name": f"{name}_backward_bf16", **common, "replaces": REPLACES[name][1], "max_abs_err": worst_grad,
           "ms": per_step(1), "plain_ms": per_step(3), "bound_ms": 12 * bb_ms, "bound_by": bb_by,
           "library_ms": per_step(5) if core == "attention" else None}
    return fwd, bwd


def port_kernel_names():
    """The names of the port's CUDA kernels (`*_kernel` in csrc/), so that a
    profiler split can tell them from PyTorch's own launches."""
    csrc = Path(__file__).resolve().parent / "dpmn_tpu_torch" / "csrc"
    return {n for f in csrc.glob("*.cu*") for n in re.findall(r"\b(\w+_kernel)\b", f.read_text())}


def check_bf16_launches(tag, lib, call, split, want):
    """One bf16 forward or backward call() launches `want` kernels of the
    library `lib` (its own host-side count, <lib>_kernel_launches: the
    wrapper's PyTorch ops not counted), and none of the split's kernels
    (torch.profiler) is a widening or narrowing pass.  The profiler is not asked for the count: it
    drops some of a profile's device events in some runs."""
    import ctypes

    from dpmn_tpu_torch.ops import kernels

    count = kernels.bind(lib, f"{lib}_kernel_launches", [], ctypes.c_ulonglong)
    torch.cuda.synchronize()
    before = count()
    call()
    torch.cuda.synchronize()
    launches = count() - before
    widening = [k for k in split if k.split("<")[0] in WIDENING_KERNELS]
    ours = port_kernel_names()
    recorded = sum(n for k, (_, n) in split.items() if k.split("<")[0] in ours)
    log(f"{tag}: {launches} launches a call (want {want}; the profiler recorded {recorded:g} of the port's "
        f"kernels a call{'' if split else ', no split'}), widening passes {widening or 'none'}")
    if launches != want or widening:
        raise AssertionError(f"{tag}: {launches} launches a call, want {want}; widening passes {widening}")


def bf16_fwd_parts(core, t, dim, win):
    """{sub-kernel: (bytes, CUDA-core operations, 3xTF32 operations, bf16
    operations[, 2xTF32 operations])} of one K3 ("block"), K4 ("attention")
    or K5 ("full") bf16 forward call on t tokens.  K3's one launch reads
    bf16 xq, xkv and weights and writes out (bf16; K5 float32 tokens), its
    projections and the 4x4 and 8x8 windows' products on bf16, the 2x2
    windows' on the CUDA cores; K4's reads bf16 q, k, v and writes bf16
    out, its products split so too; K5 adds SKConv's three passes (the
    tokens read by both products, feats written and read back, the GAP
    partials; their products on bf16 weights, two TF32 passes, in the fifth
    place)."""
    ch = dim // len(win)
    flops = {ws: 2 * 2 * t * ch * ws * ws for ws in win}
    attn, attn2 = sum(f for ws, f in flops.items() if ws != 2), flops.get(2, 0.0)
    if core == "attention":
        return {"window_attn_fwd_train_kernel": (2 * 4 * t * dim, attn2, 0.0, attn)}
    block = {"window_block_fwd_bf16_kernel": (2 * (2 * t * dim + 3 * dim * dim + 7 * dim) + (4 if core == "full" else 2)
                                              * t * dim, attn2, 0.0, 2 * t * dim * 3 * dim + attn)}
    if core == "block":
        return block
    return {**block,
            "skconv_proj_kernel": (4 * (2 * t * dim + t // 64 * dim) + 2 * dim * dim, 0.0, 0.0, 0.0,
                                   2 * t * dim * dim),
            "skconv_gate_kernel": (4 * t // 64 * dim, 0.0, 0.0, 0.0),
            "skconv_out_kernel": (4 * 2 * t * dim + 2 * (t * dim + dim * ch), 2 * t * dim, 0.0, 0.0,
                                  2 * t * ch * dim)}


def bf16_bwd_parts(core, t, dim, win, h, w):
    """{sub-kernel: (bytes, CUDA-core operations, 3xTF32 operations, bf16
    operations)} of one K3 ("block"), K4 ("attention") or K5 ("full") bf16
    backward call on t tokens: q and kv recomputed in bf16
    (ln_proj_bf16_kernel; not K4); per group the attention backward reading
    bf16 q, k, v, dout and writing dq, dk, dv (float32; K4 bf16), the 2x2
    windows' on the CUDA cores, the others' products on bf16 tensor cores
    (K4: these and the partial rows' sums alone); the projection backward
    and the weight gradients reading bf16 x and weights and float32 dq /
    dkv, dx in bf16, the products on bf16; the partial rows' sums (their
    outputs bf16); for K5 SKConv's passes on bf16 dout, their products at
    3xTF32 (the tokens' gradient stored in bf16)."""
    ch = dim // len(win)
    batch = t // (h * w)
    wparts = -(-t // 512) * (3 * dim * dim + 3 * dim)
    parts, partials = {}, 0
    for ws in win:
        n = ws * ws
        floats = batch * attn_bwd_chunks(n, 2, (h // ws) * (w // ws)) * 2 * n * n
        partials += floats
        flops = 5 * 2 * t * ch * n
        # K4's instances (bf16 outputs) have template arguments too long for
        # the split's names: its 4x4 and 8x8 parts are one
        key = ("window_attn_bwd4_kernel" if n == 4 else "window_attn_bwd_tc_bf16_kernel" if core == "attention"
               else f"window_attn_bwd_tc_bf16_kernel<{n},")
        out_bytes = 2 if core == "attention" else 4
        part = (2 * 4 * t * ch + out_bytes * 3 * t * ch + 4 * floats, flops if n == 4 else 0.0, 0.0,
                0.0 if n == 4 else flops)
        parts[key] = tuple(a + b for a, b in zip(parts.get(key, (0.0,) * 4), part))
    if core == "attention":
        return {**parts, "sum_rows_kernel": (4 * partials, partials, 0.0, 0.0)}
    out = {"ln_proj_bf16_kernel": (2 * (5 * t * dim + 3 * dim * dim + 3 * dim), 0.0, 0.0, 2 * t * dim * 3 * dim),
           **parts,
           "proj_ln_bwd_bf16_kernel": (2 * 2 * t * dim + 4 * 3 * t * dim + 2 * 2 * t * dim + 4 * t // 64 * 4 * dim,
                                       0.0, 0.0, 2 * t * 3 * dim * dim),
           "wgrad_bf16_kernel": (2 * 2 * t * dim + 4 * 3 * t * dim + 4 * wparts, 0.0, 0.0, 2 * t * 3 * dim * dim),
           "sum_rows_kernel": (4 * (partials + wparts + t // 64 * 4 * dim), partials + wparts, 0.0, 0.0)}
    if core == "full":
        grid = min(132, t // 64)
        parts_wgrad = grid * (dim * dim + dim + dim * ch + dim)
        io = 4 * t * dim
        out.update({"skconv_bwd_a_kernel": (io / 2 + io + 4 * t * ch + 4 * (t // 64 + grid) * dim,
                                            4 * t * dim, 2 * 2 * t * dim * ch, 0.0),
                    "skconv_gate_bwd_kernel": (4 * (t // 64 * 2 * dim), 0.0, 0.0, 0.0),
                    "skconv_bwd_b_kernel": (io / 2 + io + io / 2 + 4 * t * ch + 4 * grid * dim * dim,
                                            4 * t * dim, 3 * 2 * t * dim * dim, 0.0)})
        b, c_, _, _ = out["sum_rows_kernel"]
        out["sum_rows_kernel"] = (b + 4 * parts_wgrad, c_ + parts_wgrad, 0.0, 0.0)
    return out


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
    # the bf16 AMP step: the core on bf16 io, no float32 training kernel
    "block-amp": expected_counts(gru_bidir=11, window_attention_train_forward_bf16=12,
                                 window_attention_train_backward_bf16=12),
    "attention-amp": expected_counts(gru_bidir=11, window_attention_core_forward_bf16=12,
                                     window_attention_core_backward_bf16=12),
    "full-amp": expected_counts(gru_bidir=11, window_attention_full_forward_bf16=12,
                                window_attention_full_backward_bf16=12),
}


ZERO_RATES = dict(drop_rate="0,", attn_drop_rate="0,", drop_path_rate="0,")


def hold_train_card_vs_cpu(tag, systems, dev, run, n_ids=None):
    """The same weights at rates 0 on the card and on the CPU: run(system)
    gives (loss, the gradients in trainable_parameters() order); raises
    unless they agree and the students' ids (n_ids glyph renders, or as
    many as the card made) are equal.  Float32 gradients at B = 2 are determined only to a few % of a
    leaf: the CMM's 1x4 bottleneck sees 8 values per channel, and a
    leaky-ReLU input within rounding of 0 changes slope there, which moves
    every gradient upstream (tests/test_torch_train.py); the biases ahead of
    a BatchNorm have a gradient of 0 up to rounding.  So each leaf is held in
    norm, within 5 % of its own norm plus 1e-4 of the whole gradient's, all
    of them together within 1e-3, and loss and grad_norm tightly."""
    res = {}
    for d, s in systems.items():
        ids = []
        hook = s.glyph.register_forward_hook(lambda mod, inp, out: ids.append(inp[0].cpu()))
        loss, grads = run(s)
        hook.remove()
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).item()
        res[d] = (loss.item(), norm, [g.cpu() for g in grads], ids)
    (lg, ng, gg, ig), (lc, nc, gc, ic) = res[dev], res["cpu"]
    ids_ok = len(ig) == len(ic) == (n_ids or len(ig)) > 0 and all(torch.equal(a, b) for a, b in zip(ig, ic))
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


AMP_AGREE = 5e-2  # card vs CPU AMP, each module on the same inputs: of its PGRM's gradient norm
AMP_ROUNDED = 2e-3  # the card's AMP gradients at least this far from float32 on the same inputs


def hook_modules(system, record=None, feed=None):
    """Pre-hooks on the trainable modules of `system` (the PGRMs, distills and
    CMM).  `record` (a dict): each module's input tensors are kept there on
    the CPU as it runs.  `feed` (such a dict): each module reads those
    tensors in place of its own, detached, on its device and in the dtype it
    was given, so that its gradient is that of its own computation on them.
    Returns the handles."""
    def each(args, fn):
        if torch.is_tensor(args):
            return fn(args)
        if isinstance(args, (list, tuple)):
            return type(args)(each(a, fn) for a in args)
        return args

    handles = []
    for name, m in system.trainable_modules().items():
        if record is not None:
            def keep(mod, args, name=name):
                record[name] = []
                each(args, lambda t: record[name].append(t.detach().cpu()))
            handles.append(m.register_forward_pre_hook(keep))
        if feed is not None:
            def swap(mod, args, name=name):
                it = iter(feed[name])
                return each(args, lambda t: (lambda r: r.to(t.device, t.dtype) if t.is_floating_point() else t)(next(it)))
            handles.append(m.register_forward_pre_hook(swap))
    return handles


def hold_amp_card_vs_cpu(tag, systems, dev, hr, lr, train_core="block", args=None, cfg=None, n_renders=3):
    """The AMP step on the card and on the CPU, the same weights, rates 0, 2
    images.  The step's loss within rel 1e-2 of the CPU's, as
    tests/test_torch_amp.py holds it against the JAX package (the CPU reads
    the card's glyph ids: a bf16 student may read a word differently on the
    two devices).  The gradients are held module by module: each trainable
    module (PGRM, distill, CMM) reads the inputs it had in the card's step,
    so that each module's gradient is compared on identical inputs.  There
    each PGRM's gradient (its leaves as one vector) is within 5e-2 of its
    norm of the CPU's and each leaf within 5e-2 of its PGRM's norm, the
    limits of that test; and each PGRM's gradient is at least 2e-3 of its
    norm from the CPU's float32 step on the same inputs (more than one bf16
    rounding of the result, whose RMS is ~1.6e-3), which a float32 step
    does not reach (two float32 implementations differ by ~1e-4): the
    card's float32 step runs through the same check as a control and must
    fail it.  Over the whole step (no inputs fed) two bf16 computations part
    by as much as bf16 moves the float32 step, since their rounding errors
    are independent and grow through the cascade (the CPU's own AMP step is
    as far from float32 as from the card's): those readings are logged, not
    held.  `args` (a function of overrides, by default flagship_args), `cfg`
    and n_renders (the glyph renders of a step; None: as many as the card's
    step made) give another geometry's."""
    from dpmn_tpu_torch.config import TrainCfg, flagship_args
    from dpmn_tpu_torch.system import DPMNSystem

    args, cfg = args or flagship_args, cfg or TrainCfg(batch_size=2)
    renders, inputs = [], {}
    hooks = [systems[dev].glyph.register_forward_pre_hook(
        lambda mod, args: renders.append(tuple(t.cpu() for t in args)))]
    hooks += hook_modules(systems[dev], record=inputs)
    lg, gg = systems[dev]._micro_grads(hr, lr, 0)
    for h in hooks:
        h.remove()

    def step(system, local):
        it, seen = iter(renders), []

        def feed(mod, args):
            ids, lengths = next(it)
            seen.append(torch.equal(args[0].cpu(), ids))
            return ids.to(args[0].device), lengths.to(args[0].device)

        hooks = [system.glyph.register_forward_pre_hook(feed)]
        if local:
            hooks += hook_modules(system, feed=inputs)
        try:
            loss, grads = system._micro_grads(hr, lr, 0)
        finally:
            for h in hooks:
                h.remove()
        return loss, [g.cpu() for g in grads], seen

    lc, gc, seen = step(systems["cpu"], False)
    f32 = {d: DPMNSystem(cfg, args(**ZERO_RATES), device=d, seed=0, train_core=train_core) for d in (dev, "cpu")}
    _, g32, _ = step(f32[dev], False)
    _, gc32, _ = step(f32["cpu"], False)
    local = {"card": step(systems[dev], True)[1], "cpu": step(systems["cpu"], True)[1],
             "card32": step(f32[dev], True)[1], "cpu32": step(f32["cpu"], True)[1]}
    del f32
    names = [n for n, p in systems["cpu"].named_parameters()
             if any(p is q for q in systems["cpu"].trainable_parameters())]
    gg = [g.cpu() for g in gg]
    dist = lambda a, b, idx: (torch.sqrt(sum(((a[i] - b[i]).double() ** 2).sum() for i in idx))
                              / torch.sqrt(sum((b[i].double() ** 2).sum() for i in idx))).item()
    rows, worst_leaf = [], (0.0, "")
    for mi in range(len(systems["cpu"].pgrms)):
        idx = [i for i, n in enumerate(names) if n.startswith(f"pgrms.{mi}.")]
        norm = torch.sqrt(sum((local["cpu"][i].double() ** 2).sum() for i in idx)).item()
        rows.append(dict(agree=dist(local["card"], local["cpu"], idx), rounded=dist(local["card"], local["cpu32"], idx),
                         agree32=dist(local["card32"], local["cpu"], idx),
                         rounded32=dist(local["card32"], local["cpu32"], idx),
                         step=dist(gg, gc, idx), step32=dist(gg, g32, idx), cpu32=dist(gc, gc32, idx)))
        worst_leaf = max([worst_leaf] + [((local["card"][i] - local["cpu"][i]).norm().item() / norm, names[i])
                                         for i in idx])
    col = lambda k: ", ".join(f"{r[k]:.3e}" for r in rows)
    passes = lambda agree, rounded: max(agree) <= AMP_AGREE and min(rounded) >= AMP_ROUNDED
    l_rel = abs(lg.item() - lc.item()) / abs(lc.item())
    dtypes = all(g.dtype == torch.float32 for g in (*gg, *gc))
    amp_ok = passes([r["agree"] for r in rows], [r["rounded"] for r in rows]) and worst_leaf[0] <= AMP_AGREE
    control_ok = passes([r["agree32"] for r in rows], [r["rounded32"] for r in rows])
    log(f"{tag}: card vs CPU on 2 images at rates 0: loss {lg.item():.6f} vs {lc.item():.6f} (rel {l_rel:.2e}, tol "
        f"1e-2); each module on the card's inputs, each PGRM's gradient of its norm: card vs CPU {col('agree')} "
        f"(tol {AMP_AGREE}), worst leaf {worst_leaf[1]} at {worst_leaf[0]:.3e} of its PGRM's norm (tol {AMP_AGREE}); "
        f"card vs the CPU's float32 step {col('rounded')} (at least {AMP_ROUNDED}); the card's float32 step as a "
        f"control: vs the CPU's AMP {col('agree32')}, vs the CPU's float32 {col('rounded32')} (it must fail: "
        f"{'fails' if not control_ok else 'PASSES'}); the whole step, logged: card vs CPU {col('step')}, the card's "
        f"AMP vs its float32 {col('step32')}, the CPU's AMP vs its float32 {col('cpu32')}; the CPU's own glyph ids equal the card's in {sum(seen)} of "
        f"{len(seen)} renders; gradients float32 {dtypes}")
    if not (l_rel <= 1e-2 and amp_ok and not control_ok and dtypes and len(seen) == (n_renders or len(renders))):
        raise AssertionError(f"{tag}: card and CPU disagree on the AMP train path")


def check_float32_state(tag, system):
    """Raise unless every parameter, gradient-free buffer and Adam moment of
    the system is float32 (nothing bf16 leaked from the AMP step)."""
    bad = [n for n, t in system.state_dict().items() if t.is_floating_point() and t.dtype != torch.float32]
    for p in system.trainable_parameters():
        bad += [f"adam {k}" for k, v in system.optimizer.state[p].items()
                if torch.is_tensor(v) and v.is_floating_point() and v.dtype != torch.float32]
    log(f"{tag}: parameters, BatchNorm statistics and Adam moments all float32: {not bad}")
    if bad:
        raise AssertionError(f"{tag}: not float32 after the step: {bad[:5]}")


def phase_train(dev, card, train_core, timed, train_dtype=None):
    """The flagship train_step at B = 64 with `train_core` (and
    `train_dtype`): a warm-up step, one step whose launches are counted,
    `timed` timed steps; then card against CPU on 2 images.  Returns the
    launch counts of one step.  Under bf16 AMP also: the state float32
    after the steps, and the loss finite and falling over 5 steps on one
    repeated batch (the JAX package's gate, tests/test_system.py:82-106)."""
    from dpmn_tpu_torch.config import TrainCfg, flagship_args
    from dpmn_tpu_torch.system import DPMNSystem

    amp = train_dtype is not None
    key = f"{train_core}-amp" if amp else train_core
    tag = f"train[{key}]"
    t0 = time.perf_counter()
    system = DPMNSystem(TrainCfg(batch_size=B), flagship_args(), device=dev, seed=0, train_core=train_core,
                        train_dtype=train_dtype)
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
    log(f"{tag}: launches in one step {launches} (expected {TRAIN_LAUNCHES[key]})")
    if launches != TRAIN_LAUNCHES[key]:
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
    log(f"{tag}: flagship train_step B={B} {'bf16 AMP' if amp else 'fp32'} dropout 0.1: {dt * 1e3:.2f} ms/step, "
        f"{B / dt:.1f} images/s on {card}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; last loss "
        f"{m['loss'].item():.4f} grad_norm {m['grad_norm'].item():.4f}")
    MEASURED[tag] = (dt * 1e3, torch.cuda.max_memory_allocated() / 2**30)
    if amp:
        check_float32_state(tag, system)
        hr, lr = batches[0]
        losses = [system.train_step(hr, lr, seed=100 + i)["loss"].item() for i in range(5)]
        log(f"{tag}: 5 steps on one repeated batch: losses {[round(v, 4) for v in losses]}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{tag}: the AMP loss does not fall on a repeated batch: {losses}")
        check_float32_state(tag, system)
    del system

    # card against the CPU on 2 images, rates 0, the same weights
    systems = {d: DPMNSystem(TrainCfg(batch_size=2), flagship_args(**ZERO_RATES), device=d, seed=0,
                             train_core=train_core, train_dtype=train_dtype) for d in (dev, "cpu")}
    hr, lr = batches[1][0][:2], batches[1][1][:2]
    if amp:
        hold_amp_card_vs_cpu(tag, systems, dev, hr, lr, train_core)
    else:
        hold_train_card_vs_cpu(tag, systems, dev, lambda s: s._micro_grads(hr, lr, 0), n_ids=3)
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
    plain fwd, plain bwd[, library fwd, library bwd]) in ms per call, the
    unshifted set first."""
    fb_ms, fb_by = bound_ms(cost["fwd_bytes"], cost["fwd_flops"])
    bb_ms, bb_by = bound_ms(cost["bwd_bytes"], cost["bwd_flops"])
    for shift, t in times.items():
        lib = f"; library (SDPA) fwd {t[4]:.4f} bwd {t[5]:.4f}" if library else ""
        log(f"{tag} B={B} shift={shift} keep=0.9: forward kernel_ms {t[0]:.4f} plain_ms {t[2]:.4f} bound_ms "
            f"{fb_ms:.4f} ({fb_by}; {cost['fwd_bytes'] / 1e6:.1f} MB, {cost['fwd_flops'] / 1e9:.2f} GFLOP); backward "
            f"kernel_ms {t[1]:.4f} plain_ms {t[3]:.4f} bound_ms {bb_ms:.4f} ({bb_by}; {cost['bwd_bytes'] / 1e6:.1f} MB, "
            f"{cost['bwd_flops'] / 1e9:.2f} GFLOP){lib}")
    per_step = lambda i: 6 * sum(t[i] for t in times.values())
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
    cost = k4_cost(B, (h, w), a.dim, a.win)
    io = torch.tensor([], dtype=dtype).element_size()
    tables = io * sum(b.numel() for b in a.biases()) + 4 * sum(m.numel() for m in a.masks() if m is not None)
    return cost["fwd_bytes"] * io // 4 + tables, cost["fwd_flops"]


def sdpa_windows(a, q, k, v, dtype):
    """One K7 call's attention as F.scaled_dot_product_attention takes it: per
    group the rolled, window-partitioned q, k, v (B*nW, heads, N, head dim)
    and bias [+ shift mask] as a float attn_mask, in the io type."""
    from dpmn_tpu_torch.ops.window_attention import _window_partition

    args, ch, (h, w) = [], a.dim // len(a.win), a.hw
    for g, (ws, sh, bias, mask) in enumerate(zip(a.win, a.shf, a.biases(), a.masks())):
        n = ws * ws

        def part(t):
            t = t[..., g * ch:(g + 1) * ch]
            if sh > 0:
                t = torch.roll(t, (-sh, -sh), dims=(1, 2))
            t = _window_partition(t, ws)
            return t.reshape(t.shape[0], n, a.gnum_heads, ch // a.gnum_heads).permute(0, 2, 1, 3).contiguous()

        bw = B * (h // ws) * (w // ws)
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


ROOT = Path(__file__).resolve().parent
RUN_DIR = ROOT / "chip_smoke_run"  # git-ignored; made and removed by phases 13 and 14
FIXTURE = ROOT / "tests" / "fixtures" / "textzoom_jpeg.npz"
LOOP_STEPS = 8  # steps of the driver's train loop; validation and the checkpoint after the last
WORKERS = 4


def _sha256(img) -> str:
    return hashlib.sha256(np.asarray(img, np.uint8).tobytes()).hexdigest()


def driver_lmdb():
    """The committed JPEG fixture's 128 records, 4 times over (512, 8
    batches of 64), as a TextZoom LMDB; raises unless the native reader
    serves it, equal to the pure-Python reader on every key, and each
    record's decode equals the fixture's digest of PIL's decode on the host
    that made it."""
    from dpmn_tpu_torch.data.datasets import TextZoomLMDB
    from dpmn_tpu_torch.data.lmdb_reader import LMDBReader
    from dpmn_tpu_torch.data.lmdb_writer import fixture_samples, write_textzoom_lmdb

    samples, digests = fixture_samples(str(FIXTURE), copies=4)
    path = RUN_DIR / "easy"
    write_textzoom_lmdb(str(path), samples)
    ds = TextZoomLMDB(str(path))
    py = LMDBReader(str(path))
    keys = [b"num-samples"] + [b"%s-%09d" % (t, i) for i in range(1, len(samples) + 1)
                               for t in (b"image_hr", b"image_lr", b"label")]
    same = all(ds.reader.get(k) == py.get(k) is not None for k in keys)
    t0 = time.perf_counter()
    decoded = [(_sha256(ds[i][0]), _sha256(ds[i][1])) for i in range(128)]
    dt = time.perf_counter() - t0
    match = sum(d == ref for d, ref in zip(decoded, digests))
    log(f"driver: LMDB of {len(samples)} records ({(path / 'data.mdb').stat().st_size / 1e6:.2f} MB); reader "
        f"{ds.reader_kind}, equal to the Python reader on all {len(keys)} keys {same}; decodes of the 128 distinct "
        f"records equal to the fixture's PIL digests {match}/128 ({dt * 1e3 / 128:.3f} ms a record: 2 JPEG decodes "
        f"and 2 YUV copies)")
    if ds.reader_kind != "native" or not same or match != 128:
        raise AssertionError("driver: the LMDB reader or the decoder disagrees with the fixture")
    return path


def blocked_cli(flags, timeout=300):
    """`python -m dpmn_tpu_torch.cli FLAGS` in a subprocess that cannot
    import cv2, yaml, JAX or dpmn_tpu."""
    code = ("import importlib.abc, runpy, sys\n"
            "class Block(importlib.abc.MetaPathFinder):\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('cv2', 'yaml', 'jax', 'dpmn_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            f"sys.argv = ['dpmn_tpu_torch.cli'] + {flags!r}\n"
            "runpy.run_module('dpmn_tpu_torch.cli', run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def flagship_flags(**overrides):
    """The CLI flags of flagship_args(**overrides)'s PSN and cascade."""
    from dpmn_tpu_torch.config import flagship_args

    fa = flagship_args(**overrides)
    return (["--arch", fa.arch] + (["--mask"] if fa.mask else []) + ["--gradient"]
            + [x for k in ("stu_iter_b1", "stu_iter_b2", "patch_size", "embed_dim", "window_size", "depths",
                           "num_heads", "mlp_ratio") for x in (f"--{k}", str(getattr(fa, k)))])


class StepProbe:
    """Wraps a system's train_step (or accum_train_step): counts the kernel
    launches of step `count_at`, stamps the wall clock (after a device sync)
    at the ends of steps `first` and `last`, and steps a profiler if given."""

    def __init__(self, system, name, count_at=None, first=None, last=None, prof=None):
        self.system, self.name, self.fn = system, name, getattr(system, name)
        self.count_at, self.first, self.last, self.prof = count_at, first, last, prof
        self.n, self.launches, self.stamps = 0, None, {}
        setattr(system, name, self)

    def __call__(self, *a, **kw):
        self.n += 1
        if self.n == self.count_at:
            torch.cuda.synchronize()
            reset_counts()
        out = self.fn(*a, **kw)
        if self.n in (self.count_at, self.first, self.last):
            torch.cuda.synchronize()
            self.stamps[self.n] = time.perf_counter()
        if self.n == self.count_at:
            self.launches = read_counts()
        if self.prof is not None:
            self.prof.step()
        return out

    def ms(self):
        return (self.stamps[self.last] - self.stamps[self.first]) * 1e3 / (self.last - self.first)

    def remove(self):
        delattr(self.system, self.name)


def phase_driver(dev, card):
    """The driver end to end on the card: Trainer.train on the fixture LMDB
    at the flagship geometry, B = 64, with thread workers, one validation
    with the ASTER judge and one save; the resume from its checkpoint; an
    accumulated step at batch 256; test() with and without workers; the
    CLI's --test in a subprocess that cannot import cv2, yaml or JAX.
    Returns the launch counts of one loop step and one validation batch."""
    import csv

    from torch.profiler import ProfilerActivity, profile, schedule

    from dpmn_tpu_torch.checkpoint import load_checkpoint, resolve_native_checkpoint
    from dpmn_tpu_torch.config import TrainCfg, flagship_args
    from dpmn_tpu_torch.profile_path import device_busy_ms, device_events
    from dpmn_tpu_torch.system import DPMNSystem
    from dpmn_tpu_torch.train import Trainer

    shutil.rmtree(RUN_DIR, ignore_errors=True)
    RUN_DIR.mkdir()
    lmdb = driver_lmdb()
    ckpt = RUN_DIR / "ckpt"

    def make_cfg(**kw):
        return TrainCfg(**{**dict(batch_size=B, epochs=100, workers=WORKERS, ckpt_dir=str(ckpt),
                                  displayInterval=LOOP_STEPS, valInterval=LOOP_STEPS, saveInterval=LOOP_STEPS,
                                  train_data_dir=[str(lmdb)], val_data_dir=[str(lmdb)]), **kw})

    # the train loop: launches of step 2 and of the first validation batch,
    # ms/step over steps 3-8 (the host's data plane and the prefetch included)
    t0 = time.perf_counter()
    trainer = Trainer(make_cfg(), flagship_args(rec="aster"))
    log(f"driver: Trainer (flagship, B={B}, {WORKERS} workers, ASTER judge) built in {time.perf_counter() - t0:.1f} s")
    loop = StepProbe(trainer.system, "train_step", count_at=2, first=2, last=LOOP_STEPS)
    val = StepProbe(trainer.system, "sr_forward", count_at=1)
    t0 = time.perf_counter()
    trainer.train(max_iters=LOOP_STEPS, max_batches_eval=2)
    wall = time.perf_counter() - t0
    loop.remove()
    val.remove()
    check_counts("driver: one loop step", loop.launches, **{k: v for k, v in TRAIN_LAUNCHES["block"].items() if v})
    check_counts("driver: one validation batch", val.launches, window_attention_block=12, gru_bidir=11)
    bare, _ = MEASURED["train[block]"]
    log(f"driver: Trainer.train {LOOP_STEPS} steps + validation (2 batches) + save: {wall:.2f} s; the loop "
        f"{loop.ms():.2f} ms/step ({B / loop.ms() * 1e3:.1f} images/s) against the bare train_step's {bare:.2f} "
        f"(phase 6, {100 * (loop.ms() / bare - 1):+.1f} %) on {card}")
    with open(ckpt / "log.csv") as f:
        rows = list(csv.reader(f))
    files = sorted(p.name for p in ckpt.iterdir())
    log(f"driver: log.csv {rows}; files {files}")
    if rows[0] != ["epoch", "dataset", "accuracy", "psnr_avg", "ssim_avg", "best", "best_sum"] or \
            rows[1][:2] != ["0", "easy"] or not all(np.isfinite(float(v)) for v in rows[1][2:5]) or \
            "checkpoint.pt" not in files or trainer.system.step != LOOP_STEPS:
        raise AssertionError("driver: the train loop's log or checkpoint is wrong")

    # resume: a fresh Trainer from checkpoint.pt takes the next two steps as
    # the run that wrote it does (the second also reads the optimizer state)
    rng = np.random.RandomState(5)
    nxt = [(rng.rand(B, 32, 128, 4).astype(np.float32), rng.rand(B, 16, 64, 4).astype(np.float32)) for _ in range(2)]
    other = Trainer(make_cfg(resume=str(ckpt)), flagship_args(rec="aster"))
    path = resolve_native_checkpoint(other.cfg.resume)
    _, info = load_checkpoint(path, other.system)
    losses = [[t.system.train_step(hr, lr, seed=100 + i)["loss"].item() for i, (hr, lr) in enumerate(nxt)]
              for t in (trainer, other)]
    rel = max(abs(a - b) / abs(a) for a, b in zip(*losses))
    log(f"driver: resumed from {path.removeprefix(str(ROOT) + '/')} (iters {info['iters']}): next two losses "
        f"{losses[1]} against the writer's {losses[0]} (max rel {rel:.2e}, tol 1e-5)")
    if rel > 1e-5:
        raise AssertionError("driver: the resumed run's losses differ")
    del other
    torch.cuda.empty_cache()

    # the loop's device busy share over two steps under torch.profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=2, warmup=1, active=2, repeat=1)) as prof:
        step = StepProbe(trainer.system, "train_step", first=3, last=5, prof=prof)
        trainer.train(max_iters=5)
        step.remove()
    events = device_events(prof)
    if events:
        busy, span = device_busy_ms(events), step.ms() * 2
        log(f"driver: the loop under torch.profiler, steps 4-5: {step.ms():.2f} ms/step, device busy {busy:.2f} of "
            f"{span:.2f} ms ({100 * busy / span:.1f} %, {len(events)} device events)")
    else:
        log("driver: the loop's busy share not measured (torch.profiler recorded no device time)")
    share = busy_share(lambda: trainer.system.train_step(*nxt[0], seed=9))
    if share is not None:
        busy, wall_ms, n, _ = share
        log(f"driver: the bare train_step under torch.profiler: {wall_ms:.2f} ms, device busy {busy:.2f} ms "
            f"({100 * busy / wall_ms:.1f} %, {n} device events)")

    # gradient accumulation: batch 256 in 4 microbatches of 64
    hr = np.concatenate([rng.rand(B, 32, 128, 4).astype(np.float32) for _ in range(4)])
    lr = np.concatenate([rng.rand(B, 16, 64, 4).astype(np.float32) for _ in range(4)])
    trainer.system.accum_train_step(hr, lr, 7, accum_steps=4)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = trainer.system.accum_train_step(hr, lr, 8, accum_steps=4)
    loss = m["loss"].item()
    dt = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, bare_peak = MEASURED["train[block]"]
    log(f"driver: accum_train_step batch {4 * B} in 4 microbatches: {dt:.2f} ms ({4 * B / dt * 1e3:.1f} images/s, "
        f"{dt / bare:.2f} x the B={B} step), loss {loss:.4f}, peak memory {peak:.2f} GiB (B={B} step "
        f"{bare_peak:.2f}) on {card}")
    if not np.isfinite(loss):
        raise AssertionError("driver: the accumulated step's loss is not finite")
    systems = {d: DPMNSystem(TrainCfg(batch_size=2), flagship_args(**ZERO_RATES), device=d, seed=0)
               for d in (dev, "cpu")}

    def accumulated(s):
        got = {}
        apply = s._apply_update
        s._apply_update = lambda g, loss: got.update(grads=[x.clone() for x in g], loss=loss) or apply(g, loss)
        s.accum_train_step(hr[:4], lr[:4], 0, accum_steps=2)
        del s._apply_update
        return got["loss"], got["grads"]

    hold_train_card_vs_cpu("driver: accum_train_step, 2 microbatches of 2", systems, dev, accumulated,
                           n_ids=2 * systems["cpu"].b1)
    del systems

    # test(): the fixture LMDB at B = 64, 4 batches, the ASTER judge, with
    # the loader's workers and without
    trainer.args.test_data_dir = str(lmdb)
    for workers in (0, 1, WORKERS):
        trainer.cfg.workers = workers
        r = trainer.test(trainer.system, max_batches=4)
        ips = 1.0 / r["duration"]
        bare_test = MEASURED["serving sr_forward glyph_from_psn"] + MEASURED["judge aster"]
        log(f"driver: test() {workers} workers: {ips:.1f} images/s, duration {r['duration'] * 1e3:.3f} ms an image "
            f"(256 images); phase 4b's glyph_from_psn + phase 4c's ASTER {bare_test:.2f} ms a batch "
            f"({B / bare_test * 1e3:.1f} images/s): the data plane and the host's share "
            f"{r['duration'] * B * 1e3 - bare_test:+.2f} ms a batch on {card}; result {r}")
    with open(ckpt / "test_result.csv") as f:
        rows = list(csv.reader(f))
    log(f"driver: test_result.csv {rows}")
    if rows[0] != ["recognizer", "subset", "accuracy", "psnr", "ssim"] or len(rows) != 4 or rows[1][:2] != \
            ["aster", "easy"]:
        raise AssertionError("driver: test_result.csv is wrong")
    del trainer
    torch.cuda.empty_cache()

    # the CLI's --test on the card, in a process that cannot import cv2, yaml or JAX
    config = RUN_DIR / "test.yaml"
    config.write_text(f"TRAIN:\n  batch_size: {B}\n  workers: {WORKERS}\n  ckpt_dir: '{ckpt}'\n  VAL:\n"
                      "    rec_pretrained: ''\n    moran_pretrained: ''\n    crnn_pretrained: ''\n"
                      "    visionlan_pretrained: ''\n")
    flags = ["--test", "--test_data_dir", str(lmdb), "--resume", str(ckpt), "--config", str(config)] + flagship_flags()
    t0 = time.perf_counter()
    r = blocked_cli(flags)
    with open(ckpt / "test_result.csv") as f:
        rows = list(csv.reader(f))
    log(f"driver: CLI --test (cv2, yaml, JAX blocked): exit {r.returncode} in {time.perf_counter() - t0:.1f} s; "
        f"its output {r.stdout.strip().splitlines()[-1:]}; test_result.csv rows {len(rows)}")
    if r.returncode != 0 or len(rows) != 5 or rows[4][:2] != ["aster", "easy"]:
        log(r.stderr[-3000:])
        raise AssertionError("driver: the CLI's --test failed")
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    return loop.launches, val.launches


# phase 14: the other PSNs, each (arch, mask, K2 launches a forward): TSRN
# and TSRN_TL sweep 5 SRBs x 2 directions, TBSRN's GRUs are never called
PSN_CASES = (("tsrn", True, 10), ("tpgsr", True, 10), ("tbsrn", True, 0), ("tsrn", False, 10))
# the loaded system's forward against its source's: the same weights bit
# for bit, but the card's forward moves by ~3e-8 between runs
REF_SR_TOL = 1e-6


def phase_psns(dev, card):
    """Phase 14a: the flagship with each other PSN at B = 64 (seeded weights,
    uniform random LR): exact launches of one forward, ms and images/s over 4
    timed batches, the PSN stage from CUDA events (profile_path's hooks),
    peak memory; then the card against the CPU on 2 images (SR within 1e-4,
    the glyph ids equal), as phase 4."""
    from dpmn_tpu_torch.config import TrainCfg, flagship_args
    from dpmn_tpu_torch.models.tsrn import TSRN
    from dpmn_tpu_torch.profile_path import hooked_stage_times
    from dpmn_tpu_torch.system import DPMNSystem

    tg = DPMNSystem(TrainCfg(batch_size=2), flagship_args(arch="tg"), device="cpu", seed=0)
    log(f"psns: --arch tg builds {type(tg.psn).__name__}")
    if type(tg.psn) is not TSRN:
        raise AssertionError("psns: --arch tg must build TSRN")
    del tg
    rng = np.random.RandomState(14)
    for arch, mask, gru in PSN_CASES:
        tag = f"psns: {arch}" + ("" if mask else " unmasked")
        args = flagship_args(arch=arch, mask=mask)
        system = DPMNSystem(TrainCfg(batch_size=B), args, device=dev, seed=0)
        batches = [rng.rand(B, 16, 64, 4 if mask else 3).astype(np.float32) for _ in range(6)]
        system.sr_forward(batches[0])  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        out = system.sr_forward(batches[1])
        torch.cuda.synchronize()
        check_counts(f"{tag}, one forward", read_counts(), window_attention_block=12, gru_bidir=gru)
        if tuple(out.shape) != (B, 32, 128, 3) or not torch.isfinite(out).all():
            raise AssertionError(f"{tag}: bad output, shape {tuple(out.shape)}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for x in batches[2:]:
            system.sr_forward(x)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / len(batches[2:])
        peak = torch.cuda.max_memory_allocated() / 2**30
        rows, total = hooked_stage_times(system, lambda: system.sr_forward(batches[2]))
        psn_ms = sum(ms for label, _, ms in rows if label.endswith(" PSN"))
        crnn_ms = sum(ms for label, _, ms in rows if label == "CRNN text prior")
        MEASURED[f"psn {arch} {mask}"] = dt * 1e3
        log(f"{tag}: sr_forward B={B}: {dt * 1e3:.2f} ms/batch, {B / dt:.1f} images/s; PSN stage {psn_ms:.2f} ms"
            + (f" + CRNN text prior {crnn_ms:.2f} ms" if crnn_ms else "") + f" of a {total:.2f} ms forward "
            f"(CUDA events); peak memory {peak:.2f} GiB on {card}")

        cpu = DPMNSystem(TrainCfg(batch_size=2), args, device="cpu", seed=0)
        x2 = batches[1][:2]
        with torch.no_grad():
            xg = torch.from_numpy(x2).permute(0, 3, 1, 2).contiguous()
            psn_err = (cpu._psn_forward(xg) - system._psn_forward(xg.to(dev)).cpu()).abs().max().item()
        sr_c, ids_c = glyph_ids(cpu, lambda: cpu.sr_forward(x2))
        sr_g, ids_g = glyph_ids(system, lambda: system.sr_forward(x2).cpu())
        err = (sr_c - sr_g).abs().max().item()
        same_ids = len(ids_c) == len(ids_g) == 3 and all(torch.equal(a, b) for a, b in zip(ids_c, ids_g))
        log(f"{tag}: card vs CPU on 2 images: PSN max_abs_err {psn_err:.3e}, SR max_abs_err {err:.3e} (tol 1e-4), "
            f"the students' glyph ids equal {same_ids}")
        if not (psn_err <= 1e-4 and err <= 1e-4 and same_ids):
            raise AssertionError(f"{tag}: card and CPU disagree")
        del system, cpu
        torch.cuda.empty_cache()


def phase_reference_checkpoints(dev, card):
    """Phase 14b: the reference's checkpoint files on the card.  A seeded
    flagship system is written in the reference's layout (the inverse of the
    port's key maps, with the dead families) under chip_smoke_run/, read into
    a system of another seed with load_driver_weights(testing=True) (every
    tensor equal bit for bit, the distills aside, which no file holds, and
    the forward within REF_SR_TOL of the source's), then `--test --resume
    DIR --rec_path DIR` through the CLI with cv2, yaml and JAX blocked."""
    import csv

    from dpmn_tpu_torch.config import TrainCfg, flagship_args
    from dpmn_tpu_torch.convert import _reference_state_dict
    from dpmn_tpu_torch.data.lmdb_writer import fixture_samples, write_textzoom_lmdb
    from dpmn_tpu_torch.system import DPMNSystem
    from dpmn_tpu_torch.weights import load_driver_weights

    shutil.rmtree(RUN_DIR, ignore_errors=True)
    ref = RUN_DIR / "reference"
    ref.mkdir(parents=True)
    src = DPMNSystem(TrainCfg(batch_size=B), flagship_args(), device=dev, seed=3)
    t0 = time.perf_counter()
    bookkeeping = {"info": {"iters": np.int64(1200), "acc": np.float64(0.5)}, "param_num": 1}
    torch.save({"state_dict_G": _reference_state_dict(src.psn), **bookkeeping}, ref / "model_tatt.pth")
    torch.save(_reference_state_dict(src.crnn_psn), ref / "recognizer_best_crnn.pth")
    for k, student in enumerate(src.students):
        torch.save(_reference_state_dict(student), ref / f"recognizer_best_{k}.pth")
    for i, pgrm in enumerate(src.pgrms):
        torch.save({"state_dict_G": _reference_state_dict(pgrm), **bookkeeping}, ref / f"model_best_{i}.pth")
    torch.save(_reference_state_dict(src.cmm), ref / "model_best_cmm.pth")
    written = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in ref.iterdir()) / 1e6

    dst = DPMNSystem(TrainCfg(batch_size=B), flagship_args(resume=str(ref), rec_path=str(ref)), device=dev, seed=4)
    t0 = time.perf_counter()
    load_driver_weights(dst, TrainCfg(batch_size=B), dst.args, testing=True)
    torch.cuda.synchronize()
    loaded = time.perf_counter() - t0
    want, got = src.state_dict(), dst.state_dict()
    names = [k for k in want if not k.startswith("distills.") and not k.endswith("num_batches_tracked")]
    differ = [k for k in names if not torch.equal(want[k], got[k])]
    x = np.random.RandomState(15).rand(B, 16, 64, 4).astype(np.float32)
    sr = src.sr_forward(x)
    rerun = (src.sr_forward(x) - sr).abs().max().item()
    sr_err = (dst.sr_forward(x) - sr).abs().max().item()
    log(f"reference: {len(list(ref.iterdir()))} files, {size:.1f} MB written in {written:.1f} s, read by "
        f"load_driver_weights(testing=True) in {loaded:.1f} s on {card}; tensors not equal bit for bit "
        f"{len(differ)} of {len(names)} {differ[:3]}; sr_forward max_abs_err against the source {sr_err:.3e}, "
        f"the source's own rerun {rerun:.3e} (tol {REF_SR_TOL:g}: the forward is not bitwise reproducible)")
    if differ or sr_err > REF_SR_TOL:
        raise AssertionError("reference: the loaded system is not the source")
    del src, dst
    torch.cuda.empty_cache()

    samples, _ = fixture_samples(str(FIXTURE))
    write_textzoom_lmdb(str(RUN_DIR / "easy"), samples)
    ckpt = RUN_DIR / "ckpt"
    config = RUN_DIR / "test.yaml"
    config.write_text(f"TRAIN:\n  batch_size: {B}\n  workers: 0\n  ckpt_dir: '{ckpt}'\n  VAL:\n"
                      "    crnn_pretrained: ''\n    visionlan_pretrained: ''\n")
    flags = ["--test", "--test_data_dir", str(RUN_DIR / "easy"), "--resume", str(ref), "--rec_path", str(ref),
             "--rec", "crnn", "--config", str(config)] + flagship_flags()
    t0 = time.perf_counter()
    r = blocked_cli(flags)
    said = [line for line in r.stdout.splitlines() if line.startswith("[weights]")]
    log(f"reference: CLI --test --resume DIR --rec_path DIR (cv2, yaml, JAX blocked): exit {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; {said}; its output {r.stdout.strip().splitlines()[-1:]}")
    rows = []
    if (ckpt / "test_result.csv").exists():
        with open(ckpt / "test_result.csv") as f:
            rows = list(csv.reader(f))
    want_said = [f"[weights] PSN (tatt) loaded from {ref / 'model_tatt.pth'}",
                 f"[weights] crnn_psn loaded from {ref / 'recognizer_best_crnn.pth'}"]
    want_said += [f"[weights] student_{k} (visionlan) loaded from {ref / f'recognizer_best_{k}.pth'}" for k in range(3)]
    want_said += [f"[weights] pgrm_{i} loaded from {ref / f'model_best_{i}.pth'}" for i in range(6)]
    want_said += [f"[weights] cmm loaded from {ref / 'model_best_cmm.pth'}"]
    if r.returncode != 0 or said != want_said or len(rows) != 2 or rows[1][:2] != ["crnn", "easy"]:
        log(r.stderr[-3000:])
        raise AssertionError("reference: the CLI's --test on the reference files failed")
    shutil.rmtree(RUN_DIR, ignore_errors=True)


# ------------------------------------------------- phase 15: the geometries
# The geometries the JAX package runs beyond the flagship's head dim 16: the
# flagship with --num_heads 3 (head dim 32) and 12 (head dim 8, 4 heads a
# group: the thread-per-row attention backward), and the JAX package's
# "mid" (embed 48 over windows 2 / 4 / 8: head dim 8; hd_u 4) and "toy"
# (32x32 images, embed 16 over windows 2 / 4: channel 8) geometries
# (__graft_entry__.py:180-193; dpmn_tpu_torch.config mid_args, toy_args).
# Each runs sr_forward and sr_forward_bf16 and the train steps listed.
GEOMETRIES = {
    "hd32": dict(args=dict(num_heads="3,3,3,3,3,3,"), image=(32, 128), train=(("block", None), ("block", "bfloat16"))),
    "hd8": dict(args=dict(num_heads="12,12,12,12,12,12,"), image=(32, 128),
                train=(("block", None), ("block", "bfloat16"))),
    "mid": dict(args="mid", image=(32, 128),
                train=tuple((c, d) for d in (None, "bfloat16") for c in ("block", "attention", "full"))),
    "toy": dict(args="toy", image=(32, 32), train=(("block", None),)),
}
GEOMETRY_STEPS = 2  # timed batches or steps of each run (the flagship's phases time 2 to 4)
CORE_TAGS = {"block": "K3", "attention": "K4", "full": "K5"}


def geometry_args(geo, **overrides):
    from dpmn_tpu_torch.config import flagship_args, mid_args, toy_args

    a = GEOMETRIES[geo]["args"]
    if isinstance(a, dict):
        return flagship_args(**{**a, **overrides})
    return {"mid": mid_args, "toy": toy_args}[a](**overrides)


def geometry_cfg(geo, batch):
    from dpmn_tpu_torch.config import TrainCfg

    h, w = GEOMETRIES[geo]["image"]
    return TrainCfg(batch_size=batch, width=w, height=h)


def counted_run(tag, fn, **want):
    """fn() once to warm up, then once with the launch counters from 0;
    raises unless they are exactly `want`.  Returns (fn()'s result, counts)."""
    fn()
    torch.cuda.synchronize()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = read_counts()
    check_counts(tag, got, **want)
    return out, got


def timed_runs(fn, n):
    """(seconds a call of fn(i), i < n, and the peak GiB of the n calls)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n, torch.cuda.max_memory_allocated() / 2**30


def geometry_path(dev, card, geo):
    """The slice's path at one geometry, B = 64, seeded random weights:
    sr_forward and sr_forward_bf16, then train_step under each (core,
    dtype) of GEOMETRIES[geo]: the launches of one call exactly (K1 a block,
    K2 a BiGRU; the core's kernel a block forward and backward, no other
    training kernel), finite results, images/s and peak memory over
    GEOMETRY_STEPS calls; the card against the CPU on 2 images: the SR
    within 1e-4 and the students' ids equal, each float32 step at rates 0
    within the flagship's limits (hold_train_card_vs_cpu), each AMP step's
    state float32 after it and the AMP step against the CPU as phase 8b
    holds the flagship's.  Returns the launch counts of each run,
    the K2 calls' (N, T, H) and the blocks' geometry."""
    from dpmn_tpu_torch.models.pgrm import WindowAttention
    from dpmn_tpu_torch.ops.gru import BiGRU
    from dpmn_tpu_torch.system import DPMNSystem

    hi, wi = GEOMETRIES[geo]["image"]
    rng = np.random.RandomState(5)
    lrs = [rng.rand(B, hi // 2, wi // 2, 4).astype(np.float32) for _ in range(2 + GEOMETRY_STEPS)]
    t0 = time.perf_counter()
    system = DPMNSystem(geometry_cfg(geo, B), geometry_args(geo), device=dev, seed=0)
    blocks = [m for m in system.pgrms.modules() if isinstance(m, WindowAttention)]
    grus = [m for m in system.modules() if isinstance(m, BiGRU)]
    a = blocks[0]
    hd = a.dim // len(a.win) // a.gnum_heads
    log(f"geometry {geo}: system built in {time.perf_counter() - t0:.1f} s; {hi}x{wi} images, D {a.dim} in windows "
        f"{a.win} on a {a.hw[0]}x{a.hw[1]} grid, {a.gnum_heads} heads a group of head dim {hd}; {len(blocks)} "
        f"window-attention blocks, {len(grus)} BiGRUs of hidden sizes {sorted({g.weight_hh_l0.shape[1] for g in grus})}")
    runs, calls = {}, []
    hooks = [g.register_forward_pre_hook(
        lambda m, args, kw: calls.append((args[0].shape[0], kw.get("steps") or args[0].shape[1],
                                          m.weight_hh_l0.shape[1], "steps" in kw)), with_kwargs=True) for g in grus]
    want = dict(window_attention_block=len(blocks), gru_bidir=len(grus))
    sr32, runs["sr_forward"] = counted_run(f"geometry {geo} sr_forward", lambda: system.sr_forward(lrs[1]), **want)
    for h in hooks:
        h.remove()
    calls = calls[len(calls) // 2:]  # the counted forward's
    if tuple(sr32.shape) != (B, hi, wi, 3) or not torch.isfinite(sr32).all():
        raise AssertionError(f"geometry {geo}: bad output, shape {tuple(sr32.shape)}")
    dt, peak = timed_runs(lambda i: system.sr_forward(lrs[2 + i]), GEOMETRY_STEPS)
    log(f"geometry {geo} sr_forward B={B}: {dt * 1e3:.2f} ms/batch, {B / dt:.1f} images/s on {card}; peak memory "
        f"{peak:.2f} GiB")
    sr16, runs["sr_forward_bf16"] = counted_run(f"geometry {geo} sr_forward_bf16",
                                                lambda: system.sr_forward_bf16(lrs[1]), **want)
    dt, peak = timed_runs(lambda i: system.sr_forward_bf16(lrs[2 + i]), GEOMETRY_STEPS)
    mean = (sr16.float() - sr32).abs().mean().item()
    log(f"geometry {geo} sr_forward_bf16 B={B}: {dt * 1e3:.2f} ms/batch, {B / dt:.1f} images/s; peak memory "
        f"{peak:.2f} GiB; against float32 SR mean abs {mean:.3e} (tol {SERVE_MEAN_TOL})")
    if not (torch.isfinite(sr16.float()).all() and mean <= SERVE_MEAN_TOL):
        raise AssertionError(f"geometry {geo}: bf16 SR off the float32 SR by {mean}")
    cpu = DPMNSystem(geometry_cfg(geo, 2), geometry_args(geo), device="cpu", seed=0)
    x2 = lrs[1][:2]
    sr_c, ids_c = glyph_ids(cpu, lambda: cpu.sr_forward(x2))
    sr_g, ids_g = glyph_ids(system, lambda: system.sr_forward(x2))
    err = (sr_c - sr_g.cpu()).abs().max().item()
    ids_ok = len(ids_c) == len(ids_g) > 0 and all(torch.equal(p, q) for p, q in zip(ids_c, ids_g))
    log(f"geometry {geo}: card vs CPU on 2 images: SR max_abs_err {err:.3e} (tol 1e-4); the students' ids equal "
        f"{ids_ok} ({len(ids_g)} renders)")
    if not (err <= 1e-4 and ids_ok):
        raise AssertionError(f"geometry {geo}: card and CPU disagree on the eval path")
    del system, cpu
    for core, dtype in GEOMETRIES[geo]["train"]:
        amp = dtype is not None
        tag = f"geometry {geo} train[{core}{'-amp' if amp else ''}]"
        name, sfx = BF16_CORES[core][0], "_bf16" if amp else ""
        s = DPMNSystem(geometry_cfg(geo, B), geometry_args(geo), device=dev, seed=0, train_core=core,
                       train_dtype=dtype)
        batches = [(rng.rand(B, hi, wi, 4).astype(np.float32), rng.rand(B, hi // 2, wi // 2, 4).astype(np.float32))
                   for _ in range(2 + GEOMETRY_STEPS)]
        step = iter(range(100))
        m, runs[(core, dtype)] = counted_run(
            tag, lambda: s.train_step(*batches[1], seed=next(step)), gru_bidir=len(grus),
            **{f"{name}_forward{sfx}": len(blocks), f"{name}_backward{sfx}": len(blocks)})
        if not (np.isfinite(m["loss"].item()) and np.isfinite(m["grad_norm"].item())):
            raise AssertionError(f"{tag}: loss {m['loss'].item()}, grad_norm {m['grad_norm'].item()}")
        dt, peak = timed_runs(lambda i: s.train_step(*batches[2 + i], seed=10 + i), GEOMETRY_STEPS)
        log(f"{tag}: train_step B={B} {'bf16 AMP' if amp else 'fp32'} dropout 0.1: {dt * 1e3:.2f} ms/step, "
            f"{B / dt:.1f} images/s on {card}; peak memory {peak:.2f} GiB")
        if amp:
            check_float32_state(tag, s)
        del s
        systems = {d: DPMNSystem(geometry_cfg(geo, 2), geometry_args(geo, **ZERO_RATES), device=d, seed=0,
                                 train_core=core, train_dtype=dtype) for d in (dev, "cpu")}
        hr, lr = batches[1][0][:2], batches[1][1][:2]
        if amp:
            hold_amp_card_vs_cpu(tag, systems, dev, hr, lr, core, args=lambda **kw: geometry_args(geo, **kw),
                                 cfg=geometry_cfg(geo, 2),
                                 n_renders=3 if isinstance(GEOMETRIES[geo]["args"], dict) else None)
        else:
            hold_train_card_vs_cpu(tag, systems, dev, lambda sy: sy._micro_grads(hr, lr, 0))
        del systems
    torch.cuda.empty_cache()
    shifts = sorted({tuple(b.shf) for b in blocks})
    return runs, calls, dict(dim=a.dim, hw=a.hw, win=tuple(a.win), heads=a.gnum_heads * len(a.win), shifts=shifts,
                             blocks=len(blocks))


def geometry_k1(dev, geo, g, launches):
    """K1 on float32 and bf16 io at the geometry's blocks (both shift sets,
    faithful, B = 64) against its plain version (1e-4; bf16 2^-7 of
    max|out|); returns the kernels-line entries, timing fields per forward
    (blocks / 2 calls of each shift set)."""
    from dpmn_tpu_torch.models.pgrm import SwinTransformerBlock
    from dpmn_tpu_torch.ops.window_attention import window_attention_block, window_attention_block_plain
    from dpmn_tpu_torch.system import init_weights

    dim, (h, w), win = g["dim"], g["hw"], g["win"]
    gen = torch.Generator().manual_seed(21)
    x32 = [torch.randn(B, h * w, dim, generator=gen).to(dev) for _ in range(2)]
    entries = []
    for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        xq, xkv = (x.to(dtype) for x in x32)
        worst, times = 0.0, []
        for shift in g["shifts"]:
            blk = SwinTransformerBlock(dim, (h, w), g["heads"], list(win), list(shift))
            init_weights(blk, seed=2)
            with torch.no_grad():
                for ln in (blk.norm1_q, blk.norm1_kv):
                    ln.weight.add_(0.1 * torch.randn(dim, generator=gen))
                    ln.bias.add_(0.1 * torch.randn(dim, generator=gen))
                for i in range(len(win)):
                    getattr(blk.attn, f"relative_position_bias_table_{i}").normal_(0, 0.02, generator=gen)
            kw = blk.to(dev).attn.block_args(blk.ln_params())
            kw = bf16_block_args(kw) if sfx else kw
            with torch.no_grad():
                out = window_attention_block(xq, xkv, **kw)
                ref = window_attention_block_plain(xq, xkv, **kw)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                tol = BF16_ROUNDING * ref.float().abs().max().item() if sfx else K1_TOL
                ok = out.dtype == dtype and bool(torch.isfinite(out.float()).all()) and err <= tol
                log(f"geometry {geo} K1{sfx} shift={shift}: max_abs_err {err:.3e} (tol {tol:.3e}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"geometry {geo}: K1{sfx} disagrees with its plain version: {err}")
                worst = max(worst, err)
                times.append((cuda_ms(lambda: window_attention_block(xq, xkv, **kw), iters=5),
                              cuda_ms(lambda: window_attention_block_plain(xq, xkv, **kw), iters=2)))
        l = h * w
        b_ms, b_by = bound_ms(3 * B * l * dim * (2 if sfx else 4), *k1_ops(B, l, dim, win, bf16=bool(sfx)))
        per = g["blocks"] // 2
        k_ms, p_ms = (per * sum(t[i] for t in times) for i in (0, 1))
        log(f"geometry {geo} K1{sfx} B={B}: {k_ms:.4f} ms a forward ({g['blocks']} calls), plain {p_ms:.4f}, "
            f"bound {per * len(times) * b_ms:.4f} ({b_by})")
        entries.append({"name": f"window_attention_block{sfx}[{geo}]", "route": "cuda",
                        "source": "dpmn_tpu_torch/csrc/window_attention.cu",
                        "replaces": "dpmn_tpu/ops/pallas_window.py:500",
                        "launches": launches[f"sr_forward{sfx}"]["window_attention_block"], "max_abs_err": worst,
                        "ms": k_ms, "plain_ms": p_ms, "bound_ms": per * len(times) * b_ms, "bound_by": b_by,
                        "library_ms": None})
    return entries


def geometry_core(dev, geo, g, core, dtype, launches):
    """A training core (K3, K4, K5) on float32 or bf16 io at the geometry's
    blocks, B = 64, both shift sets, keep 1 and 0.9, against autograd
    through its plain version (hold_against_plain; bf16 hold_bf16_core); K4
    beside SDPA on the partitioned windows.  Returns its forward and
    backward kernels-line entries (per train step: blocks / 2 calls of each
    shift set at keep 0.9) where the geometry's path ran it, else []."""
    import importlib

    import torch.nn.functional as F

    from dpmn_tpu_torch.ops import window_attention_train as wt

    name, fn_name = BF16_CORES[core]
    mod = importlib.import_module(f"dpmn_tpu_torch.ops.{name}")
    amp = dtype == torch.bfloat16
    tag = f"geometry {geo} {CORE_TAGS[core]}{' bf16' if amp else ''}"
    dim, (h, w) = g["dim"], g["hw"]
    gen = torch.Generator().manual_seed(31)
    cot = torch.randn(B, h * w, dim, generator=gen).to(dev, dtype)
    worst_fwd, worst_grad, times, seed = 0.0, 0.0, [], 77
    for shift in g["shifts"]:
        a, prim, leaves, biases, masks, static = bf16_core_case(dev, core, gen, shift, dim, g["win"], g["heads"],
                                                                batch=B, hw=(h, w), bf=dtype)
        for keep in (1.0, 0.9):
            if amp:
                err, gerr = hold_bf16_core(f"{tag} shift={shift} keep={keep}", mod, fn_name, prim, leaves, biases,
                                           masks, seed, keep, static, cot)
            else:
                run = lambda fn: (lambda out: (out, torch.autograd.grad(out, leaves + biases, cot)))(
                    fn(*prim, biases, masks, seed, keep, *static))
                out, grads = run(getattr(mod, fn_name))
                ref, ref_grads = run(getattr(mod, fn_name + "_plain"))
                err, gerr = hold_against_plain(f"{tag} shift={shift} keep={keep}", out, ref, grads, ref_grads)
            worst_fwd, worst_grad = max(worst_fwd, err), max(worst_grad, gerr)
        keep = 0.9
        st = wt.make_static(masks, seed, keep, *static)
        p_det, b_det = [t.detach() for t in prim], [t.detach() for t in biases]
        kept = mod._forward_cuda(st, p_det, b_det)[1]
        k_fwd = cuda_ms(lambda: mod._forward_cuda(st, p_det, b_det), iters=5)
        k_bwd = cuda_ms(lambda: mod._backward_cuda(st, p_det, b_det, cot, kept), iters=5)
        plain = getattr(mod, fn_name + "_plain")
        p_fwd = cuda_ms(lambda: plain(*p_det, b_det, masks, seed, keep, *static), iters=2)
        out = plain(*prim, biases, masks, seed, keep, *static)
        p_bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves + biases, cot, retain_graph=True), iters=2)
        del out
        l_fwd = l_bwd = 0.0
        if core == "attention":
            sdpa_args = [([t.detach().to(dtype).requires_grad_() for t in qkv_g], m.to(dtype), do.to(dtype))
                         for qkv_g, m, do in sdpa_groups(a, b_det, masks, h, w, gen, dev)]
            l_fwd = cuda_ms(lambda: [F.scaled_dot_product_attention(*qkv_g, attn_mask=m, scale=a.scale)
                                     for qkv_g, m, _ in sdpa_args], iters=5)
            outs = [F.scaled_dot_product_attention(*qkv_g, attn_mask=m, scale=a.scale) for qkv_g, m, _ in sdpa_args]
            l_bwd = cuda_ms(lambda: [torch.autograd.grad(o, qkv_g, do, retain_graph=True)
                                     for o, (qkv_g, _, do) in zip(outs, sdpa_args)], iters=5)
            del outs
        times.append((k_fwd, k_bwd, p_fwd, p_bwd, l_fwd, l_bwd))
        log(f"{tag} B={B} shift={shift} keep=0.9: forward {k_fwd:.4f} ms a call, backward {k_bwd:.4f}; plain "
            f"forward {p_fwd:.4f}, backward {p_bwd:.4f}" + (f"; SDPA (head dim {dim // len(g['win']) // static[2]}) "
                                                             f"forward {l_fwd:.4f}, backward {l_bwd:.4f}"
                                                             if core == "attention" else ""))
    cost = {"block": k3_cost, "attention": k4_cost, "full": k5_cost}[core](B, (h, w), dim, g["win"])
    t = B * h * w
    skconv = 2 * t * dim * dim + 2 * t * (dim // len(g["win"])) * dim if core == "full" else 0.0
    if amp:
        fb = bound_ms(cost["fwd_bytes"] / 2, 0.0, 0.0, cost["fwd_flops"] - skconv, skconv)
        bb = bound_ms(cost["bwd_bytes"] / 2, 0.0, 3 * skconv, cost["bwd_flops"] - 3 * skconv)
    else:
        fb, bb = bound_ms(cost["fwd_bytes"], cost["fwd_flops"]), bound_ms(cost["bwd_bytes"], cost["bwd_flops"])
    per = g["blocks"] // 2
    step = lambda i: per * sum(x[i] for x in times)
    n = per * len(times)
    log(f"{tag}: a train step's {g['blocks']} calls: forward {step(0):.4f} ms (plain {step(2):.4f}, bound "
        f"{n * fb[0]:.4f} {fb[1]}), backward {step(1):.4f} ms (plain {step(3):.4f}, bound {n * bb[0]:.4f} {bb[1]})"
        + (f"; SDPA forward {step(4):.4f}, backward {step(5):.4f}" if core == "attention" else ""))
    counts = launches.get((core, "bfloat16" if amp else None))
    if counts is None:
        return []
    sfx = "_bf16" if amp else ""
    common = {"route": "cuda", "source": f"dpmn_tpu_torch/csrc/{name}.cu"}
    return [{"name": f"{name}_{part}{sfx}[{geo}]", **common, "replaces": REPLACES[name][i],
             "launches": counts[f"{name}_{part}{sfx}"], "max_abs_err": (worst_fwd, worst_grad)[i], "ms": step(i),
             "plain_ms": step(2 + i), "bound_ms": n * bd[0], "bound_by": bd[1],
             "library_ms": step(4 + i) if core == "attention" else None}
            for i, (part, bd) in enumerate((("forward", fb), ("backward", bb)))]


def geometry_k2(dev, geo, calls, launches):
    """K2 at the (N, T, H) of the geometry's path (gru_encoding's input
    broadcast along time where its T is the batch) against its plain
    version (1e-5), torch.nn.GRU timed beside it as phase 3 does; returns
    its kernels-line entry (per forward) where the hidden sizes are not the
    flagship's, else None."""
    from dpmn_tpu_torch.ops.gru import gru_bidir, gru_bidir_plain

    if all(hd in (32, 512) for _, _, hd, _ in calls):
        return None
    gen = torch.Generator().manual_seed(41)
    worst, tot, by = 0.0, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}, {"bytes": 0.0,
                                                                                             "operations": 0.0}
    for (n, t, hd, bcast), count in sorted({c: calls.count(c) for c in calls}.items()):
        # bcast: the faithful gru_encoding, one projection at every step
        xps = [(0.5 * torch.randn(n, 1 if bcast else t, 3 * hd, generator=gen)).to(dev) for _ in range(2)]
        xps = [x.expand(-1, t, -1) for x in xps] if bcast else xps
        w_hh = [(torch.rand(3 * hd, hd, generator=gen) * 2 - 1).div(hd**0.5).to(dev) for _ in range(2)]
        b_hh = [(torch.rand(3 * hd, generator=gen) * 2 - 1).div(hd**0.5).to(dev) for _ in range(2)]
        args = (*xps, *w_hh, *b_hh)
        err = (gru_bidir(*args) - gru_bidir_plain(*args)).abs().max().item()
        if not err <= K2_TOL:
            raise AssertionError(f"geometry {geo}: K2 at N={n} T={t} H={hd} disagrees with its plain version: {err}")
        worst = max(worst, err)
        lib = torch.nn.GRU(3 * hd, hd, batch_first=True, bidirectional=True).to(dev)
        with torch.no_grad():
            for d, sfx in enumerate(("l0", "l0_reverse")):
                getattr(lib, f"weight_ih_{sfx}").copy_(torch.eye(3 * hd))
                getattr(lib, f"bias_ih_{sfx}").zero_()
                getattr(lib, f"weight_hh_{sfx}").copy_(w_hh[d])
                getattr(lib, f"bias_hh_{sfx}").copy_(b_hh[d])
            x_lib = xps[0].contiguous()
            k_ms, p_ms, l_ms = (cuda_ms(lambda: gru_bidir(*args)), cuda_ms(lambda: gru_bidir_plain(*args), iters=2),
                                cuda_ms(lambda: lib(x_lib)))
        nbytes = 4 * (2 * n * (1 if bcast else t) * 3 * hd + 2 * (3 * hd * hd + 3 * hd) + n * t * 2 * hd)
        b_ms, b_by = bound_ms(nbytes, 2 * 2 * n * t * 3 * hd * hd)
        log(f"geometry {geo} K2 N={n} T={t} H={hd} ({count} a forward): max_abs_err {err:.3e} (tol {K2_TOL:g}); "
            f"kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms {l_ms:.4f} (torch.nn.GRU) bound_ms {b_ms:.4f} "
            f"({b_by})")
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms), ("bound_ms", b_ms)):
            tot[key] += count * v
        by[b_by] += count * b_ms
    return {"name": f"gru_scan[{geo}]", "route": "cuda", "source": "dpmn_tpu_torch/csrc/gru_scan.cu",
            "replaces": "dpmn_tpu/ops/pallas_kernels.py:76", "launches": launches["sr_forward"]["gru_bidir"],
            "max_abs_err": worst, **tot, "bound_by": max(by, key=by.get)}


def geometry_k7(dev, geo, g):
    """K7 at the geometry's blocks (both shift sets, B = 64), float32 then
    bf16, one counted run of each io type's pair of calls, against its plain
    version, SDPA on the partitioned windows beside it; returns the
    kernels-line entries (summed over the pair, as phase 10's)."""
    import torch.nn.functional as F

    from dpmn_tpu_torch.models.pgrm import WindowAttention
    from dpmn_tpu_torch.ops.grouped_window_attention import grouped_window_attention, grouped_window_attention_plain

    dim, (h, w) = g["dim"], g["hw"]
    gen = torch.Generator().manual_seed(51)
    attns = []
    for shift in g["shifts"]:
        a = WindowAttention(dim, list(g["win"]), list(shift), g["heads"], (h, w))
        with torch.no_grad():
            for i in range(len(g["win"])):
                getattr(a, f"relative_position_bias_table_{i}").normal_(0, 0.1, generator=gen)
        attns.append(a.to(dev))
    q32, k32, v32 = ((0.5 * torch.randn(B, h, w, dim, generator=gen)).to(dev) for _ in range(3))
    entries = []
    for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        calls = [(q, k, v, [b.detach().to(dtype) for b in a.biases()], a.masks(), a.win, a.shf, a.gnum_heads,
                  a.scale) for a in attns]
        outs, launches = counted_run(f"geometry {geo} K7 {dtype}", lambda: [grouped_window_attention(*c) for c in calls],
                                     grouped_window_attention=len(calls))
        worst, tot, bound = 0.0, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}, {"bytes": 0.0, "operations": 0.0}
        for a, args, out in zip(attns, calls, outs):
            ref = grouped_window_attention_plain(*args)
            err = (out.float() - ref.float()).abs().max().item()
            tol = K7_TOL if dtype == torch.float32 else BF16_ROUNDING * ref.float().abs().max().item()
            if not (bool(torch.isfinite(out.float()).all()) and out.dtype == dtype and err <= tol):
                raise AssertionError(f"geometry {geo}: K7 {dtype} disagrees with its plain version: {err}")
            worst = max(worst, err)
            sdpa = sdpa_windows(a, q, k, v, dtype)
            nbytes, flops = k7_cost(a, dtype, h, w)
            b_ms, b_by = bound_ms(nbytes, flops)
            k_ms, p_ms, l_ms = (cuda_ms(lambda: grouped_window_attention(*args), iters=5),
                                cuda_ms(lambda: grouped_window_attention_plain(*args), iters=2),
                                cuda_ms(lambda: [F.scaled_dot_product_attention(qg, kg, vg, attn_mask=m, scale=a.scale)
                                                 for qg, kg, vg, m in sdpa], iters=5))
            log(f"geometry {geo} K7 {dtype} B={B} shift={tuple(a.shf)}: max_abs_err {err:.3e} (tol {tol:.3e}) ok; "
                f"kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms {l_ms:.4f} (SDPA on the partitioned windows) "
                f"bound_ms {b_ms:.4f} ({b_by})")
            for key, t in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms)):
                tot[key] += t
            bound[b_by] += b_ms
        entries.append(standalone_entry("grouped_window_attention", worst, launches["grouped_window_attention"],
                                        tot["ms"], tot["plain_ms"], bound, tot["library_ms"], f"{sfx}[{geo}]"))
    return entries


def phase_geometries(dev, card):
    """Phase 15: each geometry's path (geometry_path), then each kernel at
    its blocks against its plain version with its times and bounds (K1, the
    three training cores on both io types, K7, and K2 at hidden sizes other
    than the flagship's).  Returns the kernels-line entries of the kernels
    each path ran (and K7's)."""
    entries = []
    for geo in GEOMETRIES:
        t0 = time.perf_counter()
        launches, calls, g = geometry_path(dev, card, geo)
        entries += geometry_k1(dev, geo, g, launches)
        k2 = geometry_k2(dev, geo, calls, launches)
        entries += [k2] if k2 else []
        for core in ("block", "attention", "full"):
            for dtype in (torch.float32, torch.bfloat16):
                entries += geometry_core(dev, geo, g, core, dtype, launches)
        entries += geometry_k7(dev, geo, g)
        torch.cuda.empty_cache()
        log(f"geometry {geo}: phase done in {time.perf_counter() - t0:.1f} s")
    return entries


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
                                            (phase_k4, "attention", "window_attention_core", 2),
                                            (phase_k5, "full", "window_attention_full", 2)):
        fwd, bwd = phase_kernel(dev)
        launches = phase_train(dev, card, core, timed)
        fwd["launches"], bwd["launches"] = launches[f"{name}_forward"], launches[f"{name}_backward"]
        entries += [fwd, bwd]
    # the bf16 AMP step under each core, on its kernel's bf16 io
    for core, timed in (("block", 3), ("attention", 3), ("full", 3)):
        name = BF16_CORES[core][0]
        fwd, bwd = phase_core_bf16(dev, core)
        launches = phase_train(dev, card, core, timed, train_dtype="bfloat16")
        fwd["launches"], bwd["launches"] = launches[f"{name}_forward_bf16"], launches[f"{name}_backward_bf16"]
        entries += [fwd, bwd]
    entries.append(phase_k8(dev))
    entries += phase_k7(dev)
    entries.append(phase_k6(dev))
    entries.append(phase_k9(dev))
    phase_driver(dev, card)
    phase_psns(dev, card)
    phase_reference_checkpoints(dev, card)
    entries += phase_geometries(dev, card)
    log(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
