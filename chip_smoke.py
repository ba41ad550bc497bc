#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dpmn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, on a machine with a card

Phases, each of which raises (and so exits non-zero) on failure:
  1. setup: the card's name and power limit, torch / CUDA versions, and the
     build of every CUDA kernel under dpmn_tpu_torch/csrc (nvcc, in parallel);
  2. the window-attention kernel against its plain PyTorch version on the
     card at B = 64 and the flagship geometry: both shift sets, both layouts;
  3. the GRU-scan kernel against its plain version at the three main-path
     shapes, forward and reverse, with torch.nn.GRU (cuDNN) timed beside it;
  4. the eval path: the flagship DPMNSystem.sr_forward at B = 64 with seeded
     random weights — launch counts of each kernel over one forward, output
     shape and finiteness, images/s; then the same weights on 2 images on the
     CPU (plain versions) against the card;
  5. the training window-attention kernel K3, forward and backward, against
     autograd through its plain version at B = 64 and the flagship geometry:
     both shift sets, both layouts, dropout off and at keep 0.9 from one seed;
     times of kernel, plain version and an SDPA yardstick, and the bounds;
  6. the train path: the flagship DPMNSystem.train_step at B = 64 (fp32,
     dropout 0.1) — launch counts over one step, finite loss and grad_norm,
     images/s, ms/step and peak memory; then the same weights at rates 0 on 2
     images on the CPU against the card (loss, grad_norm, every gradient, the
     students' ids);
  7. one JSON line with every kernel's numbers, then the final JSON line.

Times are CUDA-event times after warm-up, with the inputs resident in L2
where they fit.  `ms`, `plain_ms`, `library_ms` and `bound_ms` in the kernels
line are per call of the path that launches the kernel: K1 and K2 per
flagship forward (the sum over their launches in one sr_forward at B = 64),
K3 per flagship train step (12 forward and 12 backward launches).  Bounds use
the published H100 SXM peaks: 3.35 TB/s and 67 TFLOP/s float32 on the CUDA
cores.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
B = 64
K1_TOL = 1e-4  # max abs error: float32, other summation orders over <= 96-term sums
K2_TOL = 1e-5  # max abs error of a tanh-bounded state after <= 64 float32 steps
K3_TOL = 1e-4  # forward max abs error: as K1
K3_GRAD_RTOL, K3_GRAD_ATOL = 1e-4, 1e-5  # per gradient: max abs <= rtol * max|ref| + atol (sums over 65536 tokens)


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


def bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
    for name, report in kernels.ptxas_report.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  ptxas {name}: {line.strip()}")
    return card


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
    worst, times = 0.0, {}
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
                    times[shift] = (cuda_ms(lambda: window_attention_block(xq, xkv, **kw)),
                                    cuda_ms(lambda: window_attention_block_plain(xq, xkv, **kw), iters=5))
    l, n_sum, ch = h * w, 4 + 16 + 64, dim // 3
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
    """K2 vs its plain version at the main-path shapes; torch.nn.GRU beside
    it (identity input weights, so cuDNN runs the same recurrence over the
    same x_proj — its time includes that extra input GEMM)."""
    from dpmn_tpu_torch.ops.gru import gru_scan, gru_scan_plain

    # (N, T, H, scans per forward): vertical and horizontal SRB sweeps (5 SRBs
    # x 2 directions each) and the faithful gru_encoding (2 directions)
    shapes = [(64 * B, 16, 32, 10), (16 * B, 64, 32, 10), (64, B, 512, 2)]
    gen = torch.Generator().manual_seed(3)
    worst, tot = 0.0, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    by_time = {"bytes": 0.0, "operations": 0.0}
    for n, t, hd, count in shapes:
        x_proj = (0.5 * torch.randn(n, t, 3 * hd, generator=gen)).to(dev)
        w_hh = (torch.rand(3 * hd, hd, generator=gen) * 2 - 1).div(hd**0.5).to(dev)
        b_hh = (torch.rand(3 * hd, generator=gen) * 2 - 1).div(hd**0.5).to(dev)
        for reverse in (False, True):
            out = gru_scan(x_proj, w_hh, b_hh, reverse)
            ref = gru_scan_plain(x_proj, w_hh, b_hh, reverse)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ok = torch.isfinite(out).all().item() and err <= K2_TOL
            log(f"K2 N={n} T={t} H={hd} reverse={reverse}: max_abs_err {err:.3e} (tol {K2_TOL:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"gru_scan kernel disagrees with its plain version: {err}")
            worst = max(worst, err)
        lib = torch.nn.GRU(3 * hd, hd, batch_first=True).to(dev)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(torch.eye(3 * hd))
            lib.bias_ih_l0.zero_()
            lib.weight_hh_l0.copy_(w_hh)
            lib.bias_hh_l0.copy_(b_hh)
            lib_err = (lib(x_proj)[0] - gru_scan(x_proj, w_hh, b_hh)).abs().max().item()
            k_ms = cuda_ms(lambda: gru_scan(x_proj, w_hh, b_hh))
            p_ms = cuda_ms(lambda: gru_scan_plain(x_proj, w_hh, b_hh), iters=3)
            l_ms = cuda_ms(lambda: lib(x_proj))
        nbytes = 4 * (x_proj.numel() + w_hh.numel() + b_hh.numel() + n * t * hd)
        b_ms, by_s = bound_ms(nbytes, 2 * n * t * 3 * hd * hd)
        log(f"K2 N={n} T={t} H={hd}: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms {l_ms:.4f} "
            f"(torch.nn.GRU, |diff| {lib_err:.1e}) bound_ms {b_ms:.4f} ({by_s})")
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms), ("bound_ms", b_ms)):
            tot[key] += count * v
        by_time[by_s] += count * b_ms
    return {"name": "gru_scan", "route": "cuda", "source": "dpmn_tpu_torch/csrc/gru_scan.cu",
            "replaces": "dpmn_tpu/ops/pallas_kernels.py:76", "max_abs_err": worst, **tot,
            "bound_by": max(by_time, key=by_time.get)}


def counters():
    from dpmn_tpu_torch.ops import window_attention_train as wt
    from dpmn_tpu_torch.ops.gru import gru_scan_counter
    from dpmn_tpu_torch.ops.window_attention import window_attention_counter

    return {"window_attention_block": window_attention_counter, "gru_scan": gru_scan_counter,
            "window_attention_train_forward": wt.forward_counter,
            "window_attention_train_backward": wt.backward_counter}


def reset_counts():
    for c in counters().values():
        c.launches = 0


def read_counts():
    return {name: c.launches for name, c in counters().items()}


def phase_path(dev, card):
    """The flagship sr_forward at B = 64; returns the launch counts of one forward."""
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
    log(f"path: launches in one forward {launches} (expected 12 window-attention blocks, "
        f"22 GRU scans: 5 SRBs x 2 sweeps x 2 directions + gru_encoding x 2; no training kernel)")
    if launches != {"window_attention_block": 12, "gru_scan": 22, "window_attention_train_forward": 0,
                    "window_attention_train_backward": 0}:
        raise AssertionError(f"main path launch counts {launches}")
    if tuple(out.shape) != (B, 32, 128, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"bad output: shape {tuple(out.shape)}, finite {torch.isfinite(out).all().item()}")

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
    return launches


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


def phase_k3(dev):
    """K3 forward and backward against autograd through the plain version at
    B = 64; returns the kernels-line entries of its two entry points (timing
    fields per train step: 6 unshifted + 6 shifted calls, keep 0.9)."""
    import torch.nn.functional as F

    from dpmn_tpu_torch.models.pgrm import SwinTransformerBlock
    from dpmn_tpu_torch.ops import window_attention_train as wt
    from dpmn_tpu_torch.system import init_weights

    h, w, dim, seed = 16, 64, 96, 1234
    gen = torch.Generator().manual_seed(4)
    xq = torch.randn(B, h * w, dim, generator=gen).to(dev)
    xkv = torch.randn(B, h * w, dim, generator=gen).to(dev)
    cot = torch.randn(B, h * w, dim, generator=gen).to(dev)
    worst_fwd, worst_grad, times = 0.0, 0.0, {}
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
        masks = [getattr(a, f"shift_mask_{i}").to(dev) if sh > 0 else None for i, sh in enumerate(a.shf)]
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
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                gerr = max(((g - r).abs().max() / (K3_GRAD_RTOL * r.abs().max() + K3_GRAD_ATOL)).item()
                           for g, r in zip(grads, ref_grads))
                ok = bool(torch.isfinite(out).all()) and err <= K3_TOL and gerr <= 1.0
                log(f"K3 shift={shift} layout={layout} keep={keep}: forward max_abs_err {err:.3e} (tol {K3_TOL:g}); "
                    f"worst gradient at {gerr:.3f} of its tolerance (max abs <= {K3_GRAD_RTOL:g} * max|ref| + "
                    f"{K3_GRAD_ATOL:g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"window_attention_train kernels disagree with the plain version: {err}, {gerr}")
                worst_fwd = max(worst_fwd, err)
                worst_grad = max(worst_grad, max((g - r).abs().max().item() for g, r in zip(grads, ref_grads)))
        # times at the main path's call: faithful layout, keep 0.9
        keep = 0.9
        st = wt._Static(tuple(masks), tuple(a.win), tuple(a.shf), a.gnum_heads, float(a.scale), a.hw, seed, keep)
        p_det = [t.detach() for t in prim]
        b_det = [t.detach() for t in biases]
        k_fwd = cuda_ms(lambda: wt._forward_cuda(st, p_det, b_det))
        k_bwd = cuda_ms(lambda: wt._backward_cuda(st, p_det, b_det, cot))
        p_fwd = cuda_ms(lambda: wt.window_attention_block_core_plain(*p_det, b_det, masks, seed, keep, *static),
                        iters=5)
        out = wt.window_attention_block_core_plain(*prim, biases, masks, seed, keep, *static)
        p_bwd = cuda_ms(lambda: torch.autograd.grad(out, prim + biases, cot, retain_graph=True), iters=5)
        del out
        # the attention core alone through SDPA, forward + backward, on the
        # window-partitioned q/k/v of each group with bias + shift mask as
        # attn_mask (no LN, projections or dropout)
        sdpa_args = []
        for g, (ws, sh) in enumerate(zip(a.win, a.shf)):
            n, nw = ws * ws, (h // ws) * (w // ws)
            qkv = [torch.randn(B * nw, a.gnum_heads, n, 16, generator=gen).to(dev).requires_grad_() for _ in range(3)]
            mask = b_det[g][None].expand(B * nw, -1, -1, -1)
            if sh > 0:
                mask = (b_det[g][None, None] + masks[g][None, :, None]).expand(B, -1, -1, -1, -1).reshape(
                    B * nw, a.gnum_heads, n, n)
            sdpa_args.append((qkv, mask.contiguous(), torch.randn(B * nw, a.gnum_heads, n, 16, generator=gen).to(dev)))

        def sdpa():
            for qkv, mask, do in sdpa_args:
                o = F.scaled_dot_product_attention(*qkv, attn_mask=mask, scale=a.scale)
                torch.autograd.grad(o, qkv, do)

        times[shift] = (k_fwd, k_bwd, p_fwd, p_bwd, cuda_ms(sdpa))
    cost = k3_cost(B, (h, w), dim, (2, 4, 8))
    fb_ms, fb_by = bound_ms(cost["fwd_bytes"], cost["fwd_flops"])
    bb_ms, bb_by = bound_ms(cost["bwd_bytes"], cost["bwd_flops"])
    for shift, (kf, kb, pf, pb, sd) in times.items():
        log(f"K3 B={B} shift={shift} keep=0.9: forward kernel_ms {kf:.4f} plain_ms {pf:.4f} bound_ms {fb_ms:.4f} "
            f"({fb_by}; {cost['fwd_bytes'] / 1e6:.1f} MB, {cost['fwd_flops'] / 1e9:.2f} GFLOP); backward kernel_ms "
            f"{kb:.4f} plain_ms {pb:.4f} bound_ms {bb_ms:.4f} ({bb_by}; {cost['bwd_bytes'] / 1e6:.1f} MB, "
            f"{cost['bwd_flops'] / 1e9:.2f} GFLOP); SDPA attention core fwd+bwd {sd:.4f} ms")
    per_step = lambda i: 6 * (times[(0, 0, 0)][i] + times[(1, 2, 4)][i])
    common = {"route": "cuda", "source": "dpmn_tpu_torch/csrc/window_attention_train.cu", "library_ms": None,
              "sdpa_attention_core_fwd_bwd_ms": per_step(4)}
    fwd = {"name": "window_attention_train_forward", **common, "replaces": "dpmn_tpu/ops/pallas_window_train.py:399",
           "max_abs_err": worst_fwd, "ms": per_step(0), "plain_ms": per_step(2), "bound_ms": 12 * fb_ms,
           "bound_by": fb_by}
    bwd = {"name": "window_attention_train_backward", **common, "replaces": "dpmn_tpu/ops/pallas_window_train.py:525",
           "max_abs_err": worst_grad, "ms": per_step(1), "plain_ms": per_step(3), "bound_ms": 12 * bb_ms,
           "bound_by": bb_by}
    return fwd, bwd


def phase_train(dev, card):
    """The flagship train_step at B = 64; returns the launch counts of one step."""
    from dpmn_tpu_torch.config import TrainCfg, flagship_args
    from dpmn_tpu_torch.system import DPMNSystem

    t0 = time.perf_counter()
    system = DPMNSystem(TrainCfg(batch_size=B), flagship_args(), device=dev, seed=0)
    log(f"train: flagship system built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in system.trainable_parameters()) / 1e6:.1f} M trainable parameters)")
    rng = np.random.RandomState(1)
    batches = [(rng.rand(B, 32, 128, 4).astype(np.float32), rng.rand(B, 16, 64, 4).astype(np.float32))
               for _ in range(6)]
    m = system.train_step(*batches[0], seed=0)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    m = system.train_step(*batches[1], seed=1)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"train: launches in one step {launches} (expected 12 K3 forward and 12 backward, 22 GRU scans in the "
        f"frozen PSN, no eval block)")
    if launches != {"window_attention_block": 0, "gru_scan": 22, "window_attention_train_forward": 12,
                    "window_attention_train_backward": 12}:
        raise AssertionError(f"train path launch counts {launches}")
    loss, gnorm = m["loss"].item(), m["grad_norm"].item()
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        raise AssertionError(f"train step: loss {loss}, grad_norm {gnorm}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i, (hr, lr) in enumerate(batches[2:]):
        m = system.train_step(hr, lr, seed=2 + i)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / len(batches[2:])
    log(f"train: flagship train_step B={B} fp32 dropout 0.1: {dt * 1e3:.2f} ms/step, {B / dt:.1f} images/s on {card}; "
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
    systems = {d: DPMNSystem(TrainCfg(batch_size=2), flagship_args(**zero), device=d, seed=0) for d in (dev, "cpu")}
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
    log(f"train: card vs CPU on 2 images at rates 0: loss {lg:.6f} vs {lc:.6f} (rel {l_rel:.2e}, tol 1e-5); grad_norm "
        f"{ng:.4f} vs {nc:.4f} (rel {n_rel:.2e}, tol 1e-4); gradients: worst leaf {worst_name} at {worst:.3f} of its "
        f"tolerance (|diff| <= 5e-2 |ref| + 1e-4 grad_norm, in norm), all together {total:.2e} of their norm (tol "
        f"1e-3); students' ids equal {ids_ok}")
    if not (l_rel <= 1e-5 and n_rel <= 1e-4 and worst <= 1.0 and total <= 1e-3 and ids_ok):
        raise AssertionError("card and CPU disagree on the train path")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the machine with the card", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda:0")
    card = phase_setup()
    k1 = phase_window_attention(dev)
    k2 = phase_gru(dev)
    launches = phase_path(dev, card)
    k1["launches"], k2["launches"] = launches["window_attention_block"], launches["gru_scan"]
    k3f, k3b = phase_k3(dev)
    launches = phase_train(dev, card)
    k3f["launches"] = launches["window_attention_train_forward"]
    k3b["launches"] = launches["window_attention_train_backward"]
    log(card)
    print(json.dumps({"kernels": [k1, k2, k3f, k3b]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
