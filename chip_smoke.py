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
  4. the main path: the flagship DPMNSystem.sr_forward at B = 64 with seeded
     random weights — launch counts of each kernel over one forward, output
     shape and finiteness, images/s; then the same weights on 2 images on the
     CPU (plain versions) against the card;
  5. one JSON line with every kernel's numbers, then the final JSON line.

Times are CUDA-event times after warm-up, with the inputs resident in L2
where they fit.  `ms`, `plain_ms`, `library_ms` and `bound_ms` in the kernels
line are per flagship forward: the sum over all of the kernel's launches in
one sr_forward at B = 64.  Bounds use the published H100 SXM peaks: 3.35 TB/s
and 67 TFLOP/s float32 on the CUDA cores.  It imports nothing of JAX.
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


def phase_path(dev, card):
    """The flagship sr_forward at B = 64; returns the launch counts of one forward."""
    from dpmn_tpu_torch.config import TrainCfg, flagship_args
    from dpmn_tpu_torch.ops.gru import gru_scan_counter
    from dpmn_tpu_torch.ops.window_attention import window_attention_counter
    from dpmn_tpu_torch.system import DPMNSystem

    t0 = time.perf_counter()
    system = DPMNSystem(TrainCfg(batch_size=B), flagship_args(), device=dev, seed=0)
    log(f"path: flagship system built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in system.parameters()) / 1e6:.1f} M parameters)")
    rng = np.random.RandomState(0)
    batches = [rng.rand(B, 16, 64, 4).astype(np.float32) for _ in range(6)]
    out = system.sr_forward(batches[0])  # warm-up
    torch.cuda.synchronize()

    window_attention_counter.launches = gru_scan_counter.launches = 0
    out = system.sr_forward(batches[1])
    torch.cuda.synchronize()
    launches = {"window_attention_block": window_attention_counter.launches,
                "gru_scan": gru_scan_counter.launches}
    log(f"path: launches in one forward {launches} (expected 12 window-attention blocks, "
        f"22 GRU scans: 5 SRBs x 2 sweeps x 2 directions + gru_encoding x 2)")
    if launches != {"window_attention_block": 12, "gru_scan": 22}:
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
    log(card)
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
