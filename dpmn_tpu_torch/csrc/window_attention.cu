// The eval forward of one PGRM window-attention block, for sm_90a.
//
// Replaces the TPU kernel dpmn_tpu/ops/pallas_window.py::
// fused_window_attention_block (pallas_call at :500).  For tokens xq, xkv of
// shape (B, L = H*W, D) it computes:
//   (a) LayerNorm of xq (norm1_q) and xkv (norm1_kv) with float32 statistics,
//       var = E[x^2] - mean^2 clamped at 0, eps 1e-6; then q = xq_n Wq^T + bq
//       and kv = xkv_n Wkv^T + bkv.  Without LN parameters both are skipped
//       and so is the residual in (c).
//   (b) per channel group g (window ws, shift sh, N = ws*ws) and head: the
//       -sh roll, the window partition, softmax(scale*q k^T + rel_bias
//       [+ shift mask]) v, written back either in the faithful raw layout
//       (row p = window*N + token is read as raster token p, the reference's
//       model/pgrm.py:263 quirk) or in the corrected layout (inverse
//       partition, then +sh roll: the row goes back to its source token).
//   (c) SKConv and the residual: feats = attn Wp^T + bp; s = mean over the L
//       tokens of gelu(feats) (exact erf GELU); gate = softmax over groups of
//       fc2(gelu(fc1(s))); out = xkv + feats + (sum_g gate_g * attn_g) Wph^T
//       + bph.
//
// Five kernels behind one entry point: (a) ln_proj, (b) one window-attention
// launch for every group, (c) skconv_proj (feats and per-tile partial sums of the
// GAP), skconv_gate (the fixed-order sum of the partials: no float atomics,
// so reruns agree bit for bit) and skconv_out.  All of them live in
// window_common.cuh, which the training kernels share.
//
// What bounds it on an H100, at B = 64 and the flagship geometry (L = 1024,
// D = 96, windows 2/4/8, 2 heads of 16 channels per group), counting each
// input read once and each output written once: 75.5 MB (xq and xkv read,
// the output written) = 22.5 us at 3.35 TB/s; and 92.8 MFLOP per image
// (projections 56.6, attention 11.0, SKConv 25.2; elementwise work not
// counted), 5.94 GFLOP per call = 89 us at the 67 TFLOP/s float32 rate of the
// CUDA cores.  The design: (a), (c1) and (c3) are persistent CTAs (one per
// SM) that stage their weight once, stream 64-token tiles in by cp.async
// (two stages) and run the products on the tensor cores, mma.sync with the
// 3xTF32 split (tc_common.cuh), which keeps float32 accuracy at three
// tensor-core passes; (b) is window_common.cuh window_attn_fwd_kernel (the
// 4x4 and 8x8 windows on the tensor cores, the 2x2 windows on the CUDA
// cores, one work list).
// Measured on an H100 SXM at 700 W (PERF.md): about 0.33 ms a call, of
// which ln_proj 0.126 ms (its bytes alone take 0.038 ms; it runs 3 x 3.62
// GFLOP on mma.sync), SKConv's products 0.12 ms and the attention 0.055 ms.
// The products are bound by the mma.sync rate times the split's three
// passes (batching ln_proj's LN rows, which shortened its latency, moved
// nothing), and each CTA serializes a tile's load wait, LN, product and
// stores.  Keeping q/kv on chip between (a) and (b), and wgmma for the
// products (which needs the split operands in shared memory) are later
// work.

#include "window_common.cuh"

// Shapes: xq, xkv, out (B, L, D) with L = H*W; q_w (D, D); kv_w (2D, D);
// proj_w (D, D); fc1_w (dz, D); fc2_w (n_group*ch, dz); ph_w (D, ch) — torch
// Linear layouts.  bias: per group (gh, N_g, N_g), concatenated; mask: per
// shifted group (nW_g, N_g, N_g), concatenated.  ln_* may be null (then no LN
// and no residual).  Scratch the caller allocates: qbuf (B, L, D), kvbuf
// (B, L, 2D), attn and feats (B, L, D), partial (B, L/64, D), gate
// (B, n_group, ch).  ws and shifts are host arrays of n_group ints.  Needs
// L % 64 == 0, D % 32 == 0 with D <= 96, windows of 2, 4 or 8 dividing H and
// W, and a head dim (ch / gh) of GCH = 16; the Python wrapper checks these.  Returns
// cudaGetLastError() after the last launch (or the first failing one).
extern "C" int window_attention_block_forward(
    const float* xq, const float* xkv, const float* ln_qs, const float* ln_qb, const float* ln_ks,
    const float* ln_kb, const float* q_w, const float* q_b, const float* kv_w, const float* kv_b,
    const float* bias, const float* mask, const float* proj_w, const float* proj_b, const float* fc1_w,
    const float* fc1_b, const float* fc2_w, const float* fc2_b, const float* ph_w, const float* ph_b,
    float* qbuf, float* kvbuf, float* attn, float* feats, float* partial, float* gate, float* out, int B,
    int H, int W, int D, int n_group, const int* ws, const int* shifts, int gh, int dz, float scale,
    int corrected, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = H * W, ntok = B * L, ch = D / n_group;
  const int do_ln = ln_qs != nullptr;
  cudaError_t err;
  if (ch != gh * GCH) return static_cast<int>(cudaErrorInvalidValue);

  err = launch_ln_proj(xq, xkv, ln_qs, ln_qb, ln_ks, ln_kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, D, do_ln, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_attn_groups<false>(qbuf, kvbuf, kvbuf + D, 2 * D, bias, mask, attn, B, H, W, D, n_group, ws, shifts,
                                  gh, scale, corrected, 0u, 0u, 1.f, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_skconv(attn, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ph_w, ph_b, xkv, feats, partial, gate, out, B,
                      L, D, n_group, dz, do_ln, st);
  return static_cast<int>(err);
}
