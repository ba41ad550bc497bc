// The training forward and backward of a PGRM window-attention block core,
// for sm_90a.
//
// Replaces the TPU kernel pair dpmn_tpu/ops/pallas_window_train.py::
// window_attention_block_core: the forward _block_fwd (pallas_call at :399)
// and the recomputing backward _block_bwd_impl (pallas_call at :525).  For
// pre-norm tokens xq, xkv of shape (B, L = H*W, D):
//   forward  LN (float32 statistics, var = E[x^2] - mean^2 clamped at 0,
//            eps 1e-6) of both streams, q = ln(xq) Wq^T + bq and
//            kv = ln(xkv) Wkv^T + bkv; per channel group (window ws, shift
//            sh, N = ws*ws) and head: the -sh roll, the window partition,
//            P = softmax(scale q k^T + rel_bias [+ shift mask]), the dropout
//            mask M on P (kept entries scaled by 1/keep), (P*M) v written in
//            the faithful raw layout (row window*N + i of each group slice).
//   backward from the primal inputs and dout only: recompute LN and the
//            projections; per (image, group, window, head) regenerate P and
//            M and form dV = (P*M)^T dO, dP = (dO V^T)*M,
//            dS = P*(dP - rowsum(dP*P)), dQ = scale dS K, dK = dS^T (scale Q);
//            un-partition and un-roll them to token order; dbias = sum of dS
//            over images and windows; the projection backward
//            (dx_ln = dq Wq, dWq = dq^T x_ln, dbq = sum dq; the same for kv)
//            and the LN backward (dscale = sum dx_ln*xhat, dbias = sum dx_ln).
// Every cross-block sum goes through per-block partials and a second,
// fixed-order pass (sum_rows_kernel): no float atomics, so reruns agree bit
// for bit.  The dropout mask is the counter-based hash of window_common.cuh,
// which the plain PyTorch version evaluates exactly.
//
// What bounds it on an H100 at B = 64 and the flagship geometry (L = 1024,
// D = 96, windows 2/4/8, 2 heads of 16 per group), each input read once and
// each output written once: forward 75.5 MB (xq, xkv, out) and 4.3 GFLOP
// (projections 3.62, attention 0.70) = 65 us at 67 TFLOP/s float32;
// backward 126 MB (xq, xkv, dout, dxq, dxkv) and 12.6 GFLOP (recomputed
// projections 3.62, attention backward with the recomputed scores 1.76,
// projection backward 7.25) = 188 us.  The design: the projections, their
// backward (dx_ln = dy W and dW = dy^T x_ln) and the attention backward of
// the 4x4 and 8x8 windows run on the tensor cores (mma.sync with the 3xTF32
// split, tc_common.cuh); the LN + projection and the projection backward
// are persistent CTAs that stage their weight once; the forward attention
// is window_common.cuh window_attn_fwd_kernel (4x4 and 8x8 windows on the
// tensor cores), the 2x2 windows' backward window_attn_bwd4_kernel.
// Measured on an H100 SXM at 700 W (PERF.md): forward about 0.22 ms a call
// (ln_proj 0.13, the attention 0.07), backward about 0.72 ms (the
// projection backward and dW 0.35, ln_proj 0.13, the attention backward
// 0.18, of it 0.03 the 2x2 windows', the fixed-order sums 0.03).  q, kv, dq
// and dkv still round-trip through device memory.

#include "window_train_common.cuh"

// Shapes: xq, xkv, out (B, L, D) with L = H*W; q_w (D, D), kv_w (2D, D) in
// torch Linear layout; LN scales and biases (D,).  bias: per group
// (gh, N_g, N_g), concatenated; mask: per shifted group (nW_g, N_g, N_g),
// concatenated.  Scratch: qbuf (B, L, D), kvbuf (B, L, 2D).  ws and shifts
// are host arrays of n_group ints.  With drop, entries whose hash clears
// thresh are kept and scaled by inv_keep.  Needs L % 64 == 0, D % 32 == 0
// with D <= 96, windows of 2, 4 or 8 dividing H and W, and a head dim of
// GCH = 16; the Python wrapper checks these.  Returns cudaGetLastError()
// after the last launch (or the first failing one).
extern "C" int window_attention_train_forward(
    const float* xq, const float* xkv, const float* qs, const float* qb, const float* ks, const float* kb,
    const float* q_w, const float* q_b, const float* kv_w, const float* kv_b, const float* bias,
    const float* mask, float* qbuf, float* kvbuf, float* out, int B, int H, int W, int D, int n_group,
    const int* ws, const int* shifts, int gh, float scale, uint32_t seed, uint32_t thresh, float inv_keep,
    int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D / n_group != gh * GCH) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_ln_proj(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, B * H * W, D, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_attn_groups_any(qbuf, kvbuf, kvbuf + D, 2 * D, bias, mask, out, B, H, W, D, n_group, ws, shifts, gh,
                               scale, 0, seed, thresh, inv_keep, drop, st);
  return static_cast<int>(err);
}

// The floats of the backward's dbias_part scratch.
extern "C" size_t window_attention_train_backward_scratch(int B, int H, int W, int n_group, const int* ws, int gh) {
  return attn_bwd_part_floats(B, H, W, n_group, ws, gh);
}

// The backward, from the forward's inputs and dout (B, L, D).  Scratch the
// caller allocates: qbuf (B, L, D), kvbuf (B, L, 2D), dqbuf (B, L, D), dkvbuf
// (B, L, 2D), dbias_part (window_attention_train_backward_scratch floats),
// wpart_q (S, D*D + D) and wpart_kv (S, 2D*D + 2D) with
// S = ceil(B*L / 512), lnpart_q and lnpart_kv (B*L / 64, 2D).  Outputs: dxq,
// dxkv (B, L, D); gq = [dWq (D, D) | dbq (D)], gkv = [dWkv (2D, D) | dbkv
// (2D)]; gln_q = [dqs | dqb], gln_kv = [dks | dkb] (2D each); dbias laid out
// as bias.
extern "C" int window_attention_train_backward(
    const float* xq, const float* xkv, const float* qs, const float* qb, const float* ks, const float* kb,
    const float* q_w, const float* q_b, const float* kv_w, const float* kv_b, const float* bias,
    const float* mask, const float* dout, float* qbuf, float* kvbuf, float* dqbuf, float* dkvbuf,
    float* dbias_part, float* wpart_q, float* wpart_kv, float* lnpart_q, float* lnpart_kv, float* dxq,
    float* dxkv, float* gq, float* gkv, float* gln_q, float* gln_kv, float* dbias, int B, int H, int W, int D,
    int n_group, const int* ws, const int* shifts, int gh, float scale, uint32_t seed, uint32_t thresh,
    float inv_keep, int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntok = B * H * W;
  if (D / n_group != gh * GCH) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_ln_proj(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, D, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_attn_bwd_groups_any(qbuf, kvbuf, kvbuf + D, 2 * D, dout, bias, mask, dqbuf, dkvbuf, dkvbuf + D,
                                   dbias_part, dbias, B, H, W, D, n_group, ws, shifts, gh, scale, seed, thresh,
                                   inv_keep, drop, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ln_proj_bwd(xq, xkv, qs, qb, ks, kb, q_w, kv_w, dqbuf, dkvbuf, wpart_q, wpart_kv,
                                             lnpart_q, lnpart_kv, dxq, dxkv, gq, gkv, gln_q, gln_kv, ntok, D, st));
}
