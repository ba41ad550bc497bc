// The training forward and backward of the grouped window-attention core on
// projected q, k, v, for sm_90a.
//
// Replaces the TPU kernel pair dpmn_tpu/ops/pallas_window_train.py::
// window_attention_core: the forward _core_fwd (pallas_call at :147) and the
// recomputing backward _core_bwd (pallas_call at :229), the path the JAX
// package takes with DPMN_TPU_FUSE_QKV=0 (LN and the q / kv projections in
// XLA before it).  For q, k, v of shape (B, L = H*W, D):
//   forward  per channel group (window ws, shift sh, N = ws*ws) and head:
//            the -sh roll, the window partition, P = softmax(scale q k^T +
//            rel_bias [+ shift mask]), the dropout mask M on P (kept entries
//            scaled by 1/keep), (P*M) v written in the faithful raw layout
//            (row window*N + i of each group slice);
//   backward from q, k, v and dout only: per (image, group, window, head)
//            regenerate P and M and form dV = (P*M)^T dO, dP = (dO V^T)*M,
//            dS = P*(dP - rowsum(dP*P)), dQ = scale dS K, dK = dS^T (scale Q);
//            un-partition and un-roll them to token order; dbias = the sum of
//            dS over images and windows.
// The kernels are K3's, reading k and v, and writing dk and dv, as tensors
// of their own (row stride D): the forward is window_common.cuh
// window_attn_fwd_kernel (one launch: the 4x4 and 8x8 windows on the
// tensor cores, the 2x2 windows a thread per query row with 16-byte rows),
// the backward window_train_common.cuh window_attn_bwd_tc_kernel (4x4 and 8x8, tensor
// cores) and window_attn_bwd4_kernel (2x2, a quad of lanes per window and
// head over cp.async-staged rows).  dbias goes through per-block partials
// and the fixed-order sum_rows_kernel: no float atomics, so reruns agree bit
// for bit.  The dropout mask is the counter-based hash of window_common.cuh,
// the same draw as K3's.
//
// What bounds it on an H100 at B = 64 and the flagship geometry (L = 1024,
// D = 96, windows 2/4/8, 2 heads of 16 per group), each input read once and
// each output written once: forward 100.7 MB (q, k, v, out) and 0.70 GFLOP
// = 30 us at 3.35 TB/s; backward 176.2 MB (q, k, v, dout, dq, dk, dv) and
// 1.76 GFLOP = 53 us.  Both are bound by bytes.  A unit reads its group's
// channels of each token row (128 contiguous bytes of q, k and v at 2
// heads); the times stand in PERF.md (the backward's per group).

#include "window_train_common.cuh"

// Shapes: q, k, v, out (B, L, D) with L = H*W.  bias: per group
// (gh, N_g, N_g), concatenated; mask: per shifted group (nW_g, N_g, N_g),
// concatenated.  ws and shifts are host arrays of n_group ints.  With drop,
// entries whose hash clears thresh are kept and scaled by inv_keep.  Needs
// D % 32 == 0 with D <= 96, windows of 2, 4 or 8 dividing H and W, and a
// head dim of GCH = 16; the Python wrapper checks these.  Returns
// cudaGetLastError() after the last launch (or the first failing one).
extern "C" int window_attention_core_forward(const float* q, const float* k, const float* v, const float* bias,
                                             const float* mask, float* out, int B, int H, int W, int D,
                                             int n_group, const int* ws, const int* shifts, int gh, float scale,
                                             uint32_t seed, uint32_t thresh, float inv_keep, int drop,
                                             void* stream) {
  if (D / n_group != gh * GCH) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_attn_groups_any(q, k, v, D, bias, mask, out, B, H, W, D, n_group, ws, shifts, gh,
                                                 scale, 0, seed, thresh, inv_keep, drop,
                                                 static_cast<cudaStream_t>(stream)));
}

// The floats of the backward's dbias_part scratch.
extern "C" size_t window_attention_core_backward_scratch(int B, int H, int W, int n_group, const int* ws, int gh) {
  return attn_bwd_part_floats(B, H, W, n_group, ws, gh);
}

// The backward, from the forward's inputs and dout (B, L, D).  Outputs: dq,
// dk, dv (B, L, D); dbias laid out as bias.  Scratch: dbias_part
// (window_attention_core_backward_scratch floats).
extern "C" int window_attention_core_backward(const float* q, const float* k, const float* v, const float* bias,
                                              const float* mask, const float* dout, float* dbias_part, float* dq,
                                              float* dk, float* dv, float* dbias, int B, int H, int W, int D,
                                              int n_group, const int* ws, const int* shifts, int gh, float scale,
                                              uint32_t seed, uint32_t thresh, float inv_keep, int drop,
                                              void* stream) {
  if (D / n_group != gh * GCH) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_attn_bwd_groups_any(q, k, v, D, dout, bias, mask, dq, dk, dv, dbias_part, dbias, B,
                                                     H, W, D, n_group, ws, shifts, gh, scale, seed, thresh, inv_keep,
                                                     drop, static_cast<cudaStream_t>(stream)));
}
