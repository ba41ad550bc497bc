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
//
// bf16 io (the bf16 AMP step under DPMN_TPU_FUSE_QKV=0; the JAX kernel on
// bf16 inputs writes its outputs in q3.dtype, :143 and :260-263): q, k, v,
// out, dout, dq, dk and dv bf16; the bias (as dpmn_tpu/models/pgrm.py:488-490
// passes it), the mask and dbias float32.  The JAX kernel's rounding points
// (_core_fwd, _core_bwd, _attn_head_bwd, :82-265): q times the scale rounded
// to bf16, the product rounded to bf16; the scores, the softmax and the
// dropout in float32; P rounded to bf16 once before P v; out rounded once;
// in the backward P*M and dS rounded before their products, dbias summed
// from the unrounded dS, dq (with the float32 scale), dk and dv rounded at
// the store.  The forward is window_common.cuh window_attn_fwd_train_kernel
// (the training cores' bf16 attention, one launch: steps of 64 tokens of one
// group staged a step ahead, the 4x4 and 8x8 windows on bf16 m16n8k16, the
// 2x2 windows on the CUDA cores from shared memory); the backward is K3's bf16 attention
// backward (window_train_common.cuh: window_attn_bwd_tc_bf16_kernel for the
// 4x4 and 8x8 windows with 1-2 heads a group, products on bf16 m16n8k16, q
// scaled as it is staged; the 2x2 and thread-per-row kernels on bf16 rows)
// with OT = bf16: dq, dk and dv rounded once as the kernel stores them, so
// no pass widens an input or narrows an output, and a call launches an
// attention backward and a dbias sum per group (6 at three groups).  k and
// v are rows of stride kvs (the halves of one kv projection: kvs = 2D), so
// the caller copies nothing; dk and dv are written at the same row stride
// (the wrapper hands out the halves of one (B, L, 2D) buffer, or two
// buffers where kvs < 2D).  Bound at B = 64, flagship geometry: forward
// 50.3 MB of bf16 rows and 0.70 GFLOP = 15 us at 3.35 TB/s, backward 88.1 MB
// = 26 us; both bound by bytes.

#include "window_train_common.cuh"

using bf16 = __nv_bfloat16;

// Shapes: q, k, v, out (B, L, D) with L = H*W.  bias: per group
// (gh, N_g, N_g), concatenated; mask: per shifted group (nW_g, N_g, N_g),
// concatenated.  ws and shifts are host arrays of n_group ints.  With drop,
// entries whose hash clears thresh are kept and scaled by inv_keep.  Needs
// D a multiple of 16 up to 96, windows of 2, 4 or 8 dividing H and W, and a
// head dim of 8, 16 or 32; the Python wrapper checks these.  Returns
// cudaGetLastError() after the last launch (or the first failing one).
extern "C" int window_attention_core_forward(const float* q, const float* k, const float* v, const float* bias,
                                             const float* mask, float* out, int B, int H, int W, int D,
                                             int n_group, const int* ws, const int* shifts, int gh, float scale,
                                             uint32_t seed, uint32_t thresh, float inv_keep, int drop,
                                             void* stream) {
  if (!head_dim(D, n_group, gh)) return static_cast<int>(cudaErrorInvalidValue);
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
  if (!head_dim(D, n_group, gh)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_attn_bwd_groups_any(q, k, v, D, dout, bias, mask, dq, dk, dv, dbias_part, dbias, B,
                                                     H, W, D, n_group, ws, shifts, gh, scale, seed, thresh, inv_keep,
                                                     drop, static_cast<cudaStream_t>(stream)));
}

// The bf16 forward (window_attn_fwd_train_kernel, one launch): the
// arguments of window_attention_core_forward with q, k, v and out bf16, the
// tables as per-group pointers (biases[g] (gh, N_g, N_g), masks[g] (nW_g,
// N_g, N_g), float32; masks[g] read only where shifts[g] > 0), and kvs the
// row stride of k and v (q and out rows have stride D).
extern "C" int window_attention_core_forward_bf16(const bf16* q, const bf16* k, const bf16* v,
                                                  const float* const* biases, const float* const* masks, bf16* out,
                                                  int kvs, int B, int H, int W, int D, int n_group, const int* ws,
                                                  const int* shifts, int gh, float scale, uint32_t seed,
                                                  uint32_t thresh, float inv_keep, int drop, void* stream) {
  if (!head_dim(D, n_group, gh)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_train_attn(q, k, v, kvs, biases, masks, out, B, H, W, D, n_group, ws, shifts, gh,
                                            scale, seed, thresh, inv_keep, drop, static_cast<cudaStream_t>(stream)));
}

// The kernels this library has launched since it was loaded
// (kernel_launches, window_common.cuh).
extern "C" unsigned long long window_attention_core_kernel_launches() { return kernel_launches; }

// The bf16 backward: the forward's inputs, dout (B, L, D) bf16 and
// dbias_part (window_attention_core_backward_scratch floats); outputs dq
// (B, L, D) bf16, dk and dv bf16 rows of stride kvs (as k and v), dbias
// float32 laid out as bias.
extern "C" int window_attention_core_backward_bf16(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                                                   const float* mask, const bf16* dout, float* dbias_part, bf16* dq,
                                                   bf16* dk, bf16* dv, float* dbias, int kvs, int B, int H, int W,
                                                   int D, int n_group, const int* ws, const int* shifts, int gh,
                                                   float scale, uint32_t seed, uint32_t thresh, float inv_keep,
                                                   int drop, void* stream) {
  if (!head_dim(D, n_group, gh)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_attn_bwd_groups_any(q, k, v, kvs, dout, bias, mask, dq, dk, dv, dbias_part, dbias,
                                                     B, H, W, D, n_group, ws, shifts, gh, scale, seed, thresh,
                                                     inv_keep, drop, static_cast<cudaStream_t>(stream)));
}
