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
// the store.  The forward is window_attn_fwd_kernel<DROP, bf16, float> on
// the bf16 rows, as K3's bf16 form; the backward widens q (scaled), k, v and
// dout to float32 once (bf16_rows), runs the float32 attention backward with
// its BF16 rounding (window_train_common.cuh) and narrows dq, dk, dv.  k and
// v are rows of stride kvs (the halves of one kv projection: kvs = 2D), so
// the caller copies nothing.  Bound at B = 64, flagship geometry: forward
// 50.3 MB of bf16 rows and 0.70 GFLOP = 15 us at 3.35 TB/s, backward 88.1 MB
// = 26 us; both bound by bytes.

#include "window_train_common.cuh"

using bf16 = __nv_bfloat16;

namespace {

// The float32 scratch of the bf16 backward, carved from one buffer, every
// piece a multiple of 4 floats (16-byte aligned): q (scaled), [k | v] and
// dout widened; dq, [dk | dv]; the dbias partials.
struct CoreBf16Work {
  float *qf, *kvf, *doutf, *dq, *dkv, *dbias_part;
  size_t floats;

  CoreBf16Work(float* base, int B, int H, int W, int D, int n_group, const int* ws, int gh) {
    const size_t nd = (size_t)B * H * W * D;
    size_t off = 0;
    auto take = [&](size_t n) {
      float* p = base ? base + off : nullptr;
      off += (n + 3) / 4 * 4;
      return p;
    };
    qf = take(nd), kvf = take(2 * nd), doutf = take(nd), dq = take(nd), dkv = take(2 * nd);
    dbias_part = take(attn_bwd_part_floats(B, H, W, n_group, ws, gh));
    floats = off;
  }
};

}  // namespace

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

// The bf16 forward: the arguments of window_attention_core_forward with q,
// k, v and out bf16 (bias, mask float32), and kvs the row stride of k and v
// (q and out rows have stride D).
extern "C" int window_attention_core_forward_bf16(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                                                  const float* mask, bf16* out, int kvs, int B, int H, int W, int D,
                                                  int n_group, const int* ws, const int* shifts, int gh, float scale,
                                                  uint32_t seed, uint32_t thresh, float inv_keep, int drop,
                                                  void* stream) {
  if (!head_dim(D, n_group, gh)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_attn_groups_any(q, k, v, kvs, bias, mask, out, B, H, W, D, n_group, ws, shifts, gh,
                                                 scale, 0, seed, thresh, inv_keep, drop,
                                                 static_cast<cudaStream_t>(stream)));
}

// The floats of the bf16 backward's work buffer.
extern "C" size_t window_attention_core_backward_bf16_work(int B, int H, int W, int D, int n_group, const int* ws,
                                                           int gh) {
  return CoreBf16Work(nullptr, B, H, W, D, n_group, ws, gh).floats;
}

// The bf16 backward: the forward's inputs, dout (B, L, D) bf16 and `work`
// (window_attention_core_backward_bf16_work floats); outputs dq, dk, dv
// (B, L, D) bf16 and dbias float32 laid out as bias.
extern "C" int window_attention_core_backward_bf16(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                                                   const float* mask, const bf16* dout, float* work, bf16* dq,
                                                   bf16* dk, bf16* dv, float* dbias, int kvs, int B, int H, int W,
                                                   int D, int n_group, const int* ws, const int* shifts, int gh,
                                                   float scale, uint32_t seed, uint32_t thresh, float inv_keep,
                                                   int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!head_dim(D, n_group, gh)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntok = (int64_t)B * H * W;
  const CoreBf16Work r(work, B, H, W, D, n_group, ws, gh);
  cudaError_t err;
  if ((err = bf16_rows(q, D, r.qf, D, ntok, D, bf16_scale(scale), st)) != cudaSuccess ||
      (err = bf16_rows(k, kvs, r.kvf, 2 * D, ntok, D, 1.f, st)) != cudaSuccess ||
      (err = bf16_rows(v, kvs, r.kvf + D, 2 * D, ntok, D, 1.f, st)) != cudaSuccess ||
      (err = convert(dout, r.doutf, ntok * D, st)) != cudaSuccess)
    return static_cast<int>(err);
  err = launch_attn_bwd_groups_any<true>(r.qf, r.kvf, r.kvf + D, 2 * D, r.doutf, bias, mask, r.dq, r.dkv, r.dkv + D,
                                         r.dbias_part, dbias, B, H, W, D, n_group, ws, shifts, gh, scale, seed, thresh,
                                         inv_keep, drop, st);
  if (err != cudaSuccess || (err = convert(r.dq, dq, ntok * D, st)) != cudaSuccess ||
      (err = bf16_rows(r.dkv, 2 * D, dk, D, ntok, D, 1.f, st)) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(bf16_rows(r.dkv + D, 2 * D, dv, D, ntok, D, 1.f, st));
}
