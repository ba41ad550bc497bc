// The eval attention of a PGRM window-attention block on projected q, k, v,
// in float32 or bf16, for sm_90a.
//
// Replaces the TPU kernel dpmn_tpu/ops/pallas_window.py::
// fused_grouped_window_attention (pallas_call at :135).  For q, k, v of shape
// (B, H, W, dim), per channel group g (window ws, shift sh, N = ws*ws) and
// head: the -sh roll, the window partition, softmax(scale q k^T + rel_bias
// [+ shift mask]) v, written in the faithful raw layout (row window*N + i of
// each group slice, the reference's model/pgrm.py:263 quirk).  No LN, no
// projections, no SKConv, no dropout.  q, k, v, the biases and the output are
// in the io type (float32 or bf16); the shift masks are float32; the scores,
// the softmax and the product with v run in float32, and the result is
// rounded once to the io type, as the TPU kernel does.
//
// The kernel is K4's forward at keep 1 (window_common.cuh
// window_attn_fwd_kernel, one launch per group), templated on the io type:
// bf16 rows are staged as they are and widened to float32 as the tensor
// cores' fragments are read (bf16 values are exact in TF32, so their
// products take one TF32 pass where float32 takes three).
//
// What bounds it on an H100 at B = 64 and the flagship geometry (L = 1024,
// dim = 96, windows 2/4/8, 2 heads of 16 per group), each input read once
// and each output written once: in float32 100.7 MB (q, k, v, out) plus
// 0.35 MB of biases and masks = 30 us at 3.35 TB/s, and 0.70 GFLOP = 10 us at
// 67 TFLOP/s; in bf16 half the bytes.  Both are bound by bytes.  Its times
// stand in PERF.md.

#include "window_common.cuh"

template <typename T>
static int grouped_forward(const T* q, const T* k, const T* v, const T* bias, const float* mask, T* out, int B,
                           int H, int W, int D, int n_group, const int* ws, const int* shifts, int gh, float scale,
                           void* stream) {
  if (D / n_group != gh * GCH) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_attn_groups<false, T>(q, k, v, D, bias, mask, out, B, H, W, D, n_group, ws, shifts,
                                                       gh, scale, 0, 0u, 0u, 1.0f,
                                                       static_cast<cudaStream_t>(stream)));
}

// Shapes: q, k, v, out (B, H, W, D).  bias: per group (gh, N_g, N_g),
// concatenated, in the io type; mask: per shifted group (nW_g, N_g, N_g),
// concatenated, float32.  ws and shifts are host arrays of n_group ints.
// bf16 != 0 selects bf16 io (the pointers then hold __nv_bfloat16).  Needs
// windows of 2, 4 or 8 dividing H and W and a head dim (D / n_group / gh) of
// GCH = 16; the Python wrapper checks these.  Returns cudaGetLastError()
// after the last launch (or the first failing one).
extern "C" int grouped_window_attention_forward(const void* q, const void* k, const void* v, const void* bias,
                                                const float* mask, void* out, int B, int H, int W, int D,
                                                int n_group, const int* ws, const int* shifts, int gh, float scale,
                                                int bf16, void* stream) {
  if (bf16) {
    using bf = __nv_bfloat16;
    return grouped_forward(static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
                           static_cast<const bf*>(bias), mask, static_cast<bf*>(out), B, H, W, D, n_group, ws,
                           shifts, gh, scale, stream);
  }
  return grouped_forward(static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                         static_cast<const float*>(bias), mask, static_cast<float*>(out), B, H, W, D, n_group, ws,
                         shifts, gh, scale, stream);
}
