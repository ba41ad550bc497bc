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
// window_attn_fwd_kernel), templated on the io type: one launch a call, its
// work list the 8x8 and 4x4 windows' steps on the tensor cores and then the
// 2x2 windows on the CUDA cores.  bf16 rows are staged as they are and read
// by ldmatrix into bf16 m16n8k16 products with float32 accumulation
// (attn_tile.cuh): S in one product an 8-key tile, P v in two (P split into
// bf16 hi + lo); float32 takes three TF32 passes for each.  The per-group
// tables arrive as arrays of pointers, so the caller concatenates nothing.
//
// What bounds it on an H100 at B = 64 and the flagship geometry (L = 1024,
// dim = 96, windows 2/4/8, 2 heads of 16 per group), each input read once
// and each output written once: in float32 100.7 MB (q, k, v, out) plus
// 0.35 MB of biases and masks = 30 us at 3.35 TB/s, and 0.70 GFLOP = 10 us at
// 67 TFLOP/s; in bf16 half the bytes.  Both are bound by bytes.  Its times
// stand in PERF.md.

#include "window_common.cuh"

template <typename T>
static int grouped_forward(const void* q, const void* k, const void* v, const void* const* biases,
                           const float* const* masks, void* out, int B, int H, int W, int D, int n_group,
                           const int* ws, const int* shifts, int gh, float scale, void* stream) {
  if (n_group < 1 || n_group > MAX_ATTN_GROUPS || D / n_group != gh * GCH)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* bias[MAX_ATTN_GROUPS];
  for (int g = 0; g < n_group; ++g) bias[g] = static_cast<const T*>(biases[g]);
  return static_cast<int>(launch_attn<false, T>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                static_cast<const T*>(v), D, bias, masks, static_cast<T*>(out), B, H,
                                                W, D, n_group, ws, shifts, gh, scale, 0, 0u, 0u, 1.0f,
                                                static_cast<cudaStream_t>(stream)));
}

// Shapes: q, k, v, out (B, H, W, D).  biases: a host array of n_group
// device pointers, group g's (gh, N_g, N_g) table in the io type; masks: a
// host array of n_group device pointers, group g's (nW_g, N_g, N_g) float32
// table where shifts[g] > 0 (else not read).  ws and shifts are host arrays
// of n_group ints.  bf16 != 0 selects bf16 io (the pointers then hold
// __nv_bfloat16).  Needs windows of 2, 4 or 8 dividing H and W, at most
// MAX_ATTN_GROUPS groups and a head dim (D / n_group / gh) of GCH = 16; the
// Python wrapper checks these.  Returns cudaGetLastError() after the launch.
extern "C" int grouped_window_attention_forward(const void* q, const void* k, const void* v,
                                                const void* const* biases, const float* const* masks, void* out,
                                                int B, int H, int W, int D, int n_group, const int* ws,
                                                const int* shifts, int gh, float scale, int bf16, void* stream) {
  return bf16 ? grouped_forward<__nv_bfloat16>(q, k, v, biases, masks, out, B, H, W, D, n_group, ws, shifts, gh,
                                               scale, stream)
              : grouped_forward<float>(q, k, v, biases, masks, out, B, H, W, D, n_group, ws, shifts, gh, scale,
                                       stream);
}
