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
// launch per group, (c) skconv_proj (feats and per-tile partial sums of the
// GAP), skconv_gate (the fixed-order sum of the partials: no float atomics,
// so reruns agree bit for bit) and skconv_out.  (a) and (b) live in
// window_common.cuh, which the training kernel shares.
//
// What bounds it on an H100, at B = 64 and the flagship geometry (L = 1024,
// D = 96, windows 2/4/8, 2 heads of 16 channels per group), counting each
// input read once and each output written once: 75.5 MB (xq and xkv read,
// the output written) = 22.5 us at 3.35 TB/s; and 92.8 MFLOP per image
// (projections 56.6, attention 11.0, SKConv 25.2; elementwise work not
// counted), 5.94 GFLOP per call = 89 us at the 67 TFLOP/s float32 rate of the
// CUDA cores.  So it is bound by operations.  Measured on an H100 SXM at
// 700 W: 1.04-1.11 ms per call, 12x the bound (PERF.md).  This first design
// is far from either bound: the
// projections run on CUDA cores from weights staged in shared memory (a
// register tile of 8 tokens x 9 outputs per thread), and q, kv, the attention
// output and feats make a round trip through device memory between the
// kernels.  wgmma for the projections, TMA, and keeping q/kv on chip are
// later work.

#include "window_common.cuh"

namespace {

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

// (c1) feats = attn Wp^T + bp, and per-tile sums of gelu(feats).  Shared:
// wt [D][D + 1], x [TOK][D], red [8][D].
__global__ void skconv_proj_kernel(const float* __restrict__ attn, const float* __restrict__ pw,
                                   const float* __restrict__ pb, float* __restrict__ feats,
                                   float* __restrict__ partial, int D) {
  extern __shared__ float sm[];
  float* wt = sm;  // [D][D + 1]
  float* x = wt + D * (D + 1);
  float* red = x + TOK * D;
  for (int idx = threadIdx.x; idx < D * D; idx += blockDim.x) {
    const int o = idx / D, i = idx % D;
    wt[i * (D + 1) + o] = pw[idx];
  }
  const int64_t t0 = (int64_t)blockIdx.x * TOK;
  for (int idx = threadIdx.x; idx < TOK * D; idx += blockDim.x) x[idx] = attn[t0 * D + idx];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nj = (D + 31) / 32;
  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
  for (int i = 0; i < D; ++i) {
    float w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = lane + 32 * j;
      w[j] = (j < nj && o < D) ? wt[i * (D + 1) + o] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float v = x[(warp * 8 + a) * D + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(v, w[j], acc[a][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = lane + 32 * j;
    if (j >= nj || o >= D) continue;
    float gs = 0.f;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float f = acc[a][j] + pb[o];
      feats[(t0 + warp * 8 + a) * D + o] = f;
      gs += gelu_erf(f);
    }
    red[warp * D + o] = gs;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < D; o += blockDim.x) {
    float s = 0.f;
    for (int w8 = 0; w8 < 8; ++w8) s += red[w8 * D + o];
    partial[(int64_t)blockIdx.x * D + o] = s;
  }
}

// (c2) one block per image: GAP from the partial sums, fc1 -> GELU -> fc2,
// softmax over the groups.  gate: (B, n_group, ch).
__global__ void skconv_gate_kernel(const float* __restrict__ partial, const float* __restrict__ f1w,
                                   const float* __restrict__ f1b, const float* __restrict__ f2w,
                                   const float* __restrict__ f2b, float* __restrict__ gate,
                                   int L, int D, int dz, int n_group, int ch) {
  extern __shared__ float sm[];
  float* s = sm;
  float* z = s + D;
  float* a = z + dz;
  const int b = blockIdx.x, ntile = L / TOK;
  for (int o = threadIdx.x; o < D; o += blockDim.x) {
    float acc = 0.f;
    for (int tl = 0; tl < ntile; ++tl) acc += partial[((int64_t)b * ntile + tl) * D + o];
    s[o] = acc / L;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < dz; k += blockDim.x) {
    float acc = f1b[k];
    for (int o = 0; o < D; ++o) acc = fmaf(s[o], f1w[k * D + o], acc);
    z[k] = gelu_erf(acc);
  }
  __syncthreads();
  for (int m = threadIdx.x; m < n_group * ch; m += blockDim.x) {
    float acc = f2b[m];
    for (int k = 0; k < dz; ++k) acc = fmaf(z[k], f2w[m * dz + k], acc);
    a[m] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < ch; c += blockDim.x) {
    float mx = -INFINITY;
    for (int g = 0; g < n_group; ++g) mx = fmaxf(mx, a[g * ch + c]);
    float den = 0.f;
    for (int g = 0; g < n_group; ++g) den += expf(a[g * ch + c] - mx);
    for (int g = 0; g < n_group; ++g) gate[((int64_t)b * n_group + g) * ch + c] = expf(a[g * ch + c] - mx) / den;
  }
}

// (c3) out = [xkv +] feats + (sum_g gate_g * attn_g) Wph^T + bph.  Shared:
// wt [ch][D + 1], fv [TOK][ch].
__global__ void skconv_out_kernel(const float* __restrict__ attn, const float* __restrict__ feats,
                                  const float* __restrict__ gate, const float* __restrict__ phw,
                                  const float* __restrict__ phb, const float* __restrict__ xkv,
                                  float* __restrict__ out, int L, int D, int n_group, int ch,
                                  int residual) {
  extern __shared__ float sm[];
  float* wt = sm;  // [ch][D + 1]
  float* fv = wt + ch * (D + 1);
  for (int idx = threadIdx.x; idx < D * ch; idx += blockDim.x) {
    const int o = idx / ch, c = idx % ch;
    wt[c * (D + 1) + o] = phw[idx];
  }
  const int64_t t0 = (int64_t)blockIdx.x * TOK;
  const int b = (int)(t0 / L);
  for (int idx = threadIdx.x; idx < TOK * ch; idx += blockDim.x) {
    const int lt = idx / ch, c = idx % ch;
    float acc = 0.f;
    for (int g = 0; g < n_group; ++g)
      acc = fmaf(attn[(t0 + lt) * D + g * ch + c], gate[((int64_t)b * n_group + g) * ch + c], acc);
    fv[idx] = acc;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nj = (D + 31) / 32;
  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
  for (int c = 0; c < ch; ++c) {
    float w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = lane + 32 * j;
      w[j] = (j < nj && o < D) ? wt[c * (D + 1) + o] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float v = fv[(warp * 8 + a) * ch + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(v, w[j], acc[a][j]);
    }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int64_t t = t0 + warp * 8 + a;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = lane + 32 * j;
      if (j >= nj || o >= D) continue;
      const float sk = feats[t * D + o] + (acc[a][j] + phb[o]);
      out[t * D + o] = residual ? xkv[t * D + o] + sk : sk;
    }
  }
}

}  // namespace

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
  err = launch_attn_groups<false>(qbuf, kvbuf, bias, mask, attn, B, H, W, D, n_group, ws, shifts, gh, scale,
                                  corrected, 0u, 0u, 1.f, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_c1 = (size_t)(D * (D + 1) + TOK * D + 8 * D) * sizeof(float);
  cudaFuncSetAttribute(skconv_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c1);
  skconv_proj_kernel<<<ntok / TOK, THREADS, smem_c1, st>>>(attn, proj_w, proj_b, feats, partial, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const size_t smem_c2 = (size_t)(D + dz + n_group * ch) * sizeof(float);
  skconv_gate_kernel<<<B, 128, smem_c2, st>>>(partial, fc1_w, fc1_b, fc2_w, fc2_b, gate, L, D, dz, n_group, ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const size_t smem_c3 = (size_t)(ch * (D + 1) + TOK * ch) * sizeof(float);
  cudaFuncSetAttribute(skconv_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c3);
  skconv_out_kernel<<<ntok / TOK, THREADS, smem_c3, st>>>(attn, feats, gate, ph_w, ph_b, xkv, out, L, D, n_group,
                                                          ch, do_ln);
  return static_cast<int>(cudaGetLastError());
}
