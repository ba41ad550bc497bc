// The training forward and backward of a whole PGRM window attention with
// SKConv fused in, for sm_90a.
//
// Replaces the TPU kernel pair dpmn_tpu/ops/pallas_window_train.py::
// window_attention_full_core: the forward _full_fwd (pallas_call at :766)
// and the recomputing backward _full_bwd_impl (pallas_call at :952), the
// path the JAX package takes with DPMN_TPU_FUSE_SKCONV=1 on the faithful
// layout.  For pre-norm tokens xq, xkv of shape (B, L = H*W, D):
//   forward  K3's function (LN of both streams, the q / kv projections, the
//            grouped window attention with dropout, the faithful raw layout)
//            into tokens t, then SKConv without the residual: feats = t Wp^T
//            + bp; s = the mean over the L tokens of gelu(feats); u = fc1 s;
//            z = gelu(u); a = fc2 z; w = softmax over the groups of a;
//            out = feats + (sum_j t_j * w_j) Wph^T + bph (exact erf GELU);
//   backward from the primal inputs and dout only: recompute LN, the
//            projections, the attention and SKConv's forward intermediates
//            once; SKConv's backward — dfv = dout Wph, dw_j = sum over the
//            image's tokens of dfv * t_j, the softmax, fc2, GELU and fc1
//            backward per image to dgap = ds / L, dfeats = dout + dgap *
//            gelu'(feats), dt = dfeats Wp + dfv * w_j — and the weight
//            gradients of Wp, Wph (over tokens) and fc1, fc2 (over images);
//            then K3's attention backward from dt and K3's projection and LN
//            backward.
// The TPU kernel recomputes the attention twice and accumulates every
// weight gradient in resident VMEM over its sequential grid; blocks on the
// card run in no order, so every cross-block sum here goes through
// per-block partials and a fixed-order second pass (sum_rows_kernel, or one
// thread per output summing over the images): no float atomics, so reruns
// agree bit for bit.
//
// What bounds it on an H100 at B = 64 and the flagship geometry (L = 1024,
// D = 96, windows 2/4/8, 2 heads of 16 per group, dz = 16), each input read
// once and each output written once: forward 75.5 MB (xq, xkv, out) and
// 5.94 GFLOP (K3's 4.33, SKConv's 1.61) = 89 us at 67 TFLOP/s float32;
// backward 126 MB (xq, xkv, dout, dxq, dxkv) and 17.81 GFLOP (K3's
// backward 12.63, the tokens' P v 0.35, the recomputed SKConv forward 1.61,
// its backward 3.22) = 266 us.  Both are bound by operations.  The LN +
// projections, SKConv's two products, the projection backward, the weight
// gradients and the attention backward of the 4x4 and 8x8 windows are K3's
// tensor-core kernels (window_common.cuh, window_train_common.cuh); SKConv's
// backward kernels below run on CUDA cores, and q, kv, the tokens, feats and
// their gradients round-trip through device memory.

#include "window_train_common.cuh"

namespace {

__device__ __forceinline__ float gelu_erf_grad(float x) {
  return 0.5f * (1.0f + erff(x * 0.70710678118654752440f)) + x * expf(-0.5f * x * x) * 0.3989422804014327f;
}

// SKConv backward (1) per 64-token tile: dfv = dout Wph (Wph (D, ch) torch
// layout), fv = sum_j t_j * w_j (the forward's proj_head input, for dWph),
// and this tile's sums of dfv * t_j (dwpart [tile][j*ch + c]).  Shared:
// wph [D][ch], dos [TOK][D], dfs [TOK][ch].
__global__ void skconv_bwd_v_kernel(const float* __restrict__ dout, const float* __restrict__ tok,
                                    const float* __restrict__ gate, const float* __restrict__ phw,
                                    float* __restrict__ dfv, float* __restrict__ fv, float* __restrict__ dwpart,
                                    int L, int D, int n_group, int ch) {
  extern __shared__ float sm[];
  float* wph = sm;
  float* dos = wph + D * ch;
  float* dfs = dos + TOK * D;
  const int64_t t0 = (int64_t)blockIdx.x * TOK;
  const int64_t b = t0 / L;
  for (int idx = threadIdx.x; idx < D * ch; idx += blockDim.x) wph[idx] = phw[idx];
  for (int idx = threadIdx.x; idx < TOK * D; idx += blockDim.x) dos[idx] = dout[t0 * D + idx];
  __syncthreads();
  for (int idx = threadIdx.x; idx < TOK * ch; idx += blockDim.x) {
    const int lt = idx / ch, c = idx % ch;
    float acc = 0.f;
    for (int o = 0; o < D; ++o) acc = fmaf(dos[lt * D + o], wph[o * ch + c], acc);
    dfs[idx] = acc;
    dfv[(t0 + lt) * ch + c] = acc;
    float f = 0.f;
    for (int g = 0; g < n_group; ++g) f = fmaf(tok[(t0 + lt) * D + g * ch + c], gate[(b * n_group + g) * ch + c], f);
    fv[(t0 + lt) * ch + c] = f;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < D; m += blockDim.x) {
    const int c = m % ch;
    float acc = 0.f;
    for (int lt = 0; lt < TOK; ++lt) acc = fmaf(dfs[lt * ch + c], tok[(t0 + lt) * D + m], acc);
    dwpart[(int64_t)blockIdx.x * D + m] = acc;
  }
}

// SKConv backward (2), one block per image: the gate recomputed as the
// forward computes it (s, u, z, w), dw = the fixed-order sum of the image's
// dwpart rows, then da = w * (dw - sum_j dw_j w_j) (the softmax over the
// groups), dz = da fc2_w, du = dz * gelu'(u), ds = du fc1_w.  Writes per
// image da (B, D), z and du (B, dz), s (B, D) for the fc weight gradients,
// and dgap = ds / L (B, D).  Shared: s [D], u, z [dz], w [D], dw [D], da
// [D], du [dz].
__global__ void skconv_gate_bwd_kernel(const float* __restrict__ partial, const float* __restrict__ dwpart,
                                       const float* __restrict__ f1w, const float* __restrict__ f1b,
                                       const float* __restrict__ f2w, const float* __restrict__ f2b,
                                       float* __restrict__ da_out, float* __restrict__ z_out,
                                       float* __restrict__ du_out, float* __restrict__ s_out,
                                       float* __restrict__ dgap, int L, int D, int dz, int n_group, int ch) {
  extern __shared__ float sm[];
  float* s = sm;
  float* u = s + D;
  float* z = u + dz;
  float* w = z + dz;
  float* dw = w + D;
  float* da = dw + D;
  float* du = da + D;
  const int b = blockIdx.x, ntile = L / TOK;
  skconv_gate_block(partial, f1w, f1b, f2w, f2b, s, u, z, w, b, L, D, dz, n_group, ch);
  for (int m = threadIdx.x; m < D; m += blockDim.x) {
    float acc = 0.f;
    for (int tl = 0; tl < ntile; ++tl) acc += dwpart[((int64_t)b * ntile + tl) * D + m];
    dw[m] = acc;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < D; m += blockDim.x) {
    const int c = m % ch;
    float wsum = 0.f;
    for (int g = 0; g < n_group; ++g) wsum = fmaf(dw[g * ch + c], w[g * ch + c], wsum);
    da[m] = w[m] * (dw[m] - wsum);
    da_out[(int64_t)b * D + m] = da[m];
    s_out[(int64_t)b * D + m] = s[m];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < dz; k += blockDim.x) {
    float acc = 0.f;
    for (int m = 0; m < D; ++m) acc = fmaf(da[m], f2w[m * dz + k], acc);
    du[k] = acc * gelu_erf_grad(u[k]);
    du_out[(int64_t)b * dz + k] = du[k];
    z_out[(int64_t)b * dz + k] = z[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < dz; ++k) acc = fmaf(du[k], f1w[k * D + i], acc);
    dgap[(int64_t)b * D + i] = acc / L;
  }
}

// SKConv backward (3): the fc weight gradients, one thread per output
// summing over the B images in order.  g = [dfc1_w (dz, D) | dfc1_b (dz) |
// dfc2_w (D, dz) | dfc2_b (D)], torch layouts.
__global__ void skconv_fc_wgrad_kernel(const float* __restrict__ da, const float* __restrict__ z,
                                       const float* __restrict__ du, const float* __restrict__ s,
                                       float* __restrict__ g, int B, int D, int dz) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int n1w = dz * D, n1 = n1w + dz, n2w = n1 + D * dz, n2 = n2w + D;
  if (e >= n2) return;
  float acc = 0.f;
  if (e < n1w) {
    const int k = e / D, i = e % D;
    for (int b = 0; b < B; ++b) acc = fmaf(du[b * dz + k], s[b * D + i], acc);
  } else if (e < n1) {
    for (int b = 0; b < B; ++b) acc += du[b * dz + (e - n1w)];
  } else if (e < n2w) {
    const int m = (e - n1) / dz, k = (e - n1) % dz;
    for (int b = 0; b < B; ++b) acc = fmaf(da[b * D + m], z[b * dz + k], acc);
  } else {
    for (int b = 0; b < B; ++b) acc += da[b * D + (e - n2w)];
  }
  g[e] = acc;
}

// SKConv backward (4) per 64-token tile: dfeats = dout + dgap * gelu'(feats)
// and the tokens' gradient dt = dfeats Wp + dfv * w_j (Wp (D, D) torch
// layout; column i of group j = i / ch).  Shared: wp [D][D], dfs [TOK][D].
__global__ void skconv_bwd_tok_kernel(const float* __restrict__ dout, const float* __restrict__ feats,
                                      const float* __restrict__ dgap, const float* __restrict__ dfv,
                                      const float* __restrict__ gate, const float* __restrict__ pw,
                                      float* __restrict__ dfeats, float* __restrict__ dtok, int L, int D,
                                      int n_group, int ch) {
  extern __shared__ float sm[];
  float* wp = sm;
  float* dfs = wp + D * D;
  const int64_t t0 = (int64_t)blockIdx.x * TOK;
  const int64_t b = t0 / L;
  for (int idx = threadIdx.x; idx < D * D; idx += blockDim.x) wp[idx] = pw[idx];
  for (int idx = threadIdx.x; idx < TOK * D; idx += blockDim.x) {
    const float d = fmaf(dgap[b * D + idx % D], gelu_erf_grad(feats[t0 * D + idx]), dout[t0 * D + idx]);
    dfs[idx] = d;
    dfeats[t0 * D + idx] = d;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TOK * D; idx += blockDim.x) {
    const int lt = idx / D, i = idx % D, c = i % ch;
    float acc = 0.f;
    for (int o = 0; o < D; ++o) acc = fmaf(dfs[lt * D + o], wp[o * D + i], acc);
    dtok[t0 * D + idx] = fmaf(dfv[(t0 + lt) * ch + c], gate[(b * n_group + i / ch) * ch + c], acc);
  }
}

// Scratch carved from one float buffer: with base == nullptr it only
// counts.  Every piece starts on a 128-byte boundary.
struct Carver {
  float* base;
  size_t n = 0;
  float* take(size_t k) {
    float* p = base ? base + n : nullptr;
    n += (k + 31) / 32 * 32;
    return p;
  }
};

// The forward's buffers, which the backward recomputes too.
struct FwdBufs {
  float *qbuf, *kvbuf, *tok, *feats, *partial, *gate;
};

FwdBufs carve_fwd(Carver& c, int B, int L, int D) {
  const size_t T = (size_t)B * L;
  FwdBufs f;
  f.qbuf = c.take(T * D);
  f.kvbuf = c.take(T * 2 * D);
  f.tok = c.take(T * D);
  f.feats = c.take(T * D);
  f.partial = c.take(T / TOK * D);
  f.gate = c.take((size_t)B * D);
  return f;
}

// The forward from pre-norm tokens to SKConv's output: LN + projections,
// the attention of every group into the tokens, SKConv (no residual).
cudaError_t full_forward(const float* xq, const float* xkv, const float* const* wt, const float* bias,
                         const float* mask, const FwdBufs& f, float* out, int B, int H, int W, int D, int n_group,
                         const int* ws, const int* shifts, int gh, int dz, float scale, uint32_t seed,
                         uint32_t thresh, float inv_keep, int drop, cudaStream_t st) {
  const int L = H * W;
  cudaError_t err = launch_ln_proj(xq, xkv, wt[0], wt[1], wt[2], wt[3], wt[4], wt[5], wt[6], wt[7], f.qbuf, f.kvbuf,
                                   B * L, D, 1, st);
  if (err != cudaSuccess) return err;
  err = launch_attn_groups_any(f.qbuf, f.kvbuf, f.kvbuf + D, 2 * D, bias, mask, f.tok, B, H, W, D, n_group, ws,
                               shifts, gh, scale, 0, seed, thresh, inv_keep, drop, st);
  if (err != cudaSuccess) return err;
  return launch_skconv(f.tok, wt[8], wt[9], wt[10], wt[11], wt[12], wt[13], wt[14], wt[15], nullptr, f.feats,
                       f.partial, f.gate, out, B, L, D, n_group, dz, 0, st);
}

}  // namespace

// Weights: wt is a host array of 16 device pointers, in this order: qs, qb,
// ks, kb (D each), q_w (D, D), q_b (D), kv_w (2D, D), kv_b (2D), proj_w
// (D, D), proj_b (D), fc1_w (dz, D), fc1_b (dz), fc2_w (D, dz), fc2_b (D),
// ph_w (D, ch), ph_b (D) — torch Linear layouts, ch = D / n_group.  Shapes:
// xq, xkv, out (B, L, D) with L = H*W.  bias: per group (gh, N_g, N_g),
// concatenated; mask: per shifted group (nW_g, N_g, N_g), concatenated.  ws
// and shifts are host arrays of n_group ints.  With drop, entries whose hash
// clears thresh are kept and scaled by inv_keep.  Needs L % 64 == 0, D % 32
// == 0 with D <= 96, windows of 2, 4 or 8 dividing H and W, and a head dim
// of GCH = 16; the Python wrapper checks these.  Each entry point returns
// cudaGetLastError() after its last launch (or the first failing one).

// The floats of the forward's scratch.
extern "C" size_t window_attention_full_forward_scratch(int B, int H, int W, int D) {
  Carver c{nullptr};
  carve_fwd(c, B, H * W, D);
  return c.n;
}

extern "C" int window_attention_full_forward(const float* xq, const float* xkv, const float* const* wt,
                                             const float* bias, const float* mask, float* scratch, float* out,
                                             int B, int H, int W, int D, int n_group, const int* ws,
                                             const int* shifts, int gh, int dz, float scale, uint32_t seed,
                                             uint32_t thresh, float inv_keep, int drop, void* stream) {
  if (D / n_group != gh * GCH) return static_cast<int>(cudaErrorInvalidValue);
  Carver c{scratch};
  const FwdBufs f = carve_fwd(c, B, H * W, D);
  return static_cast<int>(full_forward(xq, xkv, wt, bias, mask, f, out, B, H, W, D, n_group, ws, shifts, gh, dz,
                                       scale, seed, thresh, inv_keep, drop, static_cast<cudaStream_t>(stream)));
}

namespace {

struct BwdBufs {
  FwdBufs f;
  float *dfv, *fv, *dwpart, *da, *z, *du, *s, *dgap, *dfeats, *dtok, *dq, *dkv, *dbias_part;
  float *wpart_q, *wpart_kv, *lnpart_q, *lnpart_kv, *wpart_p, *wpart_ph;
};

BwdBufs carve_bwd(Carver& c, int B, int H, int W, int D, int n_group, const int* ws, int gh, int dz) {
  const int L = H * W, ch = D / n_group;
  const size_t T = (size_t)B * L, S = (T + TOKC - 1) / TOKC;
  BwdBufs r;
  r.f = carve_fwd(c, B, L, D);
  r.dfv = c.take(T * ch);
  r.fv = c.take(T * ch);
  r.dwpart = c.take(T / TOK * D);
  r.da = c.take((size_t)B * D);
  r.z = c.take((size_t)B * dz);
  r.du = c.take((size_t)B * dz);
  r.s = c.take((size_t)B * D);
  r.dgap = c.take((size_t)B * D);
  r.dfeats = c.take(T * D);
  r.dtok = c.take(T * D);
  r.dq = c.take(T * D);
  r.dkv = c.take(T * 2 * D);
  r.dbias_part = c.take(attn_bwd_part_floats(B, H, W, n_group, ws, gh));
  r.wpart_q = c.take(S * (D * D + D));
  r.wpart_kv = c.take(S * (2 * D * D + 2 * D));
  r.lnpart_q = c.take(T / TOK * 2 * D);
  r.lnpart_kv = c.take(T / TOK * 2 * D);
  r.wpart_p = c.take(S * (D * D + D));
  r.wpart_ph = c.take(S * (D * ch + D));
  return r;
}

}  // namespace

// The floats of the backward's scratch.
extern "C" size_t window_attention_full_backward_scratch(int B, int H, int W, int D, int n_group, const int* ws,
                                                         int gh, int dz) {
  Carver c{nullptr};
  carve_bwd(c, B, H, W, D, n_group, ws, gh, dz);
  return c.n;
}

// The backward, from the forward's inputs and dout (B, L, D).  Outputs:
// dxq, dxkv (B, L, D); gw, the gradients of the 16 weights of wt
// concatenated in wt's order; dbias laid out as bias.
extern "C" int window_attention_full_backward(const float* xq, const float* xkv, const float* const* wt,
                                              const float* bias, const float* mask, const float* dout,
                                              float* scratch, float* dxq, float* dxkv, float* gw, float* dbias,
                                              int B, int H, int W, int D, int n_group, const int* ws,
                                              const int* shifts, int gh, int dz, float scale, uint32_t seed,
                                              uint32_t thresh, float inv_keep, int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D / n_group != gh * GCH) return static_cast<int>(cudaErrorInvalidValue);
  const int L = H * W, ntok = B * L, ch = D / n_group;
  Carver c{scratch};
  const BwdBufs r = carve_bwd(c, B, H, W, D, n_group, ws, gh, dz);
  // offsets of the 16 gradients in gw
  float* g_ln_q = gw;
  float* g_ln_kv = g_ln_q + 2 * D;
  float* g_q = g_ln_kv + 2 * D;
  float* g_kv = g_q + D * D + D;
  float* g_p = g_kv + 2 * D * D + 2 * D;
  float* g_fc = g_p + D * D + D;
  float* g_ph = g_fc + 2 * dz * D + dz + D;

  // recompute the forward's intermediates (the output itself is not needed)
  cudaError_t err = full_forward(xq, xkv, wt, bias, mask, r.f, r.dfeats, B, H, W, D, n_group, ws, shifts, gh, dz,
                                 scale, seed, thresh, inv_keep, drop, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  // SKConv backward
  const size_t smem_v = (size_t)(D * ch + TOK * D + TOK * ch) * sizeof(float);
  cudaFuncSetAttribute(skconv_bwd_v_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_v);
  skconv_bwd_v_kernel<<<ntok / TOK, THREADS, smem_v, st>>>(dout, r.f.tok, r.f.gate, wt[14], r.dfv, r.fv, r.dwpart, L,
                                                           D, n_group, ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const size_t smem_g = (size_t)(4 * D + 3 * dz) * sizeof(float);
  skconv_gate_bwd_kernel<<<B, 128, smem_g, st>>>(r.f.partial, r.dwpart, wt[10], wt[11], wt[12], wt[13], r.da, r.z,
                                                 r.du, r.s, r.dgap, L, D, dz, n_group, ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int n_fc = 2 * dz * D + dz + D;
  skconv_fc_wgrad_kernel<<<(n_fc + 255) / 256, 256, 0, st>>>(r.da, r.z, r.du, r.s, g_fc, B, D, dz);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const size_t smem_t = (size_t)(D * D + TOK * D) * sizeof(float);
  cudaFuncSetAttribute(skconv_bwd_tok_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_t);
  skconv_bwd_tok_kernel<<<ntok / TOK, THREADS, smem_t, st>>>(dout, r.f.feats, r.dgap, r.dfv, r.f.gate, wt[8],
                                                             r.dfeats, r.dtok, L, D, n_group, ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = launch_wgrad(r.f.tok, nullptr, nullptr, r.dfeats, r.wpart_p, g_p, ntok, D, D, D, st)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = launch_wgrad(r.fv, nullptr, nullptr, dout, r.wpart_ph, g_ph, ntok, ch, D, D, st)) != cudaSuccess)
    return static_cast<int>(err);

  // attention backward from the tokens' gradient, then LN + projections
  err = launch_attn_bwd_groups_any(r.f.qbuf, r.f.kvbuf, r.f.kvbuf + D, 2 * D, r.dtok, bias, mask, r.dq, r.dkv,
                                   r.dkv + D, r.dbias_part, dbias, B, H, W, D, n_group, ws, shifts, gh, scale, seed,
                                   thresh, inv_keep, drop, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ln_proj_bwd(xq, xkv, wt[0], wt[1], wt[2], wt[3], wt[4], wt[6], r.dq, r.dkv,
                                             r.wpart_q, r.wpart_kv, r.lnpart_q, r.lnpart_kv, dxq, dxkv, g_q, g_kv,
                                             g_ln_q, g_ln_kv, ntok, D, st));
}
