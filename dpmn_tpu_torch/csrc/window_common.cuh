// Forward pieces shared by the window-attention kernels (window_attention.cu,
// window_attention_train.cu, window_attention_core.cu,
// window_attention_full.cu, grouped_window_attention.cu) and the
// dropout-mask dump (dropout_mask.cu): the LayerNorm + Q/KV projection
// kernel, the per-group window-attention forward (float32 or bf16 io), the
// counter-based hash that draws the attention-dropout mask, and SKConv's
// three forward kernels.
//
// The build hash of every csrc/*.cu covers this header (ops/kernels.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Loads and stores of the attention's io type, computing in float32.  For
// float they are the plain load and store.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

constexpr int TOK = 64;      // tokens per block in the token-tile kernels
constexpr int THREADS = 256;  // 8 warps x 8 tokens
constexpr int MAXJ = 9;       // output columns per lane: 3*D/32 for D <= 96
constexpr int GCH = 16;       // the head dim the path gives (32 channels per group over 2 heads)

// LN + projections.  Shared: wt [D][3D] (q columns then kv columns),
// xn [2][TOK][D].  Rows of wt are padded by one float.
__global__ void ln_proj_kernel(const float* __restrict__ xq, const float* __restrict__ xkv,
                               const float* __restrict__ qs, const float* __restrict__ qb,
                               const float* __restrict__ ks, const float* __restrict__ kb,
                               const float* __restrict__ qw, const float* __restrict__ qbias,
                               const float* __restrict__ kvw, const float* __restrict__ kvbias,
                               float* __restrict__ qout, float* __restrict__ kvout,
                               int ntok, int D, int do_ln) {
  extern __shared__ float sm[];
  const int G3 = 3 * D, WS = G3 + 1;  // padded row: conflict-free staging
  float* wt = sm;
  float* xnq = wt + D * WS;
  float* xnk = xnq + TOK * D;
  for (int idx = threadIdx.x; idx < G3 * D; idx += blockDim.x) {
    const int o = idx / D, i = idx % D;
    wt[i * WS + o] = o < D ? qw[o * D + i] : kvw[(o - D) * D + i];
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * TOK;
  for (int lt = warp * 8; lt < warp * 8 + 8; ++lt) {
    const int t = t0 + lt;
    for (int which = 0; which < 2; ++which) {
      const float* x = which == 0 ? xq : xkv;
      float* dst = (which == 0 ? xnq : xnk) + lt * D;
      float v[4];
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int c = lane + 32 * m;
        v[m] = (t < ntok && c < D) ? x[(int64_t)t * D + c] : 0.f;
        sum += v[m];
        sq += v[m] * v[m];
      }
      if (do_ln) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
          sq += __shfl_xor_sync(0xffffffffu, sq, off);
        }
        const float mean = sum / D;
        const float var = fmaxf(sq / D - mean * mean, 0.f);
        const float rstd = 1.0f / sqrtf(var + 1e-6f);
        const float* s = which == 0 ? qs : ks;
        const float* b = which == 0 ? qb : kb;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int c = lane + 32 * m;
          if (c < D) dst[c] = (v[m] - mean) * rstd * s[c] + b[c];
        }
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int c = lane + 32 * m;
          if (c < D) dst[c] = v[m];
        }
      }
    }
  }
  __syncthreads();
  const int nj = (G3 + 31) / 32;
  float acc[8][MAXJ];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[a][j] = 0.f;
  const float* xa = xnq + warp * 8 * D;
  const float* xb = xnk + warp * 8 * D;
  for (int i = 0; i < D; ++i) {
    float w[MAXJ];
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int o = lane + 32 * j;
      w[j] = (j < nj && o < G3) ? wt[i * WS + o] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float vq = xa[a * D + i], vk = xb[a * D + i];
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int o = lane + 32 * j;
        acc[a][j] = fmaf(o < D ? vq : vk, w[j], acc[a][j]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int t = t0 + warp * 8 + a;
    if (t >= ntok) continue;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int o = lane + 32 * j;
      if (j >= nj || o >= G3) continue;
      if (o < D)
        qout[(int64_t)t * D + o] = acc[a][j] + qbias[o];
      else
        kvout[(int64_t)t * 2 * D + (o - D)] = acc[a][j] + kvbias[o - D];
    }
  }
}

// Attention-dropout bits: a murmur3 fmix32 chain over (seed, image, group,
// head, window, query, key), one step per coordinate.  The plain version
// (ops/window_attention_train.py dropout_multiplier) evaluates the same chain
// in int64 PyTorch, so kernel and plain version draw the same mask, and the
// backward regenerates the forward's mask.  An entry is kept when the low 31
// bits of its hash are below thresh = min(keep * 2^31, 2^31 - 1).
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash_step(uint32_t h, uint32_t v) { return fmix32(h ^ (v + 0x9e3779b9u)); }

__device__ __forceinline__ uint32_t dropout_row_key(uint32_t seed, int b, int g, int hd, int widx, int i) {
  return hash_step(hash_step(hash_step(hash_step(hash_step(seed, b), g), hd), widx), i);
}

// Token (raster index) of position j of window widx after the -sh roll:
// the rolled grid's (r, c) is the original ((r + sh) mod H, (c + sh) mod W).
__device__ __forceinline__ int window_token(int widx, int j, int ws, int nwc, int sh, int H, int W) {
  const int r = (widx / nwc) * ws + j / ws, cc = (widx % nwc) * ws + j % ws;
  return ((r + sh) % H) * W + (cc + sh) % W;
}

// Windowed attention of one channel group.  A block holds WPB windows of
// one image; thread (window, head, query).  q rows have stride D; k and v
// rows stride kvs (2D where they are the halves of one kv buffer, D where
// they are tensors of their own).  Shared: k and v of the block's windows,
// [WPB][N][ch] each, in float32.  With DROP the probabilities are multiplied
// by the dropout mask (kept entries by inv_keep) before the product with v.
// T is the io type of q, k, v, bias and out (float, or bf16 for the eval
// attention on projected q, k, v); the mask is float32 and every sum runs in
// float32.
template <int N, bool DROP, typename T = float>
__global__ void window_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, int kvs,
                                   const T* __restrict__ bias, const float* __restrict__ mask,
                                   T* __restrict__ out, int H, int W, int D, int g, int gh,
                                   int ws, int sh, int wpb, float scale, int corrected,
                                   uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ float sm[];
  const int ch = gh * GCH;
  const int L = H * W;
  const int nwc = W / ws, nw = (H / ws) * nwc;
  const int b = blockIdx.y;
  float* ks = sm;
  float* vs = sm + wpb * N * ch;
  const int64_t kvbase = (int64_t)b * L * kvs;
  for (int e = threadIdx.x; e < wpb * N * ch; e += blockDim.x) {
    const int lw = e / (N * ch), j = (e / ch) % N, c = e % ch;
    const int widx = blockIdx.x * wpb + lw;
    float kval = 0.f, vval = 0.f;
    if (widx < nw) {
      const int64_t off = kvbase + (int64_t)window_token(widx, j, ws, nwc, sh, H, W) * kvs + g * ch + c;
      kval = to_f32(k[off]);
      vval = to_f32(v[off]);
    }
    ks[e] = kval;
    vs[e] = vval;
  }
  __syncthreads();
  const int lw = threadIdx.x / (gh * N), hd = (threadIdx.x / N) % gh, i = threadIdx.x % N;
  const int widx = blockIdx.x * wpb + lw;
  if (lw >= wpb || widx >= nw) return;
  const int tok = window_token(widx, i, ws, nwc, sh, H, W);
  float qv[GCH];
  const T* qrow = q + ((int64_t)b * L + tok) * D + g * ch + hd * GCH;
#pragma unroll
  for (int d = 0; d < GCH; ++d) qv[d] = to_f32(qrow[d]) * scale;
  const float* kw = ks + lw * N * ch + hd * GCH;
  const float* vw = vs + lw * N * ch + hd * GCH;
  const T* brow = bias + (hd * N + i) * N;
  const float* mrow = sh > 0 ? mask + ((int64_t)widx * N + i) * N : nullptr;
  float s[N];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < GCH; ++d) acc = fmaf(qv[d], kw[j * ch + d], acc);
    acc += ldg_f32(brow + j);
    if (mrow) acc += __ldg(mrow + j);
    s[j] = acc;
    mx = fmaxf(mx, acc);
  }
  float denom = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    s[j] = expf(s[j] - mx);
    denom += s[j];
  }
  const uint32_t rkey = DROP ? dropout_row_key(seed, b, g, hd, widx, i) : 0u;
  float o[GCH];
#pragma unroll
  for (int d = 0; d < GCH; ++d) o[d] = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float p = s[j] / denom;
    if (DROP) p = (hash_step(rkey, j) & 0x7fffffffu) < thresh ? p * inv_keep : 0.f;
#pragma unroll
    for (int d = 0; d < GCH; ++d) o[d] = fmaf(p, vw[j * ch + d], o[d]);
  }
  const int row = corrected ? tok : widx * N + i;
  T* orow = out + ((int64_t)b * L + row) * D + g * ch + hd * GCH;
#pragma unroll
  for (int d = 0; d < GCH; ++d) orow[d] = from_f32<T>(o[d]);
}

template <int N, bool DROP, typename T = float>
cudaError_t launch_attn(const T* q, const T* k, const T* v, int kvs, const T* bias,
                        const float* mask, T* out,
                        int B, int H, int W, int D, int g, int gh, int ws, int sh, float scale,
                        int corrected, uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t st) {
  const int wpb = (N * gh >= 128) ? 1 : 128 / (N * gh);
  const int threads = wpb * gh * N;
  const int nw = (H / ws) * (W / ws);
  const size_t smem = (size_t)2 * wpb * N * gh * GCH * sizeof(float);
  dim3 grid((nw + wpb - 1) / wpb, B);
  cudaFuncSetAttribute(window_attn_kernel<N, DROP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  window_attn_kernel<N, DROP, T><<<grid, threads, smem, st>>>(q, k, v, kvs, bias, mask, out, H, W, D, g, gh, ws,
                                                              sh, wpb, scale, corrected, seed, thresh, inv_keep);
  return cudaGetLastError();
}

// Launch the forward attention of every group; bias and mask are the
// per-group tables concatenated (masks of shifted groups only).
template <bool DROP, typename T = float>
cudaError_t launch_attn_groups(const T* q, const T* k, const T* v, int kvs, const T* bias,
                               const float* mask, T* out, int B, int H, int W, int D, int n_group,
                               const int* ws, const int* shifts, int gh, float scale, int corrected, uint32_t seed,
                               uint32_t thresh, float inv_keep, cudaStream_t st) {
  size_t boff = 0, moff = 0;
  for (int g = 0; g < n_group; ++g) {
    const int n = ws[g] * ws[g];
    const float* mg = shifts[g] > 0 ? mask + moff : nullptr;
    cudaError_t err;
    switch (ws[g]) {
      case 2: err = launch_attn<4, DROP, T>(q, k, v, kvs, bias + boff, mg, out, B, H, W, D, g, gh, ws[g], shifts[g], scale, corrected, seed, thresh, inv_keep, st); break;
      case 4: err = launch_attn<16, DROP, T>(q, k, v, kvs, bias + boff, mg, out, B, H, W, D, g, gh, ws[g], shifts[g], scale, corrected, seed, thresh, inv_keep, st); break;
      case 8: err = launch_attn<64, DROP, T>(q, k, v, kvs, bias + boff, mg, out, B, H, W, D, g, gh, ws[g], shifts[g], scale, corrected, seed, thresh, inv_keep, st); break;
      default: err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
    boff += (size_t)gh * n * n;
    if (shifts[g] > 0) moff += (size_t)(H / ws[g]) * (W / ws[g]) * n * n;
  }
  return cudaSuccess;
}

// launch_attn_groups with the dropout flag chosen at run time.
inline cudaError_t launch_attn_groups_any(const float* q, const float* k, const float* v, int kvs, const float* bias,
                                          const float* mask, float* out, int B, int H, int W, int D, int n_group,
                                          const int* ws, const int* shifts, int gh, float scale, int corrected,
                                          uint32_t seed, uint32_t thresh, float inv_keep, int drop,
                                          cudaStream_t st) {
  return drop ? launch_attn_groups<true>(q, k, v, kvs, bias, mask, out, B, H, W, D, n_group, ws, shifts, gh, scale,
                                         corrected, seed, thresh, inv_keep, st)
              : launch_attn_groups<false>(q, k, v, kvs, bias, mask, out, B, H, W, D, n_group, ws, shifts, gh, scale,
                                          corrected, seed, thresh, inv_keep, st);
}

inline cudaError_t launch_ln_proj(const float* xq, const float* xkv, const float* qs, const float* qb,
                                  const float* ks, const float* kb, const float* q_w, const float* q_b,
                                  const float* kv_w, const float* kv_b, float* qbuf, float* kvbuf, int ntok,
                                  int D, int do_ln, cudaStream_t st) {
  const size_t smem = (size_t)(D * (3 * D + 1) + 2 * TOK * D) * sizeof(float);
  cudaFuncSetAttribute(ln_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  ln_proj_kernel<<<(ntok + TOK - 1) / TOK, THREADS, smem, st>>>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b,
                                                                qbuf, kvbuf, ntok, D, do_ln);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- SKConv
// (reference model/pgrm.py:62-96; exact erf GELU)

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

// SKConv's gate of image b, computed by the whole block: s = the GAP from
// the per-tile partial sums (a fixed-order sum), u = fc1 s + b1, z = gelu(u),
// a = fc2 z + b2, then the softmax over the groups of a, in place (so a
// holds the gate w).  Shared: s [D], u [dz], z [dz], a [n_group * ch].
__device__ void skconv_gate_block(const float* __restrict__ partial, const float* __restrict__ f1w,
                                  const float* __restrict__ f1b, const float* __restrict__ f2w,
                                  const float* __restrict__ f2b, float* s, float* u, float* z, float* a, int b,
                                  int L, int D, int dz, int n_group, int ch) {
  const int ntile = L / TOK;
  for (int o = threadIdx.x; o < D; o += blockDim.x) {
    float acc = 0.f;
    for (int tl = 0; tl < ntile; ++tl) acc += partial[((int64_t)b * ntile + tl) * D + o];
    s[o] = acc / L;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < dz; k += blockDim.x) {
    float acc = f1b[k];
    for (int o = 0; o < D; ++o) acc = fmaf(s[o], f1w[k * D + o], acc);
    u[k] = acc;
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
    for (int g = 0; g < n_group; ++g) a[g * ch + c] = expf(a[g * ch + c] - mx) / den;
  }
  __syncthreads();
}

// (c2) one block per image: the gate, gate (B, n_group, ch).
__global__ void skconv_gate_kernel(const float* __restrict__ partial, const float* __restrict__ f1w,
                                   const float* __restrict__ f1b, const float* __restrict__ f2w,
                                   const float* __restrict__ f2b, float* __restrict__ gate,
                                   int L, int D, int dz, int n_group, int ch) {
  extern __shared__ float sm[];
  float* s = sm;
  float* u = s + D;
  float* z = u + dz;
  float* a = z + dz;
  const int b = blockIdx.x;
  skconv_gate_block(partial, f1w, f1b, f2w, f2b, s, u, z, a, b, L, D, dz, n_group, ch);
  for (int m = threadIdx.x; m < n_group * ch; m += blockDim.x) gate[(int64_t)b * n_group * ch + m] = a[m];
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


// SKConv after the attention: (c1) feats and the GAP partials, (c2) the
// gate, (c3) out = [xkv +] feats + proj_head(sum_g gate_g * attn_g).
// Scratch: feats (B, L, D), partial (B, L/64, D), gate (B, n_group, ch).
inline cudaError_t launch_skconv(const float* attn, const float* proj_w, const float* proj_b, const float* fc1_w,
                                 const float* fc1_b, const float* fc2_w, const float* fc2_b, const float* ph_w,
                                 const float* ph_b, const float* xkv, float* feats, float* partial, float* gate,
                                 float* out, int B, int L, int D, int n_group, int dz, int residual,
                                 cudaStream_t st) {
  const int ntok = B * L, ch = D / n_group;
  const size_t smem_c1 = (size_t)(D * (D + 1) + TOK * D + 8 * D) * sizeof(float);
  cudaFuncSetAttribute(skconv_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c1);
  skconv_proj_kernel<<<ntok / TOK, THREADS, smem_c1, st>>>(attn, proj_w, proj_b, feats, partial, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_c2 = (size_t)(D + 2 * dz + n_group * ch) * sizeof(float);
  skconv_gate_kernel<<<B, 128, smem_c2, st>>>(partial, fc1_w, fc1_b, fc2_w, fc2_b, gate, L, D, dz, n_group, ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem_c3 = (size_t)(ch * (D + 1) + TOK * ch) * sizeof(float);
  cudaFuncSetAttribute(skconv_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c3);
  skconv_out_kernel<<<ntok / TOK, THREADS, smem_c3, st>>>(attn, feats, gate, ph_w, ph_b, xkv, out, L, D, n_group,
                                                          ch, residual);
  return cudaGetLastError();
}

}  // namespace
