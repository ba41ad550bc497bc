// Pieces shared by the eval (window_attention.cu) and training
// (window_attention_train.cu) window-attention kernels: the LayerNorm +
// Q/KV projection kernel, the per-group window-attention forward, and the
// counter-based hash that draws the attention-dropout mask.
//
// The build hash of every csrc/*.cu covers this header (ops/kernels.py).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
// one image; thread (window, head, query).  Shared: k and v of the block's
// windows, [WPB][N][ch] each.  With DROP the probabilities are multiplied by
// the dropout mask (kept entries by inv_keep) before the product with v.
template <int N, bool DROP>
__global__ void window_attn_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                                   const float* __restrict__ bias, const float* __restrict__ mask,
                                   float* __restrict__ out, int H, int W, int D, int g, int gh,
                                   int ws, int sh, int wpb, float scale, int corrected,
                                   uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ float sm[];
  const int ch = gh * GCH;
  const int L = H * W;
  const int nwc = W / ws, nw = (H / ws) * nwc;
  const int b = blockIdx.y;
  float* ks = sm;
  float* vs = sm + wpb * N * ch;
  const float* kvb = kv + (int64_t)b * L * 2 * D;
  for (int e = threadIdx.x; e < wpb * N * ch; e += blockDim.x) {
    const int lw = e / (N * ch), j = (e / ch) % N, c = e % ch;
    const int widx = blockIdx.x * wpb + lw;
    float kval = 0.f, vval = 0.f;
    if (widx < nw) {
      const int tok = window_token(widx, j, ws, nwc, sh, H, W);
      kval = kvb[(int64_t)tok * 2 * D + g * ch + c];
      vval = kvb[(int64_t)tok * 2 * D + D + g * ch + c];
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
  const float* qrow = q + ((int64_t)b * L + tok) * D + g * ch + hd * GCH;
#pragma unroll
  for (int d = 0; d < GCH; ++d) qv[d] = qrow[d] * scale;
  const float* kw = ks + lw * N * ch + hd * GCH;
  const float* vw = vs + lw * N * ch + hd * GCH;
  const float* brow = bias + (hd * N + i) * N;
  const float* mrow = sh > 0 ? mask + ((int64_t)widx * N + i) * N : nullptr;
  float s[N];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < GCH; ++d) acc = fmaf(qv[d], kw[j * ch + d], acc);
    acc += __ldg(brow + j);
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
  float* orow = out + ((int64_t)b * L + row) * D + g * ch + hd * GCH;
#pragma unroll
  for (int d = 0; d < GCH; ++d) orow[d] = o[d];
}

template <int N, bool DROP>
cudaError_t launch_attn(const float* q, const float* kv, const float* bias, const float* mask, float* out,
                        int B, int H, int W, int D, int g, int gh, int ws, int sh, float scale,
                        int corrected, uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t st) {
  const int wpb = (N * gh >= 128) ? 1 : 128 / (N * gh);
  const int threads = wpb * gh * N;
  const int nw = (H / ws) * (W / ws);
  const size_t smem = (size_t)2 * wpb * N * gh * GCH * sizeof(float);
  dim3 grid((nw + wpb - 1) / wpb, B);
  cudaFuncSetAttribute(window_attn_kernel<N, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  window_attn_kernel<N, DROP><<<grid, threads, smem, st>>>(q, kv, bias, mask, out, H, W, D, g, gh, ws, sh,
                                                           wpb, scale, corrected, seed, thresh, inv_keep);
  return cudaGetLastError();
}

// Launch the forward attention of every group; bias and mask are the
// per-group tables concatenated (masks of shifted groups only).
template <bool DROP>
cudaError_t launch_attn_groups(const float* q, const float* kv, const float* bias, const float* mask, float* out,
                               int B, int H, int W, int D, int n_group, const int* ws, const int* shifts, int gh,
                               float scale, int corrected, uint32_t seed, uint32_t thresh, float inv_keep,
                               cudaStream_t st) {
  size_t boff = 0, moff = 0;
  for (int g = 0; g < n_group; ++g) {
    const int n = ws[g] * ws[g];
    const float* mg = shifts[g] > 0 ? mask + moff : nullptr;
    cudaError_t err;
    switch (ws[g]) {
      case 2: err = launch_attn<4, DROP>(q, kv, bias + boff, mg, out, B, H, W, D, g, gh, ws[g], shifts[g], scale, corrected, seed, thresh, inv_keep, st); break;
      case 4: err = launch_attn<16, DROP>(q, kv, bias + boff, mg, out, B, H, W, D, g, gh, ws[g], shifts[g], scale, corrected, seed, thresh, inv_keep, st); break;
      case 8: err = launch_attn<64, DROP>(q, kv, bias + boff, mg, out, B, H, W, D, g, gh, ws[g], shifts[g], scale, corrected, seed, thresh, inv_keep, st); break;
      default: err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
    boff += (size_t)gh * n * n;
    if (shifts[g] > 0) moff += (size_t)(H / ws[g]) * (W / ws[g]) * n * n;
  }
  return cudaSuccess;
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

}  // namespace
