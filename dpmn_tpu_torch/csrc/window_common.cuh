// Forward pieces shared by the window-attention kernels (window_attention.cu,
// window_attention_train.cu, window_attention_core.cu,
// window_attention_full.cu, grouped_window_attention.cu) and the
// dropout-mask dump (dropout_mask.cu): the LayerNorm + Q/KV projection
// kernel (persistent CTAs, the product on the tensor cores), the per-group
// window-attention forward (float32 or bf16 io), the counter-based hash
// that draws the attention-dropout mask, and SKConv's three forward kernels
// (the two products on the tensor cores).
//
// The build hash of every csrc/*.cu covers this header (ops/kernels.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

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

constexpr int TOK = 64;      // tokens per tile of the token-tile kernels
constexpr int THREADS = 256;  // 8 warps
constexpr int GCH = 16;       // the head dim the path gives (32 channels per group over 2 heads)
constexpr int LNP_WARPS = 12;  // ln_proj: warps 0-3 own the q columns, 4-11 the kv columns
constexpr int LNP_THREADS = 32 * LNP_WARPS;

// Stage a weight W (rows x k, row-major in global memory) into shared
// memory as [rows][ld] (ld = k + 4: conflict-free B fragments of mma_tile).
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ w, int rows, int k, int ld) {
  for (int idx = threadIdx.x; idx < rows * k; idx += blockDim.x) dst[(idx / k) * ld + idx % k] = __ldg(w + idx);
}

// The tile of TOK tokens starting at token t0 of a (ntok, c) row-major
// tensor into shared memory [TOK][ld] by cp.async (rows past ntok are
// zero), as one committed group.  c % 4 == 0; rows 16-byte aligned.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ x, int64_t t0, int ntok,
                                          int c, int64_t row_stride) {
  const int c4 = c / 4;
  for (int e = threadIdx.x; e < TOK * c4; e += blockDim.x) {
    const int r = e / c4, k = (e % c4) * 4;
    const bool valid = t0 + r < ntok;
    cp_async16_zfill(dst + r * ld + k, valid ? x + (t0 + r) * row_stride + k : x, valid);
  }
}

// Sums over the warp of R values at once: the same xor tree for each, the
// R shuffle chains interleaved.
template <int R>
__device__ __forceinline__ void warp_sums(float (&v)[R]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] += __shfl_xor_sync(0xffffffffu, v[r], off);
}

// The LN of rows r0, r0 + step, ..., (R of them, those below nrows) of a
// [rows][ld] tile of c <= 96 channels in shared memory, in place, by one
// warp (lane holds channels lane + 32 m): float32 statistics, var = E[x^2]
// - mean^2 clamped at 0, eps 1e-6, then * s + b (s[m], b[m] the lane's
// channels), the formula of the JAX package's fused path
// (dpmn_tpu/ops/pallas_window.py:191-202).  The R rows' reductions run side
// by side; each row's sums keep the order of one row alone.
template <int R>
__device__ __forceinline__ void ln_rows_inplace(float* tile, int ld, int r0, int step, int nrows, int c,
                                                const float (&s)[3], const float (&b)[3]) {
  const int lane = threadIdx.x & 31;
  float v[R][3], sum[R], sq[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r * step;
    sum[r] = sq[r] = 0.f;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int k = lane + 32 * m;
      v[r][m] = row < nrows && k < c ? tile[row * ld + k] : 0.f;
      sum[r] += v[r][m];
      sq[r] += v[r][m] * v[r][m];
    }
  }
  warp_sums(sum);
  warp_sums(sq);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r * step;
    const float mean = sum[r] / c;
    const float var = fmaxf(sq[r] / c - mean * mean, 0.f);
    const float rstd = 1.0f / sqrtf(var + 1e-6f);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int k = lane + 32 * m;
      if (row < nrows && k < c) tile[row * ld + k] = (v[r][m] - mean) * rstd * s[m] + b[m];
    }
  }
}

// LN + projections, q = ln(xq) Wq^T + bq and kv = ln(xkv) Wkv^T + bkv, on
// persistent CTAs.  Each CTA stages [Wq; Wkv] (3D x D) once into shared
// memory, then walks the tiles of TOK tokens blockIdx.x, + gridDim.x, ...:
// a tile's xq and xkv rows land by cp.async while the previous tile is
// computed (two stages), are normalized in place (do_ln), and the product
// runs on the tensor cores (mma_tile, 3xTF32): warp w owns the tile's 4
// m-tiles and the D/32 n-tiles of output columns [w D/4, (w + 1) D/4),
// which are q columns for w < 4 and kv columns after.  Shared: w [3D][D + 4],
// xs [2 stages][2 streams][TOK][D + 4].
template <int D>
__global__ void __launch_bounds__(LNP_THREADS, 1)
    ln_proj_kernel(const float* __restrict__ xq, const float* __restrict__ xkv, const float* __restrict__ qs,
                   const float* __restrict__ qb, const float* __restrict__ ks, const float* __restrict__ kb,
                   const float* __restrict__ qw, const float* __restrict__ qbias, const float* __restrict__ kvw,
                   const float* __restrict__ kvbias, float* __restrict__ qout, float* __restrict__ kvout, int ntok,
                   int do_ln) {
  constexpr int S = D + 4, NT = D / 32;
  extern __shared__ __align__(16) float sm[];
  float* w = sm;
  float* xs = w + 3 * D * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int ntile = (ntok + TOK - 1) / TOK;
  auto load = [&](int tile, int stage) {
    float* dst = xs + stage * 2 * TOK * S;
    load_tile(dst, S, xq, (int64_t)tile * TOK, ntok, D, D);
    load_tile(dst + TOK * S, S, xkv, (int64_t)tile * TOK, ntok, D, D);
    cp_async_commit();
  };
  if (blockIdx.x < ntile) load(blockIdx.x, 0);
  stage_rows(w, qw, D, D, S);
  stage_rows(w + D * S, kvw, 2 * D, D, S);
  float lsq[3], lbq[3], lsk[3], lbk[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int k = lane + 32 * m;
    const bool on = do_ln && k < D;
    lsq[m] = on ? qs[k] : 0.f;
    lbq[m] = on ? qb[k] : 0.f;
    lsk[m] = on ? ks[k] : 0.f;
    lbk[m] = on ? kb[k] : 0.f;
  }
  const bool is_q = warp < 4;
  const int n0 = warp * NT * 8;  // the warp's first column of the 3D outputs
  float bias[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = n0 + 8 * j + 2 * t4 + e;
      bias[j][e] = is_q ? qbias[o] : kvbias[o - D];
    }
  int stage = 0;
  for (int tile = blockIdx.x; tile < ntile; tile += gridDim.x, stage ^= 1) {
    const int next = tile + gridDim.x;
    if (next < ntile) load(next, stage ^ 1);
    cp_async_wait(next < ntile ? 1 : 0);
    __syncthreads();  // this tile's rows (and, the first time, w) are in shared memory
    float* xt = xs + stage * 2 * TOK * S;
    if (do_ln) {  // rows warp, warp + 12, ... of each stream
      ln_rows_inplace<(TOK + LNP_WARPS - 1) / LNP_WARPS>(xt, S, warp, LNP_WARPS, TOK, D, lsq, lbq);
      ln_rows_inplace<(TOK + LNP_WARPS - 1) / LNP_WARPS>(xt + TOK * S, S, warp, LNP_WARPS, TOK, D, lsk, lbk);
      __syncthreads();
    }
    float acc[4][NT][4];
    zero_acc(acc);
    mma_tile<false, false, 4, NT>(acc, xt + (is_q ? 0 : TOK * S), S, 0, w, S, n0, D);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t t = (int64_t)tile * TOK + 16 * i + g8 + 8 * h;
        if (t >= ntok) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int o = n0 + 8 * j + 2 * t4;
          const float2 val = make_float2(acc[i][j][2 * h] + bias[j][0], acc[i][j][2 * h + 1] + bias[j][1]);
          if (is_q)
            *reinterpret_cast<float2*>(qout + t * D + o) = val;
          else
            *reinterpret_cast<float2*>(kvout + t * 2 * D + o - D) = val;
        }
      }
    __syncthreads();  // every warp is done with this stage before it is refilled
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

// Persistent grids: one CTA per SM, or per tile where there are fewer.
inline cudaError_t persistent_grid(int ntile, int* grid) {
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  *grid = ntile < sms ? ntile : sms;
  return err;
}

// 16-byte alignment of the rows that cp.async copies.
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int D>
cudaError_t launch_ln_proj_d(const float* xq, const float* xkv, const float* qs, const float* qb, const float* ks,
                             const float* kb, const float* q_w, const float* q_b, const float* kv_w,
                             const float* kv_b, float* qbuf, float* kvbuf, int ntok, int do_ln, cudaStream_t st) {
  const size_t smem = (size_t)(3 * D + 4 * TOK) * (D + 4) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ln_proj_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int grid = 0;
  if (err != cudaSuccess || (err = persistent_grid((ntok + TOK - 1) / TOK, &grid)) != cudaSuccess) return err;
  if (grid == 0) return cudaSuccess;
  ln_proj_kernel<D><<<grid, LNP_THREADS, smem, st>>>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf,
                                                     ntok, do_ln);
  return cudaGetLastError();
}

// LN (when do_ln) + the q / kv projections of ntok tokens: qbuf (ntok, D),
// kvbuf (ntok, 2D).  D in {32, 64, 96}; xq and xkv 16-byte aligned.
inline cudaError_t launch_ln_proj(const float* xq, const float* xkv, const float* qs, const float* qb,
                                  const float* ks, const float* kb, const float* q_w, const float* q_b,
                                  const float* kv_w, const float* kv_b, float* qbuf, float* kvbuf, int ntok,
                                  int D, int do_ln, cudaStream_t st) {
  if (!aligned16(xq) || !aligned16(xkv)) return cudaErrorMisalignedAddress;
  switch (D) {
    case 32: return launch_ln_proj_d<32>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, do_ln, st);
    case 64: return launch_ln_proj_d<64>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, do_ln, st);
    case 96: return launch_ln_proj_d<96>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, do_ln, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- SKConv
// (reference model/pgrm.py:62-96; exact erf GELU)

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

// The warp layout of the D-wide token-tile products on 8 warps: warp w
// owns m-tiles 2 (w / 4) and 2 (w / 4) + 1 of the TOK-token tile and the
// D/32 n-tiles of output columns [(w % 4) D/4, (w % 4 + 1) D/4).
struct TileWarp {
  int mg, m0, n0, g8, t4;
  template <int NT>
  __device__ static TileWarp make() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return TileWarp{warp >> 2, 32 * (warp >> 2), (warp & 3) * NT * 8, lane >> 2, lane & 3};
  }
};

// (c1) feats = attn Wp^T + bp, and per-tile sums of gelu(feats), on
// persistent CTAs: Wp staged once, attn tiles by cp.async (two stages), the
// product on the tensor cores (mma_tile, 3xTF32).  A tile's sum is fixed in
// order: each thread's 4 rows, a shuffle tree over the 8 row groups of a
// warp, then the two m-groups.  Shared: w [D][D + 4], xs [2][TOK][D + 4],
// red [2][D].
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    skconv_proj_kernel(const float* __restrict__ attn, const float* __restrict__ pw, const float* __restrict__ pb,
                       float* __restrict__ feats, float* __restrict__ partial, int ntile) {
  constexpr int S = D + 4, NT = D / 32;
  extern __shared__ __align__(16) float sm[];
  float* w = sm;
  float* xs = w + D * S;
  float* red = xs + 2 * TOK * S;
  const int ntok = ntile * TOK;
  if (blockIdx.x < ntile) {
    load_tile(xs, S, attn, (int64_t)blockIdx.x * TOK, ntok, D, D);
    cp_async_commit();
  }
  stage_rows(w, pw, D, D, S);
  const TileWarp tw = TileWarp::make<NT>();
  float bias[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[j][e] = pb[tw.n0 + 8 * j + 2 * tw.t4 + e];
  int stage = 0;
  for (int tile = blockIdx.x; tile < ntile; tile += gridDim.x, stage ^= 1) {
    const int next = tile + gridDim.x;
    if (next < ntile) {
      load_tile(xs + (stage ^ 1) * TOK * S, S, attn, (int64_t)next * TOK, ntok, D, D);
      cp_async_commit();
    }
    cp_async_wait(next < ntile ? 1 : 0);
    __syncthreads();
    float acc[2][NT][4];
    zero_acc(acc);
    mma_tile<false, false, 2, NT>(acc, xs + stage * TOK * S, S, tw.m0, w, S, tw.n0, D);
    float gs[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) gs[j][0] = gs[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t t = (int64_t)tile * TOK + tw.m0 + 16 * i + tw.g8 + 8 * h;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float f0 = acc[i][j][2 * h] + bias[j][0], f1 = acc[i][j][2 * h + 1] + bias[j][1];
          *reinterpret_cast<float2*>(feats + t * D + tw.n0 + 8 * j + 2 * tw.t4) = make_float2(f0, f1);
          gs[j][0] += gelu_erf(f0);
          gs[j][1] += gelu_erf(f1);
        }
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) gs[j][e] += __shfl_xor_sync(0xffffffffu, gs[j][e], off);
        if (tw.g8 == 0) red[tw.mg * D + tw.n0 + 8 * j + 2 * tw.t4 + e] = gs[j][e];
      }
    __syncthreads();
    for (int o = threadIdx.x; o < D; o += blockDim.x) partial[(int64_t)tile * D + o] = red[o] + red[D + o];
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

// (c3) out = [xkv +] feats + (sum_g gate_g * attn_g) Wph^T + bph, on
// persistent CTAs: Wph staged once, attn tiles by cp.async (two stages),
// the gated sum fv of each tile into shared memory, its product with Wph on
// the tensor cores (mma_tile over K = ch).  A tile lies in one image (L %
// TOK == 0).  Shared: w [D][ch + 4], xs [2][TOK][D + 4], fv [TOK][ch + 4].
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    skconv_out_kernel(const float* __restrict__ attn, const float* __restrict__ feats, const float* __restrict__ gate,
                      const float* __restrict__ phw, const float* __restrict__ phb, const float* __restrict__ xkv,
                      float* __restrict__ out, int L, int n_group, int ch, int ntile, int residual) {
  constexpr int S = D + 4, NT = D / 32;
  const int SC = ch + 4;
  extern __shared__ __align__(16) float sm[];
  float* w = sm;
  float* xs = w + D * SC;
  float* fv = xs + 2 * TOK * S;
  const int ntok = ntile * TOK;
  if (blockIdx.x < ntile) {
    load_tile(xs, S, attn, (int64_t)blockIdx.x * TOK, ntok, D, D);
    cp_async_commit();
  }
  stage_rows(w, phw, D, ch, SC);
  const TileWarp tw = TileWarp::make<NT>();
  float bias[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[j][e] = phb[tw.n0 + 8 * j + 2 * tw.t4 + e];
  int stage = 0;
  for (int tile = blockIdx.x; tile < ntile; tile += gridDim.x, stage ^= 1) {
    const int next = tile + gridDim.x;
    if (next < ntile) {
      load_tile(xs + (stage ^ 1) * TOK * S, S, attn, (int64_t)next * TOK, ntok, D, D);
      cp_async_commit();
    }
    cp_async_wait(next < ntile ? 1 : 0);
    __syncthreads();
    const float* xt = xs + stage * TOK * S;
    const float* gb = gate + (int64_t)((int64_t)tile * TOK / L) * n_group * ch;
    for (int idx = threadIdx.x; idx < TOK * ch; idx += blockDim.x) {
      const int r = idx / ch, c = idx % ch;
      float acc = 0.f;
      for (int g = 0; g < n_group; ++g) acc = fmaf(xt[r * S + g * ch + c], gb[g * ch + c], acc);
      fv[r * SC + c] = acc;
    }
    __syncthreads();
    float acc[2][NT][4];
    zero_acc(acc);
    mma_tile<false, false, 2, NT>(acc, fv, SC, tw.m0, w, SC, tw.n0, ch);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t t = (int64_t)tile * TOK + tw.m0 + 16 * i + tw.g8 + 8 * h;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int64_t off = t * D + tw.n0 + 8 * j + 2 * tw.t4;
          const float2 f = *reinterpret_cast<const float2*>(feats + off);
          float2 sk = make_float2(f.x + (acc[i][j][2 * h] + bias[j][0]), f.y + (acc[i][j][2 * h + 1] + bias[j][1]));
          if (residual) {
            const float2 r = *reinterpret_cast<const float2*>(xkv + off);
            sk = make_float2(r.x + sk.x, r.y + sk.y);
          }
          *reinterpret_cast<float2*>(out + off) = sk;
        }
      }
  }
}

template <int D>
cudaError_t launch_skconv_d(const float* attn, const float* proj_w, const float* proj_b, const float* fc1_w,
                            const float* fc1_b, const float* fc2_w, const float* fc2_b, const float* ph_w,
                            const float* ph_b, const float* xkv, float* feats, float* partial, float* gate,
                            float* out, int B, int L, int n_group, int dz, int residual, cudaStream_t st) {
  const int ntile = B * L / TOK, ch = D / n_group;
  int grid = 0;
  cudaError_t err = persistent_grid(ntile, &grid);
  if (err != cudaSuccess || grid == 0) return err;
  const size_t smem_c1 = (size_t)(D * (D + 4) + 2 * TOK * (D + 4) + 2 * D) * sizeof(float);
  if ((err = cudaFuncSetAttribute(skconv_proj_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_c1)) != cudaSuccess)
    return err;
  skconv_proj_kernel<D><<<grid, THREADS, smem_c1, st>>>(attn, proj_w, proj_b, feats, partial, ntile);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem_c2 = (size_t)(D + 2 * dz + n_group * ch) * sizeof(float);
  skconv_gate_kernel<<<B, 128, smem_c2, st>>>(partial, fc1_w, fc1_b, fc2_w, fc2_b, gate, L, D, dz, n_group, ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem_c3 = (size_t)(D * (ch + 4) + 2 * TOK * (D + 4) + TOK * (ch + 4)) * sizeof(float);
  if ((err = cudaFuncSetAttribute(skconv_out_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_c3)) != cudaSuccess)
    return err;
  skconv_out_kernel<D><<<grid, THREADS, smem_c3, st>>>(attn, feats, gate, ph_w, ph_b, xkv, out, L, n_group, ch, ntile,
                                                       residual);
  return cudaGetLastError();
}

// SKConv after the attention: (c1) feats and the GAP partials, (c2) the
// gate, (c3) out = [xkv +] feats + proj_head(sum_g gate_g * attn_g).
// Scratch: feats (B, L, D), partial (B, L/64, D), gate (B, n_group, ch).
// D in {32, 64, 96}, L % 64 == 0, ch = D / n_group a multiple of 8.
inline cudaError_t launch_skconv(const float* attn, const float* proj_w, const float* proj_b, const float* fc1_w,
                                 const float* fc1_b, const float* fc2_w, const float* fc2_b, const float* ph_w,
                                 const float* ph_b, const float* xkv, float* feats, float* partial, float* gate,
                                 float* out, int B, int L, int D, int n_group, int dz, int residual,
                                 cudaStream_t st) {
  if (!aligned16(attn) || (D / n_group) % 8 != 0) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch_skconv_d<32>(attn, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ph_w, ph_b, xkv, feats, partial, gate, out, B, L, n_group, dz, residual, st);
    case 64: return launch_skconv_d<64>(attn, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ph_w, ph_b, xkv, feats, partial, gate, out, B, L, n_group, dz, residual, st);
    case 96: return launch_skconv_d<96>(attn, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ph_w, ph_b, xkv, feats, partial, gate, out, B, L, n_group, dz, residual, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
