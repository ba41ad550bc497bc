// Forward pieces shared by the window-attention kernels (window_attention.cu,
// window_attention_train.cu, window_attention_core.cu,
// window_attention_full.cu, grouped_window_attention.cu) and the
// dropout-mask dump (dropout_mask.cu): the LayerNorm + Q/KV projection
// kernel (persistent CTAs, the product on the tensor cores), the per-group
// window-attention forward (float32 or bf16 io, every group in one launch;
// the 4x4 and 8x8 windows on the tensor cores through attn_tile.cuh), the
// counter-based hash
// that draws the attention-dropout mask, and SKConv's three forward kernels
// (the two products on the tensor cores).
//
// The build hash of every csrc/*.cu covers this header (ops/kernels.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace {

// Loads and stores of the attention's io type, computing in float32 (for
// float the plain loads and stores): one element, two adjacent ones, a
// head's row of GCH values (as 16-byte pieces where `vec`), and 4 adjacent
// values.
__device__ __forceinline__ float ldg_one(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_one(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ float2 ldg_pair(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }
__device__ __forceinline__ float2 ldg_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ void load_row16(float (&x)[16], const float* p, int vec) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + c);
      x[4 * c] = t.x, x[4 * c + 1] = t.y, x[4 * c + 2] = t.z, x[4 * c + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < 16; ++d) x[d] = __ldg(p + d);
  }
}
__device__ __forceinline__ void load_row16(float (&x)[16], const __nv_bfloat16* p, int vec) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 f = __bfloat1622float2(h[m]);
        x[8 * c + 2 * m] = f.x, x[8 * c + 2 * m + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < 16; ++d) x[d] = __bfloat162float(p[d]);
  }
}
__device__ __forceinline__ void store4(float* p, float4 x, int vec) {
  if (vec)
    *reinterpret_cast<float4*>(p) = x;
  else
    p[0] = x.x, p[1] = x.y, p[2] = x.z, p[3] = x.w;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x, int vec) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y), b = __floats2bfloat162_rn(x.z, x.w);
  if (vec) {
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&a);
    u.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    p[0] = a.x, p[1] = a.y, p[2] = b.x, p[3] = b.y;
  }
}
template <typename T>
__device__ __forceinline__ void store_row16(T* p, const float (&x)[16], int vec) {
#pragma unroll
  for (int c = 0; c < 4; ++c) store4(p + 4 * c, make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]), vec);
}


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

// window_token for a window size known at compile time: one division, and
// the roll's wrap a subtraction (sh < WS <= H, W).
template <int WS>
__device__ __forceinline__ int window_token_c(int widx, int j, int nwc, int sh, int H, int W) {
  const int wr = widx / nwc, wc = widx - wr * nwc;
  int r = wr * WS + j / WS + sh, c = wc * WS + j % WS + sh;
  if (r >= H) r -= H;
  if (c >= W) c -= W;
  return r * W + c;
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

// The tensor-core attention forward's step (windows a CTA computes at once:
// its 8 warps take the windows' gh x N/16 row tiles) and the row strides of
// its shared slots, in elements of the io type (attn_tile.cuh).
__host__ __device__ inline int fwd_windows_a_step(int n, int gh) {
  const int tiles = gh * (n / 16);
  return tiles >= 8 ? 1 : 8 / tiles;
}
__host__ __device__ inline int fwd_ldq(int ch) { return ch + 8; }
template <typename T>
__host__ __device__ inline int fwd_ldv(int ch) { return ch + (sizeof(T) == 4 ? 4 : 8); }

// One channel group of an attention-forward launch: its window and shift,
// its tables and the first of its units in the launch's work list.
template <typename T>
struct AttnGroup {
  const T* bias;      // (gh, N, N)
  const float* mask;  // (nW, N, N) where sh > 0
  int g, ws, sh, unit0;
};
constexpr int MAX_ATTN_GROUPS = 6;  // D <= 96 in groups of 16 gh >= 16 channels

// The arguments of one attention-forward launch (a __grid_constant__
// kernel parameter).  grp holds the groups in work-list order: 8x8, then
// 4x4, then 2x2 windows.
template <typename T>
struct AttnArgs {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  int kvs, B, H, W, D, gh, corrected, vec;
  float scale, inv_keep;
  uint32_t seed, thresh;
  int n_group, n_units, buf_elems;
  AttnGroup<T> grp[MAX_ATTN_GROUPS];
};

// A 2x2-window unit on the CUDA cores: a thread per (window, head, query
// row), THREADS rows a unit; its q row and the window's k and v rows read as
// 16-byte pieces (the 4 threads of a window and head share them through
// L1), the 4 scores, softmax, dropout and the 16 outputs in registers.
template <bool DROP, typename T>
__device__ __forceinline__ void attn_unit4(const AttnArgs<T>& a, const AttnGroup<T>& gr, int unit) {
  const int ch = a.gh * GCH, L = a.H * a.W;
  const int nwc = a.W / 2, nw = (a.H / 2) * nwc;
  const int t = unit * THREADS + threadIdx.x;
  if (t >= a.B * nw * a.gh * 4) return;
  const int i = t & 3, hd = (t >> 2) % a.gh, u = t / (4 * a.gh);
  const int b = u / nw, widx = u - b * nw;
  const int64_t base = (int64_t)b * L;
  const int col = gr.g * ch + hd * GCH;
  int tok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) tok[j] = window_token_c<2>(widx, j, nwc, gr.sh, a.H, a.W);
  float qv[GCH], s[4];
  load_row16(qv, a.q + (base + tok[i]) * a.D + col, a.vec);
  const T* brow = gr.bias + (hd * 4 + i) * 4;
  const float* mrow = gr.sh > 0 ? gr.mask + ((int64_t)widx * 4 + i) * 4 : nullptr;
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float kv[GCH];
    load_row16(kv, a.k + (base + tok[j]) * a.kvs + col, a.vec);
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < GCH; ++d) acc = fmaf(qv[d], kv[d], acc);
    acc = acc * a.scale + ldg_one(brow + j);
    if (mrow) acc += __ldg(mrow + j);
    s[j] = acc;
    mx = fmaxf(mx, acc);
  }
  float den = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = __expf(s[j] - mx);
    den += s[j];
  }
  const float inv = 1.0f / den;
  const uint32_t rkey = DROP ? dropout_row_key(a.seed, b, gr.g, hd, widx, i) : 0u;
  float o[GCH];
#pragma unroll
  for (int d = 0; d < GCH; ++d) o[d] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float p = s[j] * inv;
    if (DROP) p = (hash_step(rkey, j) & 0x7fffffffu) < a.thresh ? p * a.inv_keep : 0.f;
    float vv[GCH];
    load_row16(vv, a.v + (base + tok[j]) * a.kvs + col, a.vec);
#pragma unroll
    for (int d = 0; d < GCH; ++d) o[d] = fmaf(p, vv[d], o[d]);
  }
  store_row16(a.out + (base + (a.corrected ? tok[i] : widx * 4 + i)) * a.D + col, o, a.vec);
}

// Stage step `step` of a 4x4 (N = 16) or 8x8 (N = 64) group, its wps
// windows' q, k, v rows, into the shared slots at dst as one committed
// cp.async group: 16-byte pieces (cp.async) where `vec`, else elements; a
// thread takes (row, piece) pairs, the same piece of q, k, v.  Slot
// (elements of T): q, k [N][ldq], v [N][ldv].
template <int N, typename T>
__device__ __forceinline__ void attn_stage(const AttnArgs<T>& a, const AttnGroup<T>& gr, int step, T* dst0) {
  constexpr int WS = N == 16 ? 4 : 8;
  const int ch = a.gh * GCH, L = a.H * a.W;
  const int nwc = a.W / WS, nw = (a.H / WS) * nwc, units = a.B * nw;
  const int wps = fwd_windows_a_step(N, a.gh), ldq = fwd_ldq(ch), ldv = fwd_ldv<T>(ch);
  const int slot = N * (2 * ldq + ldv);
  const int per = a.vec ? ch * (int)sizeof(T) / 16 : ch;  // pieces of a row
  const int each = a.vec ? 16 / (int)sizeof(T) : 1;       // elements of a piece
  for (int e = threadIdx.x; e < wps * N * per; e += THREADS) {
    const int row = e / per, c = (e - row * per) * each, l = row / N, j = row % N;
    const int u = step * wps + l;
    if (u >= units) continue;
    const int b = u / nw, widx = u - b * nw;
    const int64_t tok = (int64_t)b * L + window_token_c<WS>(widx, j, nwc, gr.sh, a.H, a.W);
    const T* qs = a.q + tok * a.D + gr.g * ch + c;
    const T* ks = a.k + tok * a.kvs + gr.g * ch + c;
    const T* vs = a.v + tok * a.kvs + gr.g * ch + c;
    T* dst = dst0 + l * slot + j * ldq + c;
    T* vdst = dst0 + l * slot + 2 * N * ldq + j * ldv + c;
    if (a.vec) {
      cp_async16_bytes(dst, qs);
      cp_async16_bytes(dst + N * ldq, ks);
      cp_async16_bytes(vdst, vs);
    } else {
      dst[0] = qs[0];
      dst[N * ldq] = ks[0];
      vdst[0] = vs[0];
    }
  }
  cp_async_commit();
}

// A staged step of a 4x4 or 8x8 group on the tensor cores: a warp owns 16
// query rows of one head of one window (attn_tile.cuh: 3xTF32 for float32,
// bf16 m16n8k16 for bf16), the bias and mask read straight into the score
// registers (8-byte loads, a quad per 32-byte sector), the softmax and the
// dropout in registers, and each output row written in 16-byte pieces (a
// lane pair swaps halves so that each lane holds 4 adjacent columns).
template <int N, bool DROP, typename T>
__device__ __forceinline__ void attn_step_tc(const AttnArgs<T>& a, const AttnGroup<T>& gr, int step, const T* sb) {
  constexpr int WS = N == 16 ? 4 : 8, MT = N / 16, NT = N / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int ch = a.gh * GCH, L = a.H * a.W;
  const int nwc = a.W / WS, nw = (a.H / WS) * nwc, units = a.B * nw;
  const int tasks = a.gh * MT, wps = fwd_windows_a_step(N, a.gh);
  const int ldq = fwd_ldq(ch), ldv = fwd_ldv<T>(ch), slot = N * (2 * ldq + ldv);
  for (int task = warp; task < wps * tasks; task += THREADS / 32) {
    const int lw = task / tasks, hd = (task % tasks) / MT, mi = task % MT;
    const int u = step * wps + lw;
    if (u >= units) continue;
    const int b = u / nw, widx = u - b * nw;
    const T* Qs = sb + lw * slot;
    float s[NT][4] = {};
    if constexpr (sizeof(T) == 2)
      qk_tile_bf16<NT>(s, Qs + 16 * mi * ldq + hd * GCH, ldq, Qs + N * ldq + hd * GCH, ldq);
    else
      qk_tile<NT>(s, Qs + 16 * mi * ldq + hd * GCH, ldq, Qs + N * ldq + hd * GCH, ldq, GCH);
    const T* bh = gr.bias + hd * N * N;
    const float* mw = gr.sh > 0 ? gr.mask + (int64_t)widx * N * N : nullptr;
    const int i0 = 16 * mi + g8;
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (i0 + 8 * r) * N + 8 * jn + 2 * t4;
        float2 add = ldg_pair(bh + off);
        if (mw) {
          const float2 mm = __ldg(reinterpret_cast<const float2*>(mw + off));
          add.x += mm.x;
          add.y += mm.y;
        }
        s[jn][2 * r] = s[jn][2 * r] * a.scale + add.x;
        s[jn][2 * r + 1] = s[jn][2 * r + 1] * a.scale + add.y;
      }
    softmax_rows<true>(s);
    if (DROP) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t rkey = dropout_row_key(a.seed, b, gr.g, hd, widx, i0 + 8 * r);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * jn + 2 * t4 + e;
            float& p = s[jn][2 * r + e];
            p = (hash_step(rkey, j) & 0x7fffffffu) < a.thresh ? p * a.inv_keep : 0.f;
          }
      }
    }
    float o[2][4] = {};
    if constexpr (sizeof(T) == 2)
      pv_tile_bf16<NT>(o, s, Qs + 2 * N * ldq + hd * GCH, ldv);
    else
      pv_tile<NT, 2>(o, s, Qs + 2 * N * ldq + hd * GCH, ldv);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      const int row = a.corrected ? window_token_c<WS>(widx, i, nwc, gr.sh, a.H, a.W) : widx * N + i;
      T* orow = a.out + ((int64_t)b * L + row) * a.D + gr.g * ch + hd * GCH;
      // lane t4 holds columns 2 t4, 2 t4 + 1 of both 8-column tiles; after
      // the swap an even lane holds columns 2 t4 .. 2 t4 + 3 of tile 0, an
      // odd lane columns 2 t4 + 6 .. 2 t4 + 9 (tile 1)
      const bool odd = t4 & 1;
      const float sx = odd ? o[0][2 * r] : o[1][2 * r], sy = odd ? o[0][2 * r + 1] : o[1][2 * r + 1];
      const float rx = __shfl_xor_sync(0xffffffffu, sx, 1), ry = __shfl_xor_sync(0xffffffffu, sy, 1);
      const float4 val = odd ? make_float4(rx, ry, o[1][2 * r], o[1][2 * r + 1])
                             : make_float4(o[0][2 * r], o[0][2 * r + 1], rx, ry);
      store4(orow + (odd ? 2 * t4 + 6 : 2 * t4), val, a.vec);
    }
  }
}

template <typename T>
__device__ __forceinline__ void attn_stage_any(const AttnArgs<T>& a, const AttnGroup<T>& gr, int unit, T* dst) {
  if (gr.ws == 8)
    attn_stage<64>(a, gr, unit - gr.unit0, dst);
  else
    attn_stage<16>(a, gr, unit - gr.unit0, dst);
}

// The windowed attention forward of every channel group in one launch, the
// one routine of K1, K3, K4, K5 and K7.  q rows have stride D; k and v rows
// stride kvs (2D where they are the halves of one kv buffer, D where they
// are tensors of their own).  Per (image b, window widx) and head of group
// g: the -sh roll (window_token), S = scale q k^T + bias [+ mask], P =
// softmax(S), with DROP P times the dropout mask (kept entries by
// inv_keep), and P v, written to raw row widx N + i (faithful) or to the
// query's token row (corrected).  T is the io type of q, k, v, bias and out
// (float, or bf16 for K7); the mask is float32 and every sum runs in
// float32.  `vec`: q, k, v and out are 16-byte aligned, so rows move in
// 16-byte pieces; otherwise element by element (the same arithmetic).
//
// Persistent CTAs of 8 warps walk one work list of units, blockIdx.x, +
// gridDim.x, ...: first the steps of the 8x8 groups, then of the 4x4 groups
// (a step is `wps` consecutive windows whose q, k, v rows, the group's ch =
// 16 gh channels of each token, land in a shared slot by cp.async while the
// previous step is computed, two buffers of buf_elems), then the 2x2 units
// on the CUDA cores, which need no shared memory and fill the tails.  The
// dispatch is per unit, so the groups share one launch and one tail.  At
// least 2 CTAs an SM in float32 (up to 128 registers a thread), 3 in bf16
// (up to 80, no spill; faster than 2 on an H100 SXM, where 4 spill:
// tools/attention_groups.py `ctas2`).
template <bool DROP, typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 3 : 2)
    window_attn_fwd_kernel(const __grid_constant__ AttnArgs<T> a) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  T* sm = reinterpret_cast<T*>(fwd_smem);
  int s = 0, buf = 0;  // the group of the CTA's current unit; the buffer its step sits in
  auto group_of = [&](int u) {
    int t = s;
    while (t + 1 < a.n_group && u >= a.grp[t + 1].unit0) ++t;
    return t;
  };
  if (blockIdx.x < a.n_units) {
    s = group_of(blockIdx.x);
    if (a.grp[s].ws != 2) attn_stage_any(a, a.grp[s], blockIdx.x, sm);
  }
  for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
    const AttnGroup<T>& gr = a.grp[s];
    const int next = u + gridDim.x;
    const int sn = next < a.n_units ? group_of(next) : s;
    if (gr.ws == 2) {  // the rest of this CTA's units are 2x2 units too
      attn_unit4<DROP>(a, gr, u - gr.unit0);
    } else {
      const bool ahead = next < a.n_units && a.grp[sn].ws != 2;
      if (ahead) attn_stage_any(a, a.grp[sn], next, sm + (buf ^ 1) * a.buf_elems);
      cp_async_wait(ahead ? 1 : 0);
      __syncthreads();  // this step's rows are in shared memory
      if (gr.ws == 8)
        attn_step_tc<64, DROP>(a, gr, u - gr.unit0, sm + buf * a.buf_elems);
      else
        attn_step_tc<16, DROP>(a, gr, u - gr.unit0, sm + buf * a.buf_elems);
      __syncthreads();  // every warp is done with this buffer before it is refilled
      buf ^= 1;
    }
    s = sn;
  }
}

// Launch the forward attention of every group, one launch: biases[g] and
// masks[g] are group g's tables (masks[g] read only where shifts[g] > 0).
// Windows of 2, 4 or 8 dividing H and W, at most MAX_ATTN_GROUPS groups.
template <bool DROP, typename T>
cudaError_t launch_attn(const T* q, const T* k, const T* v, int kvs, const T* const* biases,
                        const float* const* masks, T* out, int B, int H, int W, int D, int n_group, const int* ws,
                        const int* shifts, int gh, float scale, int corrected, uint32_t seed, uint32_t thresh,
                        float inv_keep, cudaStream_t st) {
  if (n_group < 1 || n_group > MAX_ATTN_GROUPS) return cudaErrorInvalidValue;
  AttnArgs<T> a;
  a.q = q, a.k = k, a.v = v, a.out = out;
  a.kvs = kvs, a.B = B, a.H = H, a.W = W, a.D = D, a.gh = gh, a.corrected = corrected;
  a.vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
  a.scale = scale, a.inv_keep = inv_keep, a.seed = seed, a.thresh = thresh;
  const int ch = gh * GCH;
  int n = 0, units = 0, buf_elems = 0;
  const int order[3] = {8, 4, 2};
  for (const int want : order)
    for (int g = 0; g < n_group; ++g) {
      if (ws[g] != want) continue;
      if (H % want || W % want) return cudaErrorInvalidValue;
      const int nw = (H / want) * (W / want), nn = want * want;
      a.grp[n++] = AttnGroup<T>{biases[g], shifts[g] > 0 ? masks[g] : nullptr, g, want, shifts[g], units};
      if (want == 2) {
        units += (B * nw * gh * 4 + THREADS - 1) / THREADS;
      } else {
        const int wps = fwd_windows_a_step(nn, gh), slot = wps * nn * (2 * fwd_ldq(ch) + fwd_ldv<T>(ch));
        units += (B * nw + wps - 1) / wps;
        buf_elems = buf_elems > slot ? buf_elems : slot;
      }
    }
  if (n != n_group) return cudaErrorInvalidValue;  // a window other than 2, 4 or 8
  a.n_group = n, a.n_units = units, a.buf_elems = buf_elems;
  const size_t smem = (size_t)2 * buf_elems * sizeof(T);
  auto kern = window_attn_fwd_kernel<DROP, T>;
  static GridCap cache;
  int cap = 0;
  const cudaError_t err = persistent_cap(cache, kern, THREADS, smem, &cap);
  if (err != cudaSuccess) return err;
  const int grid = units < cap ? units : cap;
  if (grid == 0) return cudaSuccess;
  kern<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// launch_attn on the per-group tables concatenated (masks of shifted groups
// only).
template <bool DROP>
cudaError_t launch_attn_groups(const float* q, const float* k, const float* v, int kvs, const float* bias,
                               const float* mask, float* out, int B, int H, int W, int D, int n_group, const int* ws,
                               const int* shifts, int gh, float scale, int corrected, uint32_t seed, uint32_t thresh,
                               float inv_keep, cudaStream_t st) {
  if (n_group < 1 || n_group > MAX_ATTN_GROUPS) return cudaErrorInvalidValue;
  const float* biases[MAX_ATTN_GROUPS];
  const float* masks[MAX_ATTN_GROUPS];
  size_t boff = 0, moff = 0;
  for (int g = 0; g < n_group; ++g) {
    if (ws[g] != 2 && ws[g] != 4 && ws[g] != 8) return cudaErrorInvalidValue;
    const size_t nn = (size_t)ws[g] * ws[g];
    biases[g] = bias + boff;
    masks[g] = shifts[g] > 0 ? mask + moff : nullptr;
    boff += gh * nn * nn;
    if (shifts[g] > 0) moff += (size_t)(H / ws[g]) * (W / ws[g]) * nn * nn;
  }
  return launch_attn<DROP>(q, k, v, kvs, biases, masks, out, B, H, W, D, n_group, ws, shifts, gh, scale, corrected,
                           seed, thresh, inv_keep, st);
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
