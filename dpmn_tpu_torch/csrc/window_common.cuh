// Forward pieces shared by the window-attention kernels (window_attention.cu,
// window_attention_train.cu, window_attention_core.cu,
// window_attention_full.cu, grouped_window_attention.cu) and the
// dropout-mask dump (dropout_mask.cu): the LayerNorm + Q/KV projection
// kernel (persistent CTAs, the product on the tensor cores; a bf16-io form
// on bf16 m16n8k16 for K1's bf16 serving path), the per-group
// window-attention forward (float32 or bf16 io, every group in one launch;
// the 4x4 and 8x8 windows on the tensor cores through attn_tile.cuh), the
// training cores' bf16 forward (bf16 io and a float32 bias, P rounded to
// bf16 once: K4's attention in 64-token steps from a ring of staged slots,
// and K3's LN + projections + attention in one launch), the
// counter-based hash
// that draws the attention-dropout mask, and SKConv's three forward kernels
// (the two products on the tensor cores; weights, residual and output
// float32 or bf16).
//
// The build hash of every csrc/*.cu covers this header (ops/kernels.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace {

// Host-side count of the kernels this library's launchers (this header's,
// window_train_common.cuh's, window_attention_full.cu's) have launched: one
// added where each launches.  K3's and K5's libraries export it, so that a
// caller counts one call's launches without a profiler.
unsigned long long kernel_launches = 0;

// Loads and stores of the attention's io type, computing in float32 (for
// float the plain loads and stores): one element, two adjacent ones, a
// head's row of HD values (8, 16 or 32; as 16-byte pieces where `vec`), and
// 4 adjacent values.
__device__ __forceinline__ float ldg_one(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_one(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ float2 ldg_pair(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }
__device__ __forceinline__ float2 ldg_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
template <int HD>
__device__ __forceinline__ void load_row(float (&x)[HD], const float* p, int vec) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + c);
      x[4 * c] = t.x, x[4 * c + 1] = t.y, x[4 * c + 2] = t.z, x[4 * c + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) x[d] = __ldg(p + d);
  }
}
template <int HD>
__device__ __forceinline__ void load_row(float (&x)[HD], const __nv_bfloat16* p, int vec) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
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
    for (int d = 0; d < HD; ++d) x[d] = __bfloat162float(p[d]);
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
template <typename T, int HD>
__device__ __forceinline__ void store_row(T* p, const float (&x)[HD], int vec) {
#pragma unroll
  for (int c = 0; c < HD / 4; ++c) store4(p + 4 * c, make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]), vec);
}

// A value of the io type as float32 and back (round to nearest even), and
// two adjacent values (4- or 8-byte aligned) read and written as a pair.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float& d, float x) { d = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float x) { d = __float2bfloat16_rn(x); }
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ void st2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
// x rounded to bf16 (nearest even) and widened back: a cast to the bf16 io
// dtype where the JAX kernel makes one.
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }


constexpr int TOK = 64;      // tokens per tile of the token-tile kernels
constexpr int THREADS = 256;  // 8 warps
constexpr int LNP_WARPS = 12;  // ln_proj: warps 0-3 own the q columns, 4-11 the kv columns
constexpr int LNP_THREADS = 32 * LNP_WARPS;

// The n8-tiles of output columns of the D-wide products (D a multiple of 16
// up to 96): each warp of a column group owns NT = ceil(D / 32) tiles from
// its first column n0; where D is not a multiple of 32 (16, 48, 80) the
// warps near the end of the columns [.., end) own fewer, or none.
template <int D>
__host__ __device__ constexpr int col_tiles() {
  return (D + 31) / 32;
}
template <int D>
__device__ __forceinline__ int tiles_below(int n0, int end) {
  return D % 32 == 0 ? col_tiles<D>() : max(0, min(col_tiles<D>(), (end - n0) / 8));
}

// Stage a weight W (rows x k, row-major in global memory, float32 or bf16)
// into shared memory as float32 [rows][ld] (ld = k + 4: conflict-free B
// fragments of mma_tile); a bf16 value widens exactly.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ w, int rows, int k, int ld) {
  for (int idx = threadIdx.x; idx < rows * k; idx += blockDim.x) dst[(idx / k) * ld + idx % k] = ldg_one(w + idx);
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
// (dpmn_tpu/ops/pallas_window.py:191-202), stored in the tile's type (a
// bf16 tile holds the result rounded to bf16, as the JAX kernel casts it
// back to its io dtype).  The R rows' reductions run side by side; each
// row's sums keep the order of one row alone.
template <int R, typename T>
__device__ __forceinline__ void ln_rows_inplace(T* tile, int ld, int r0, int step, int nrows, int c,
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
      v[r][m] = row < nrows && k < c ? to_f(tile[row * ld + k]) : 0.f;
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
      if (row < nrows && k < c) from_f(tile[row * ld + k], (v[r][m] - mean) * rstd * s[m] + b[m]);
    }
  }
}

// The LN of one row of a bf16 tile (c channels, a multiple of 8 up to 96)
// in place by a quad of lanes, lane % 4 taking the 8-channel chunks lane % 4,
// + 4, + 8 as 16-byte pieces; `valid` false for a row past the tile's end
// (the quad still joins the shuffles).  float32 statistics, summed in chunk
// order within a lane and then over the quad, var = E[x^2] - mean^2 clamped
// at 0, eps 1e-6, * s + b (bf16 vectors of c, 16-byte aligned), the result
// rounded to bf16.  A warp normalizes 8 rows at once, so a row's reductions
// and divisions are shared by 4 lanes where ln_rows_inplace spends a warp on
// them: about a third of its instructions a row.  The bf16 forwards of the
// training cores (window_block_fwd_bf16_kernel, ln_proj_bf16_kernel<D, bf16>
// for the backwards' recompute of q and kv) normalize with it, so the two
// agree bit for bit.
__device__ __forceinline__ void ln_row_quad(__nv_bfloat16* row, bool valid, int c, const __nv_bfloat16* __restrict__ s,
                                            const __nv_bfloat16* __restrict__ b) {
  const int q4 = threadIdx.x & 3, nch = c / 8;
  float v[3][8];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int ch = q4 + 4 * j;
    if (valid && ch < nch) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + 8 * ch);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 f = __bfloat1622float2(h[m]);
        v[j][2 * m] = f.x, v[j][2 * m + 1] = f.y;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sum += v[j][e];
        sq += v[j][e] * v[j][e];
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float mean = sum / c;
  const float var = fmaxf(sq / c - mean * mean, 0.f);
  const float rstd = 1.0f / sqrtf(var + 1e-6f);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int ch = q4 + 4 * j;
    if (valid && ch < nch) {
      const uint4 su = __ldg(reinterpret_cast<const uint4*>(s + 8 * ch));
      const uint4 bu = __ldg(reinterpret_cast<const uint4*>(b + 8 * ch));
      const __nv_bfloat162* sh = reinterpret_cast<const __nv_bfloat162*>(&su);
      const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&bu);
      uint4 o;
      uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 sf = __bfloat1622float2(sh[m]), bf = __bfloat1622float2(bh[m]);
        const __nv_bfloat162 r = __floats2bfloat162_rn((v[j][2 * m] - mean) * rstd * sf.x + bf.x,
                                                       (v[j][2 * m + 1] - mean) * rstd * sf.y + bf.y);
        op[m] = *reinterpret_cast<const uint32_t*>(&r);
      }
      *reinterpret_cast<uint4*>(row + 8 * ch) = o;
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
// which are q columns for w < 4 and kv columns after (D = 16, 48, 80: the
// ceil(D/32) tiles from column 8 ceil(D/32) w of q, or of kv for warp w + 4,
// cut at the end of the columns: col_tiles).  Shared: w [3D][D + 4], xs [2
// stages][2 streams][TOK][D + 4].
template <int D>
__global__ void __launch_bounds__(LNP_THREADS, 1)
    ln_proj_kernel(const float* __restrict__ xq, const float* __restrict__ xkv, const float* __restrict__ qs,
                   const float* __restrict__ qb, const float* __restrict__ ks, const float* __restrict__ kb,
                   const float* __restrict__ qw, const float* __restrict__ qbias, const float* __restrict__ kvw,
                   const float* __restrict__ kvbias, float* __restrict__ qout, float* __restrict__ kvout, int ntok,
                   int do_ln) {
  constexpr int S = D + 4, NT = col_tiles<D>();
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
  // the warp's first column of the 3D outputs, and its n-tiles
  const int n0 = D % 32 == 0 || is_q ? warp * NT * 8 : D + (warp - 4) * NT * 8;
  const int nt = tiles_below<D>(n0, is_q ? D : 3 * D);
  float bias[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = n0 + 8 * j + 2 * t4 + e;
      bias[j][e] = j < nt ? (is_q ? qbias[o] : kvbias[o - D]) : 0.f;
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
    mma_tile<false, false, 4, NT>(acc, xt + (is_q ? 0 : TOK * S), S, 0, w, S, n0, D, 4, nt);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t t = (int64_t)tile * TOK + 16 * i + g8 + 8 * h;
        if (t >= ntok) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j >= nt) continue;
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

// bf16 io pieces of the LN + projection kernel: 16 bytes by cp.async (zero
// bytes where not `valid`), the tile of TOK bf16 tokens into shared memory
// [TOK][ld] (c % 8 == 0, rows 16-byte aligned), a bf16 weight's rows into
// shared memory [rows][ld] as they are (k % 8 == 0, w 16-byte aligned).
__device__ __forceinline__ void cp_async16_zfill_bytes(void* smem, const void* gmem, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld, const __nv_bfloat16* __restrict__ x,
                                          int64_t t0, int ntok, int c, int64_t row_stride) {
  const int c8 = c / 8;
  for (int e = threadIdx.x; e < TOK * c8; e += blockDim.x) {
    const int r = e / c8, k = (e % c8) * 8;
    const bool valid = t0 + r < ntok;
    cp_async16_zfill_bytes(dst + r * ld + k, valid ? x + (t0 + r) * row_stride + k : x, valid);
  }
}
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ w, int rows, int k,
                                           int ld) {
  const int k8 = k / 8;
  for (int e = threadIdx.x; e < rows * k8; e += blockDim.x) {
    const int r = e / k8, c = (e % k8) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) = __ldg(reinterpret_cast<const uint4*>(w + (int64_t)r * k + c));
  }
}

// ln_proj_kernel for bf16 io (the JAX kernel on bf16 inputs,
// dpmn_tpu/ops/pallas_window.py:191-202, :291): the LN in float32 and its
// result rounded to bf16 in place, then q = xq_n Wq^T + bq and kv = xkv_n
// Wkv^T + bkv on bf16 m16n8k16 mma.sync with float32 accumulation (one
// pass: products of bf16 values are exact in float32), the bf16 biases
// added in float32; q and kv are written as OT: float32 for K1's attention,
// bf16 (rounded, as dpmn_tpu/ops/pallas_window_train.py:370-375 casts them
// to its io dtype) for K3's bf16 form.  The
// same persistent CTAs, two-stage cp.async tiles and warp layout as
// ln_proj_kernel; the operands reach the tensor cores by ldmatrix, weight
// and token rows at D + 8 elements (an odd number of 16 bytes: the eight
// rows of every ldmatrix phase fall on disjoint bank groups).  Shared: w
// [3D][D + 8], xs [2 stages][2 streams][TOK][D + 8], all bf16.
template <int D, typename OT = float>
__global__ void __launch_bounds__(LNP_THREADS, 1)
    ln_proj_bf16_kernel(const __nv_bfloat16* __restrict__ xq, const __nv_bfloat16* __restrict__ xkv,
                        const __nv_bfloat16* __restrict__ qs, const __nv_bfloat16* __restrict__ qb,
                        const __nv_bfloat16* __restrict__ ks, const __nv_bfloat16* __restrict__ kb,
                        const __nv_bfloat16* __restrict__ qw, const __nv_bfloat16* __restrict__ qbias,
                        const __nv_bfloat16* __restrict__ kvw, const __nv_bfloat16* __restrict__ kvbias,
                        OT* __restrict__ qout, OT* __restrict__ kvout, int ntok, int do_ln) {
  constexpr int S = D + 8, NT = col_tiles<D>();
  extern __shared__ __align__(16) unsigned char lnp_smem[];
  __nv_bfloat16* w = reinterpret_cast<__nv_bfloat16*>(lnp_smem);
  __nv_bfloat16* xs = w + 3 * D * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int r8 = lane & 7, hi8 = (lane >> 3) & 1, quad = lane >> 4;
  const int ntile = (ntok + TOK - 1) / TOK;
  auto load = [&](int tile, int stage) {
    __nv_bfloat16* dst = xs + stage * 2 * TOK * S;
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
    lsq[m] = on ? to_f(qs[k]) : 0.f;
    lbq[m] = on ? to_f(qb[k]) : 0.f;
    lsk[m] = on ? to_f(ks[k]) : 0.f;
    lbk[m] = on ? to_f(kb[k]) : 0.f;
  }
  const bool is_q = warp < 4;
  // the warp's first column of the 3D outputs, and its n-tiles
  const int n0 = D % 32 == 0 || is_q ? warp * NT * 8 : D + (warp - 4) * NT * 8;
  const int nt = tiles_below<D>(n0, is_q ? D : 3 * D);
  float bias[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = n0 + 8 * j + 2 * t4 + e;
      bias[j][e] = j < nt ? to_f(is_q ? qbias[o] : kvbias[o - D]) : 0.f;
    }
  int stage = 0;
  for (int tile = blockIdx.x; tile < ntile; tile += gridDim.x, stage ^= 1) {
    const int next = tile + gridDim.x;
    if (next < ntile) load(next, stage ^ 1);
    cp_async_wait(next < ntile ? 1 : 0);
    __syncthreads();  // this tile's rows (and, the first time, w) are in shared memory
    __nv_bfloat16* xt = xs + stage * 2 * TOK * S;
    if (do_ln) {
      if constexpr (sizeof(OT) == 2) {  // groups of 8 rows (both streams) warp, warp + 12, ..., a row a quad
        for (int p = warp; p < 2 * TOK / 8; p += LNP_WARPS) {
          const int st = p >= TOK / 8, r = (p % (TOK / 8)) * 8 + (lane >> 2);
          ln_row_quad(xt + (st * TOK + r) * S, (int64_t)tile * TOK + r < ntok, D, st ? ks : qs, st ? kb : qb);
        }
      } else {  // rows warp, warp + 12, ... of each stream
        ln_rows_inplace<(TOK + LNP_WARPS - 1) / LNP_WARPS>(xt, S, warp, LNP_WARPS, TOK, D, lsq, lbq);
        ln_rows_inplace<(TOK + LNP_WARPS - 1) / LNP_WARPS>(xt + TOK * S, S, warp, LNP_WARPS, TOK, D, lsk, lbk);
      }
      __syncthreads();
    }
    const __nv_bfloat16* A = xt + (is_q ? 0 : TOK * S);
    float acc[4][NT][4];
    zero_acc(acc);
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t bf[NT][2];  // the n8 tiles' B fragments: weight rows n0 + 8 j .., columns k0 .. k0 + 15
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if (j + 1 < nt) {
          uint32_t r[4];
          ldmatrix_x4(r, w + (n0 + 8 * j + r8 + 8 * quad) * S + k0 + 8 * hi8);
          bf[j][0] = r[0], bf[j][1] = r[1], bf[j + 1][0] = r[2], bf[j + 1][1] = r[3];
        } else if (j < nt) {
          uint32_t r[2];
          ldmatrix_x2(r, w + (n0 + 8 * j + r8) * S + k0 + 8 * hi8);
          bf[j][0] = r[0], bf[j][1] = r[1];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t a[4];  // token rows 16 i .. + 15 x columns k0 .. k0 + 15
        ldmatrix_x4(a, A + (16 * i + r8 + 8 * hi8) * S + k0 + 8 * quad);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j < nt) mma_bf16(acc[i][j], a, bf[j][0], bf[j][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t t = (int64_t)tile * TOK + 16 * i + g8 + 8 * h;
        if (t >= ntok) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j >= nt) continue;
          const int o = n0 + 8 * j + 2 * t4;
          const float2 val = make_float2(acc[i][j][2 * h] + bias[j][0], acc[i][j][2 * h + 1] + bias[j][1]);
          if (is_q)
            st2(qout + t * D + o, val);
          else
            st2(kvout + t * 2 * D + o - D, val);
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

// hash_step(h, j) in two parts, the same bits for 0 <= j < 2^15: fmix32's
// first step x ^ (x >> 16) distributes over the xor of h and v = j +
// 0x9e3779b9, and v >> 16 is 0x9e37 for such j, so hash_row(h) takes the
// row's share once and hash_step_row the rest, four integer operations an
// entry fewer.
__device__ __forceinline__ uint32_t hash_row(uint32_t h) { return h ^ (h >> 16) ^ 0x9e37u; }
__device__ __forceinline__ uint32_t hash_step_row(uint32_t hr, uint32_t j) {
  uint32_t x = hr ^ (j + 0x9e3779b9u);
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  return x ^ (x >> 16);
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

// The shift mask is read under a test of the group's shift (sh > 0, a
// kernel argument), never of the mask pointer: an unshifted group's pointer
// is null, and a test of a pointer that is null or mask + offset (`p = sh >
// 0 ? mask + off : nullptr; if (p) ...`) was taken on unshifted blocks in
// some instances of nvcc's -O3 machine code, which then read near address 0
// (CUDA error 700; ROADMAP §3).  Every forward and backward attention kernel
// tests the shift; a pointer formed from a null mask is never tested or read.

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
// its shared slots, in elements of the io type (attn_tile.cuh), for a group
// of ch = gh HD channels: ch + 8 (8 mod 16), or ch + 16 where ch is an odd
// multiple of 8 (head dim 8).
__host__ __device__ inline int fwd_windows_a_step(int n, int gh) {
  const int tiles = gh * (n / 16);
  return tiles >= 8 ? 1 : 8 / tiles;
}
template <int HD>
__host__ __device__ inline int fwd_ldq(int ch) {
  return HD % 16 == 0 || ch % 16 == 0 ? ch + 8 : ch + 16;
}
template <typename T, int HD>
__host__ __device__ inline int fwd_ldv(int ch) {
  return sizeof(T) == 4 ? ch + 4 : fwd_ldq<HD>(ch);
}

// One channel group of an attention-forward launch: its window and shift,
// its tables and the first of its units in the launch's work list.
template <typename T, typename BT = T>
struct AttnGroup {
  const BT* bias;     // (gh, N, N)
  const float* mask;  // (nW, N, N) where sh > 0
  int g, ws, sh, unit0;
};
constexpr int MAX_ATTN_GROUPS = 6;  // the windows of a block (the JAX package's paths give 1 to 3)

// The arguments of one attention-forward launch (a __grid_constant__
// kernel parameter).  grp holds the groups in work-list order: 8x8, then
// 4x4, then 2x2 windows.
template <typename T, typename BT = T, typename OT = T>
struct AttnArgs {
  const T* q;
  const T* k;
  const T* v;
  OT* out;
  int kvs, B, H, W, D, gh, corrected, vec;
  float scale, inv_keep;
  uint32_t seed, thresh;
  int n_group, n_units, buf_elems;
  AttnGroup<T, BT> grp[MAX_ATTN_GROUPS];
};

// A 2x2-window unit on the CUDA cores: a thread per (window, head, query
// row), THREADS rows a unit; its q row and the window's k and v rows read as
// 16-byte pieces (the 4 threads of a window and head share them through
// L1), the 4 scores, softmax, dropout and the HD outputs in registers.
template <bool DROP, int HD, typename T, typename BT, typename OT>
__device__ __forceinline__ void attn_unit4(const AttnArgs<T, BT, OT>& a, const AttnGroup<T, BT>& gr, int unit) {
  const int ch = a.gh * HD, L = a.H * a.W;
  const int nwc = a.W / 2, nw = (a.H / 2) * nwc;
  const int t = unit * THREADS + threadIdx.x;
  if (t >= a.B * nw * a.gh * 4) return;
  const int i = t & 3, hd = (t >> 2) % a.gh, u = t / (4 * a.gh);
  const int b = u / nw, widx = u - b * nw;
  const int64_t base = (int64_t)b * L;
  const int col = gr.g * ch + hd * HD;
  int tok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) tok[j] = window_token_c<2>(widx, j, nwc, gr.sh, a.H, a.W);
  float qv[HD], s[4];
  load_row(qv, a.q + (base + tok[i]) * a.D + col, a.vec);
  const BT* brow = gr.bias + (hd * 4 + i) * 4;
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float kv[HD];
    load_row(kv, a.k + (base + tok[j]) * a.kvs + col, a.vec);
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc = fmaf(qv[d], kv[d], acc);
    acc = acc * a.scale + ldg_one(brow + j);
    if (gr.sh > 0) acc += __ldg(gr.mask + ((int64_t)widx * 4 + i) * 4 + j);
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
  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float p = s[j] * inv;
    if (DROP) p = (hash_step(rkey, j) & 0x7fffffffu) < a.thresh ? p * a.inv_keep : 0.f;
    float vv[HD];
    load_row(vv, a.v + (base + tok[j]) * a.kvs + col, a.vec);
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = fmaf(p, vv[d], o[d]);
  }
  store_row(a.out + (base + (a.corrected ? tok[i] : widx * 4 + i)) * a.D + col, o, a.vec);
}

// Stage step `step` of a 4x4 (N = 16) or 8x8 (N = 64) group, its wps
// windows' q, k, v rows, into the shared slots at dst as one committed
// cp.async group: 16-byte pieces (cp.async) where `vec`, else elements; a
// thread takes (row, piece) pairs, the same piece of q, k, v.  Slot
// (elements of T): q, k [N][ldq], v [N][ldv].
template <int N, int HD, typename T, typename BT, typename OT>
__device__ __forceinline__ void attn_stage(const AttnArgs<T, BT, OT>& a, const AttnGroup<T, BT>& gr, int step,
                                           T* dst0) {
  constexpr int WS = N == 16 ? 4 : 8;
  const int ch = a.gh * HD, L = a.H * a.W;
  const int nwc = a.W / WS, nw = (a.H / WS) * nwc, units = a.B * nw;
  const int wps = fwd_windows_a_step(N, a.gh), ldq = fwd_ldq<HD>(ch), ldv = fwd_ldv<T, HD>(ch);
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
// lane pair swaps halves so that each lane holds 4 adjacent columns of a
// 16-column pair of tiles; at head dim 8, 2 columns a lane).
template <int N, bool DROP, int HD, typename T, typename BT, typename OT>
__device__ __forceinline__ void attn_step_tc(const AttnArgs<T, BT, OT>& a, const AttnGroup<T, BT>& gr, int step,
                                             const T* sb) {
  constexpr int WS = N == 16 ? 4 : 8, MT = N / 16, NT = N / 8, CT = HD / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int ch = a.gh * HD, L = a.H * a.W;
  const int nwc = a.W / WS, nw = (a.H / WS) * nwc, units = a.B * nw;
  const int tasks = a.gh * MT, wps = fwd_windows_a_step(N, a.gh);
  const int ldq = fwd_ldq<HD>(ch), ldv = fwd_ldv<T, HD>(ch), slot = N * (2 * ldq + ldv);
  for (int task = warp; task < wps * tasks; task += THREADS / 32) {
    const int lw = task / tasks, hd = (task % tasks) / MT, mi = task % MT;
    const int u = step * wps + lw;
    if (u >= units) continue;
    const int b = u / nw, widx = u - b * nw;
    const T* Qs = sb + lw * slot;
    float s[NT][4] = {};
    if constexpr (sizeof(T) == 2)
      qk_tile_bf16<NT, false, HD>(s, Qs + 16 * mi * ldq + hd * HD, ldq, Qs + N * ldq + hd * HD, ldq);
    else
      qk_tile<NT>(s, Qs + 16 * mi * ldq + hd * HD, ldq, Qs + N * ldq + hd * HD, ldq, HD);
    const BT* bh = gr.bias + hd * N * N;
    const float* mw = gr.sh > 0 ? gr.mask + (int64_t)widx * N * N : nullptr;
    const int i0 = 16 * mi + g8;
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (i0 + 8 * r) * N + 8 * jn + 2 * t4;
        float2 add = ldg_pair(bh + off);
        if (gr.sh > 0) {
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
    float o[CT][4] = {};
    if constexpr (sizeof(T) == 2)
      pv_tile_bf16<NT, false, HD>(o, s, Qs + 2 * N * ldq + hd * HD, ldv);
    else
      pv_tile<NT, CT>(o, s, Qs + 2 * N * ldq + hd * HD, ldv);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      const int row = a.corrected ? window_token_c<WS>(widx, i, nwc, gr.sh, a.H, a.W) : widx * N + i;
      OT* orow = a.out + ((int64_t)b * L + row) * a.D + gr.g * ch + hd * HD;
      if constexpr (HD == 8) {  // lane t4 holds columns 2 t4, 2 t4 + 1
        OT* p = orow + 2 * t4;
        if (a.vec) {
          st2(p, make_float2(o[0][2 * r], o[0][2 * r + 1]));
        } else {
          from_f(p[0], o[0][2 * r]);
          from_f(p[1], o[0][2 * r + 1]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < CT; c += 2) {
          // lane t4 holds columns 2 t4, 2 t4 + 1 of tiles c and c + 1;
          // after the swap an even lane holds columns 2 t4 .. 2 t4 + 3 of
          // tile c, an odd lane columns 2 t4 + 6 .. 2 t4 + 9 (tile c + 1)
          const bool odd = t4 & 1;
          const float sx = odd ? o[c][2 * r] : o[c + 1][2 * r], sy = odd ? o[c][2 * r + 1] : o[c + 1][2 * r + 1];
          const float rx = __shfl_xor_sync(0xffffffffu, sx, 1), ry = __shfl_xor_sync(0xffffffffu, sy, 1);
          const float4 val = odd ? make_float4(rx, ry, o[c + 1][2 * r], o[c + 1][2 * r + 1])
                                 : make_float4(o[c][2 * r], o[c][2 * r + 1], rx, ry);
          store4(orow + 8 * c + (odd ? 2 * t4 + 6 : 2 * t4), val, a.vec);
        }
      }
    }
  }
}

template <int HD, typename T, typename BT, typename OT>
__device__ __forceinline__ void attn_stage_any(const AttnArgs<T, BT, OT>& a, const AttnGroup<T, BT>& gr, int unit,
                                               T* dst) {
  if (gr.ws == 8)
    attn_stage<64, HD>(a, gr, unit - gr.unit0, dst);
  else
    attn_stage<16, HD>(a, gr, unit - gr.unit0, dst);
}

// The windowed attention forward of every channel group in one launch: K1's
// and K7's, and the float32 forms' of K3, K4 and K5 (their bf16 forms run
// the training cores' bf16 forward below).  q rows have stride D; k and v rows
// stride kvs (2D where they are the halves of one kv buffer, D where they
// are tensors of their own).  Per (image b, window widx) and head of group
// g: the -sh roll (window_token), S = scale q k^T + bias [+ mask], P =
// softmax(S), with DROP P times the dropout mask (kept entries by
// inv_keep), and P v, written to raw row widx N + i (faithful) or to the
// query's token row (corrected).  T is the io type of q, k, v (float32, or
// bf16 for K7's bf16), BT the bias's and OT out's, T in every instance; the
// mask is float32 and every sum runs in float32.  `vec`: q, k, v and out are 16-byte aligned, so rows move in
// 16-byte pieces; otherwise element by element (the same arithmetic).
//
// Persistent CTAs of 8 warps walk one work list of units, blockIdx.x, +
// gridDim.x, ...: first the steps of the 8x8 groups, then of the 4x4 groups
// (a step is `wps` consecutive windows whose q, k, v rows, the group's ch =
// HD gh channels of each token, land in a shared slot by cp.async while the
// previous step is computed, two buffers of buf_elems), then the 2x2 units
// on the CUDA cores, which need no shared memory and fill the tails.  The
// dispatch is per unit, so the groups share one launch and one tail.  At
// least 2 CTAs an SM in float32 (up to 128 registers a thread), 3 in K7's
// bf16 (up to 80, no spill; faster than 2 on an H100 SXM, where 4 spill:
// tools/attention_groups.py `ctas2`), 2 at head dims 8 and 32 (K7's bf16
// spills at 80 there).  HD: the
// head dim, 8, 16 or 32.
template <bool DROP, typename T, typename BT = T, typename OT = T, int HD = 16>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 && sizeof(BT) == 2 && HD == 16 ? 3 : 2)
    window_attn_fwd_kernel(const __grid_constant__ AttnArgs<T, BT, OT> a) {
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
    if (a.grp[s].ws != 2) attn_stage_any<HD>(a, a.grp[s], blockIdx.x, sm);
  }
  for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
    const AttnGroup<T, BT>& gr = a.grp[s];
    const int next = u + gridDim.x;
    const int sn = next < a.n_units ? group_of(next) : s;
    if (gr.ws == 2) {  // the rest of this CTA's units are 2x2 units too
      attn_unit4<DROP, HD>(a, gr, u - gr.unit0);
    } else {
      const bool ahead = next < a.n_units && a.grp[sn].ws != 2;
      if (ahead) attn_stage_any<HD>(a, a.grp[sn], next, sm + (buf ^ 1) * a.buf_elems);
      cp_async_wait(ahead ? 1 : 0);
      __syncthreads();  // this step's rows are in shared memory
      if (gr.ws == 8)
        attn_step_tc<64, DROP, HD>(a, gr, u - gr.unit0, sm + buf * a.buf_elems);
      else
        attn_step_tc<16, DROP, HD>(a, gr, u - gr.unit0, sm + buf * a.buf_elems);
      __syncthreads();  // every warp is done with this buffer before it is refilled
      buf ^= 1;
    }
    s = sn;
  }
}

// launch_attn at head dim HD.
template <bool DROP, int HD, typename T, typename BT, typename OT>
cudaError_t launch_attn_hd(const T* q, const T* k, const T* v, int kvs, const BT* const* biases,
                           const float* const* masks, OT* out, int B, int H, int W, int D, int n_group,
                           const int* ws, const int* shifts, int gh, float scale, int corrected, uint32_t seed,
                           uint32_t thresh, float inv_keep, cudaStream_t st) {
  AttnArgs<T, BT, OT> a;
  a.q = q, a.k = k, a.v = v, a.out = out;
  a.kvs = kvs, a.B = B, a.H = H, a.W = W, a.D = D, a.gh = gh, a.corrected = corrected;
  a.vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
  a.scale = scale;
  a.inv_keep = inv_keep, a.seed = seed, a.thresh = thresh;
  const int ch = gh * HD;
  int n = 0, units = 0, buf_elems = 0;
  const int order[3] = {8, 4, 2};
  for (const int want : order)
    for (int g = 0; g < n_group; ++g) {
      if (ws[g] != want) continue;
      if (H % want || W % want) return cudaErrorInvalidValue;
      const int nw = (H / want) * (W / want), nn = want * want;
      a.grp[n++] = AttnGroup<T, BT>{biases[g], shifts[g] > 0 ? masks[g] : nullptr, g, want, shifts[g], units};
      if (want == 2) {
        units += (B * nw * gh * 4 + THREADS - 1) / THREADS;
      } else {
        const int wps = fwd_windows_a_step(nn, gh), slot = wps * nn * (2 * fwd_ldq<HD>(ch) + fwd_ldv<T, HD>(ch));
        units += (B * nw + wps - 1) / wps;
        buf_elems = buf_elems > slot ? buf_elems : slot;
      }
    }
  if (n != n_group) return cudaErrorInvalidValue;  // a window other than 2, 4 or 8
  a.n_group = n, a.n_units = units, a.buf_elems = buf_elems;
  const size_t smem = (size_t)2 * buf_elems * sizeof(T);
  auto kern = window_attn_fwd_kernel<DROP, T, BT, OT, HD>;
  static GridCap cache;
  int cap = 0;
  const cudaError_t err = persistent_cap(cache, kern, THREADS, smem, &cap);
  if (err != cudaSuccess) return err;
  const int grid = units < cap ? units : cap;
  if (grid == 0) return cudaSuccess;
  ++kernel_launches;
  kern<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// The head dim of a block's groups: D / n_group channels a group over gh
// heads; 8, 16 or 32 (else 0).
inline int head_dim(int D, int n_group, int gh) {
  if (n_group < 1 || gh < 1 || D % n_group != 0 || (D / n_group) % gh != 0) return 0;
  const int hd = D / n_group / gh;
  return hd == 8 || hd == 16 || hd == 32 ? hd : 0;
}

// Launch the forward attention of every group, one launch: biases[g] and
// masks[g] are group g's tables (masks[g] read only where shifts[g] > 0).
// Windows of 2, 4 or 8 dividing H and W, at most MAX_ATTN_GROUPS groups of
// D / n_group channels, gh heads of 8, 16 or 32 channels each.
template <bool DROP, typename T, typename BT = T, typename OT = T>
cudaError_t launch_attn(const T* q, const T* k, const T* v, int kvs, const BT* const* biases,
                        const float* const* masks, OT* out, int B, int H, int W, int D, int n_group, const int* ws,
                        const int* shifts, int gh, float scale, int corrected, uint32_t seed, uint32_t thresh,
                        float inv_keep, cudaStream_t st) {
  if (n_group < 1 || n_group > MAX_ATTN_GROUPS) return cudaErrorInvalidValue;
  switch (head_dim(D, n_group, gh)) {
    case 8: return launch_attn_hd<DROP, 8>(q, k, v, kvs, biases, masks, out, B, H, W, D, n_group, ws, shifts, gh, scale, corrected, seed, thresh, inv_keep, st);
    case 16: return launch_attn_hd<DROP, 16>(q, k, v, kvs, biases, masks, out, B, H, W, D, n_group, ws, shifts, gh, scale, corrected, seed, thresh, inv_keep, st);
    case 32: return launch_attn_hd<DROP, 32>(q, k, v, kvs, biases, masks, out, B, H, W, D, n_group, ws, shifts, gh, scale, corrected, seed, thresh, inv_keep, st);
    default: return cudaErrorInvalidValue;
  }
}

// launch_attn on the per-group tables concatenated (masks of shifted groups
// only).
template <bool DROP, typename T, typename BT, typename OT>
cudaError_t launch_attn_groups(const T* q, const T* k, const T* v, int kvs, const BT* bias, const float* mask,
                               OT* out, int B, int H, int W, int D, int n_group, const int* ws, const int* shifts,
                               int gh, float scale, int corrected, uint32_t seed, uint32_t thresh, float inv_keep,
                               cudaStream_t st) {
  if (n_group < 1 || n_group > MAX_ATTN_GROUPS) return cudaErrorInvalidValue;
  const BT* biases[MAX_ATTN_GROUPS];
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
template <typename T, typename BT, typename OT>
inline cudaError_t launch_attn_groups_any(const T* q, const T* k, const T* v, int kvs, const BT* bias,
                                          const float* mask, OT* out, int B, int H, int W, int D, int n_group,
                                          const int* ws, const int* shifts, int gh, float scale, int corrected,
                                          uint32_t seed, uint32_t thresh, float inv_keep, int drop,
                                          cudaStream_t st) {
  return drop ? launch_attn_groups<true>(q, k, v, kvs, bias, mask, out, B, H, W, D, n_group, ws, shifts, gh, scale,
                                         corrected, seed, thresh, inv_keep, st)
              : launch_attn_groups<false>(q, k, v, kvs, bias, mask, out, B, H, W, D, n_group, ws, shifts, gh, scale,
                                          corrected, seed, thresh, inv_keep, st);
}

// ------------------------------------------- the training cores' bf16 forward
//
// K3, K4 and K5 on bf16 io with a float32 bias (the JAX kernel's rounding
// points, dpmn_tpu/ops/pallas_window_train.py:301-316: q times the scale
// rounded to bf16, the product rounded; scores, softmax and dropout in
// float32; P rounded to bf16 once before P V, as :316 casts it) run their
// attention forward in steps of STEP = 64 tokens of one channel group of
// one image: one 8x8 window, four 4x4 windows or sixteen 2x2 windows, in
// window order (step row r = window r / N, position r % N).  A
// step's q, k and v land in a shared slot [3][STEP][ldq] (ldq = fwd_ldq).
// Its 4x4 and 8x8 windows run as 4 gh tasks (gh heads x 4 m16-tiles of
// query rows) on bf16 m16n8k16, the tables read straight into the score
// registers (the mask only where the group is shifted); its 2x2 windows on
// the CUDA cores, a lane pair per (head, query row) reading the slot.  The
// dropout draw takes fmix32's first step once a row (hash_row).
//
// What bounds it (PERF.md §6, tools/attention_groups.py --train): not the
// loads (a step's staging alone runs at the bytes' bound) but each step's
// chain of products, table reads, softmax and the draw's integer work, a
// task a warp between two barriers.
//
// Two producers fill the slot:
//  * window_attn_fwd_train_kernel (K4's forward, the attention of K5's
//    form on projected q, k, v): the step's rows of q, k, v by cp.async into
//    one of TRAIN_STAGES slots, the next step's landing while one is
//    computed;
//  * window_block_fwd_bf16_kernel (K3's forward, K5's front): the step's
//    xq and xkv rows, all D channels, by cp.async; the LN in float32
//    rounded to bf16 in place (ln_row_quad, as ln_proj_bf16_kernel<D, bf16>);
//    the group's q, k and v slices projected on bf16 m16n8k16 (k-steps in
//    ln_proj_bf16_kernel's order, its bias added in float32 and the sum
//    rounded to bf16) straight into the slot.  q and kv never reach device
//    memory; each q / k / v value is the same dot product of the same bf16
//    values as ln_proj_bf16_kernel<D, bf16>'s, so the fused output equals
//    that kernel + window_attn_fwd_train_kernel bit for bit.
// Both walk one work list on persistent CTAs, group-major (train_unit): on an
// H100 at B = 64 the fused kernel ran 7-9 % faster than image-major (every
// group's steps of image b before image b + 1; PERF.md §6), which keeps the
// groups' re-reads of an image's rows closer in time; at the flagship the
// whole of xq and xkv (25 MB) fits the 50 MB L2 either way.

constexpr int STEP = 64;         // tokens a step (THREADS / 4: a quad of threads gathers a row)
constexpr int TRAIN_STAGES = 2;  // the slots of window_attn_fwd_train_kernel's ring
static_assert(STEP * 4 == THREADS, "a quad of threads stages each row of a step");

// One channel group of a training forward: its tables, window and shift.
struct TrainGroup {
  const float* bias;  // (gh, N, N)
  const float* mask;  // (nW, N, N), read only where sh > 0
  int ws, sh;
};

// The arguments of one training-forward launch (a __grid_constant__
// parameter): q, k, v for the attention-only kernel (rows of stride D for
// q, kvs for k and v), xq ... kvbias for the fused one; grp in group order.
template <typename OT>
struct TrainFwdArgs {
  const __nv_bfloat16 *q, *k, *v;
  const __nv_bfloat16 *xq, *xkv, *qs, *qb, *ks, *kb, *qw, *qbias, *kvw, *kvbias;
  OT* out;
  int kvs, B, H, W, D, gh, n_group, vec, ldq, n_units;
  float scale, inv_keep;
  uint32_t seed, thresh;
  TrainGroup grp[MAX_ATTN_GROUPS];
};

// A unit of the work list: image b, group g, the step's first window w0.
// The list is group-major (every image's steps of group g before group g +
// 1), so that a CTA's consecutive units run one window size's code.
struct TrainUnit {
  int b, g, w0;
};
template <typename OT>
__device__ __forceinline__ TrainUnit train_unit(const TrainFwdArgs<OT>& a, int u) {
  const int spi = a.H * a.W / STEP, per_group = a.B * spi;
  const int g = u / per_group, r = u - g * per_group, b = r / spi;
  const int ws = a.grp[g].ws;
  return TrainUnit{b, g, (r - b * spi) * (STEP / (ws * ws))};
}

// The token (raster index within the image) of step row r.
__device__ __forceinline__ int step_token(int ws, int w0, int r, int sh, int H, int W) {
  if (ws == 8) return window_token_c<8>(w0 + r / 64, r % 64, W / 8, sh, H, W);
  if (ws == 4) return window_token_c<4>(w0 + r / 16, r % 16, W / 4, sh, H, W);
  return window_token_c<2>(w0 + r / 4, r % 4, W / 2, sh, H, W);
}

// HH adjacent bf16 values in shared memory (8-byte aligned, HH a multiple of
// 4) as float32.
template <int HH>
__device__ __forceinline__ void smem_row(float (&x)[HH], const __nv_bfloat16* p) {
#pragma unroll
  for (int c = 0; c < HH / 4; ++c) {
    const uint2 u = *reinterpret_cast<const uint2*>(p + 4 * c);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    x[4 * c] = lo.x, x[4 * c + 1] = lo.y, x[4 * c + 2] = hi.x, x[4 * c + 3] = hi.y;
  }
}

// A 4x4 or 8x8 step of the training forward on the slot's q, k, v (rows
// STEP apart, stride ldq), on the tensor cores: warp w takes tasks w, w + 8,
// ... of the 4 gh (head, m-tile) tasks; K and V of an 8x8 step are all 64
// rows, of a 4x4 step the task's own window's 16.  The tables are read
// straight into the score registers (the mask where the group is shifted).
template <int WS, bool DROP, int HD, typename OT>
__device__ __forceinline__ void train_step(const TrainFwdArgs<OT>& a, const TrainUnit& t, const __nv_bfloat16* slot) {
  constexpr int N = WS * WS, NT = N / 8, CT = HD / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const TrainGroup& gr = a.grp[t.g];
  const int ch = a.gh * HD, ldq = a.ldq;
  const int64_t base = (int64_t)t.b * a.H * a.W;
  for (int task = warp; task < 4 * a.gh; task += THREADS / 32) {
    const int hd = task >> 2, mi = task & 3;
    const int k0 = N == 64 ? 0 : 16 * mi;  // the task's first key row
    float s[NT][4] = {};
    qk_tile_bf16<NT, true, HD>(s, slot + 16 * mi * ldq + hd * HD, ldq, slot + (STEP + k0) * ldq + hd * HD, ldq,
                               a.scale);
    int widx[2], qi[2];  // window and position of query rows g8, g8 + 8 of the tile
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * mi + g8 + 8 * r;
      widx[r] = t.w0 + row / N;
      qi[r] = row % N;
    }
    const float* bh = gr.bias + hd * N * N;
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = qi[r] * N + 8 * jn + 2 * t4;  // the lane's keys 2 t4, 2 t4 + 1 of key tile jn
        float2 add = ldg_pair(bh + off);  // the head's bias, then where shifted the window's mask
        if (gr.sh > 0) {
          const float2 mm = __ldg(reinterpret_cast<const float2*>(gr.mask + (int64_t)widx[r] * N * N + off));
          add.x += mm.x;
          add.y += mm.y;
        }
        s[jn][2 * r] += add.x;
        s[jn][2 * r + 1] += add.y;
      }
    softmax_rows<true, NT>(s);
    if (DROP) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t hr = hash_row(dropout_row_key(a.seed, t.b, t.g, hd, widx[r], qi[r]));
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& p = s[jn][2 * r + e];
            p = (hash_step_row(hr, 8 * jn + 2 * t4 + e) & 0x7fffffffu) < a.thresh ? p * a.inv_keep : 0.f;
          }
      }
    }
    float o[CT][4] = {};
    pv_tile_bf16<NT, true, HD>(o, s, slot + (2 * STEP + k0) * ldq + hd * HD, ldq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the faithful raw layout: row widx N + i
      OT* orow = a.out + (base + widx[r] * N + qi[r]) * a.D + t.g * ch + hd * HD;
      if constexpr (HD == 8) {  // lane t4 holds columns 2 t4, 2 t4 + 1
        OT* p = orow + 2 * t4;
        if (a.vec) {
          st2(p, make_float2(o[0][2 * r], o[0][2 * r + 1]));
        } else {
          from_f(p[0], o[0][2 * r]);
          from_f(p[1], o[0][2 * r + 1]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < CT; c += 2) {  // the lane-pair swap of attn_step_tc: 4 adjacent columns a lane
          const bool odd = t4 & 1;
          const float sx = odd ? o[c][2 * r] : o[c + 1][2 * r], sy = odd ? o[c][2 * r + 1] : o[c + 1][2 * r + 1];
          const float rx = __shfl_xor_sync(0xffffffffu, sx, 1), ry = __shfl_xor_sync(0xffffffffu, sy, 1);
          const float4 val = odd ? make_float4(rx, ry, o[c + 1][2 * r], o[c + 1][2 * r + 1])
                                 : make_float4(o[c][2 * r], o[c][2 * r + 1], rx, ry);
          store4(orow + 8 * c + 2 * t4 + (odd ? 6 : 0), val, a.vec);
        }
      }
    }
  }
}

// A 2x2 step (16 windows) on the CUDA cores: a lane pair per (head, query
// row) of the slot, each lane half of the head's channels (HH = HD / 2): its
// half of the q row scaled as the tensor-core steps scale it, its half of
// the window's 4 k rows (the pair's partial scores summed by one shuffle)
// and of the 4 v rows read from shared memory, the softmax and dropout of
// the 4 scores in both lanes, and its HH outputs.
template <bool DROP, int HD, typename OT>
__device__ __forceinline__ void train_step4(const TrainFwdArgs<OT>& a, const TrainUnit& t,
                                            const __nv_bfloat16* slot) {
  constexpr int HH = HD / 2;
  const TrainGroup& gr = a.grp[t.g];
  const int ch = a.gh * HD, ldq = a.ldq;
  const int64_t base = (int64_t)t.b * a.H * a.W;
  for (int item = threadIdx.x; item < 2 * STEP * a.gh; item += THREADS) {  // whole pairs: 2 STEP gh is even
    const int half = item & 1, hd = item / (2 * STEP), r = (item >> 1) - hd * STEP, i = r & 3, r0 = r - i;
    const int widx = t.w0 + r / 4, col = hd * HD + half * HH;
    float qv[HH], sc[4];
    smem_row<HH>(qv, slot + r * ldq + col);
#pragma unroll
    for (int d = 0; d < HH; ++d) qv[d] = round_bf16(qv[d] * a.scale);
    const float* brow = gr.bias + (hd * 4 + i) * 4;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float kv[HH];
      smem_row<HH>(kv, slot + (STEP + r0 + j) * ldq + col);
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HH; ++d) acc = fmaf(qv[d], kv[d], acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);  // the pair's halves, in lane order
      acc += __ldg(brow + j);
      if (gr.sh > 0) acc += __ldg(gr.mask + ((int64_t)widx * 4 + i) * 4 + j);  // the window's mask
      sc[j] = acc;
      mx = fmaxf(mx, acc);
    }
    float den = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[j] = __expf(sc[j] - mx);
      den += sc[j];
    }
    const float inv = 1.0f / den;
    const uint32_t hr = DROP ? hash_row(dropout_row_key(a.seed, t.b, t.g, hd, widx, i)) : 0u;
    float o[HH];
#pragma unroll
    for (int d = 0; d < HH; ++d) o[d] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p = sc[j] * inv;
      if (DROP) p = (hash_step_row(hr, j) & 0x7fffffffu) < a.thresh ? p * a.inv_keep : 0.f;
      p = round_bf16(p);
      float vv[HH];
      smem_row<HH>(vv, slot + (2 * STEP + r0 + j) * ldq + col);
#pragma unroll
      for (int d = 0; d < HH; ++d) o[d] = fmaf(p, vv[d], o[d]);
    }
    store_row(a.out + (base + widx * 4 + i) * a.D + t.g * ch + col, o, a.vec);  // raw row widx 4 + i
  }
}

// train_step at the unit's window size.
template <bool DROP, int HD, typename OT>
__device__ __forceinline__ void train_step_any(const TrainFwdArgs<OT>& a, const TrainUnit& t,
                                               const __nv_bfloat16* slot) {
  const int ws = a.grp[t.g].ws;
  if (ws == 8)
    train_step<8, DROP, HD>(a, t, slot);
  else if (ws == 4)
    train_step<4, DROP, HD>(a, t, slot);
  else
    train_step4<DROP, HD>(a, t, slot);
}

// Stage unit u's q, k, v rows (the group's ch channels of each of the step's
// tokens) into a slot: 16-byte pieces by cp.async where `vec`, else element
// by element.
template <typename OT>
__device__ __forceinline__ void train_stage(const TrainFwdArgs<OT>& a, int u, int ch, __nv_bfloat16* slot) {
  const TrainUnit t = train_unit(a, u);
  const TrainGroup& gr = a.grp[t.g];
  const int64_t base = (int64_t)t.b * a.H * a.W;
  const int col = t.g * ch, ldq = a.ldq, per = a.vec ? ch / 8 : ch, each = a.vec ? 8 : 1;
  for (int e = threadIdx.x; e < STEP * per; e += THREADS) {
    const int r = e / per, c = (e - r * per) * each;
    const int64_t tok = base + step_token(gr.ws, t.w0, r, gr.sh, a.H, a.W);
    const __nv_bfloat16* qs = a.q + tok * a.D + col + c;
    const __nv_bfloat16* ks = a.k + tok * a.kvs + col + c;
    const __nv_bfloat16* vs = a.v + tok * a.kvs + col + c;
    __nv_bfloat16* dst = slot + r * ldq + c;
    if (a.vec) {
      cp_async16_bytes(dst, qs);
      cp_async16_bytes(dst + STEP * ldq, ks);
      cp_async16_bytes(dst + 2 * STEP * ldq, vs);
    } else {
      dst[0] = qs[0];
      dst[STEP * ldq] = ks[0];
      dst[2 * STEP * ldq] = vs[0];
    }
  }
}

// The attention forward of the training cores on bf16 io (K4's forward),
// every group in one launch: persistent CTAs of 8 warps walk the work list
// blockIdx.x, + gridDim.x, ..., each step staged TRAIN_STAGES - 1 steps
// ahead into a ring of slots.  Shared: TRAIN_STAGES x [3][STEP][ldq] bf16.
template <bool DROP, typename OT, int HD>
__global__ void __launch_bounds__(THREADS, 2)
    window_attn_fwd_train_kernel(const __grid_constant__ TrainFwdArgs<OT> a) {
  extern __shared__ __align__(16) unsigned char train_smem[];
  const int ch = a.gh * HD;
  auto slot = [&](int k) { return reinterpret_cast<__nv_bfloat16*>(train_smem) + k * 3 * STEP * a.ldq; };
  auto stage = [&](int u, int k) {
    if (u < a.n_units) train_stage(a, u, ch, slot(k));
    cp_async_commit();  // one group a step, empty past the end: the wait counts steps
  };
#pragma unroll
  for (int k = 0; k < TRAIN_STAGES - 1; ++k) stage(blockIdx.x + k * gridDim.x, k);
  int k = 0;
  for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
    stage(u + (TRAIN_STAGES - 1) * gridDim.x, k == 0 ? TRAIN_STAGES - 1 : k - 1);  // the slot computed last
    cp_async_wait(TRAIN_STAGES - 1);
    __syncthreads();  // this step's rows are in shared memory
    train_step_any<DROP, HD>(a, train_unit(a, u), slot(k));
    __syncthreads();  // every warp is done with this slot before it is refilled
    k = k + 1 == TRAIN_STAGES ? 0 : k + 1;
  }
}

// K3's bf16 forward (and K5's front) in one launch: LN + the q / kv
// projections + the attention, q and kv kept in shared memory.  Each CTA
// stages [Wq; Wkv] (3D x D) once; a unit's xq and xkv rows land by cp.async
// while the previous unit's attention runs.  Warp w projects the n8-tiles
// w, w + 8, ... of the group's 3 ch output columns (q, then k, then v) over
// the 4 m16-tiles of the step, two tiles at a time.  Shared: w [3D][D + 8],
// xs [2][STEP][D + 8], slot [3][STEP][ldq], all bf16 (102 KB at D = 96: 2
// CTAs an SM, up to 128 registers; at head dim 32 one CTA an SM, whose
// registers hold the wider rows without spilling).
template <bool DROP, typename OT, int HD>
__global__ void __launch_bounds__(THREADS, HD == 32 ? 1 : 2)
    window_block_fwd_bf16_kernel(const __grid_constant__ TrainFwdArgs<OT> a) {
  extern __shared__ __align__(16) unsigned char block_smem[];
  const int D = a.D, S = D + 8, ch = a.gh * HD, ldq = a.ldq;
  __nv_bfloat16* w = reinterpret_cast<__nv_bfloat16*>(block_smem);
  __nv_bfloat16* xs = w + 3 * D * S;
  __nv_bfloat16* slot = xs + 2 * STEP * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int r8 = lane & 7, hi8 = (lane >> 3) & 1, quad = lane >> 4;
  auto gather = [&](int u) {  // unit u's xq and xkv rows, all D channels
    const TrainUnit t = train_unit(a, u);
    const TrainGroup& gr = a.grp[t.g];
    const int r = threadIdx.x >> 2;  // a row's D / 8 pieces by a quad (THREADS / 4 = STEP rows)
    const int64_t tok = (int64_t)t.b * a.H * a.W + step_token(gr.ws, t.w0, r, gr.sh, a.H, a.W);
    for (int c = 8 * (threadIdx.x & 3); c < D; c += 32) {
      cp_async16_bytes(xs + r * S + c, a.xq + tok * D + c);
      cp_async16_bytes(xs + (STEP + r) * S + c, a.xkv + tok * D + c);
    }
  };
  if (blockIdx.x < a.n_units) gather(blockIdx.x);
  cp_async_commit();
  stage_rows(w, a.qw, D, D, S);
  stage_rows(w + D * S, a.kvw, 2 * D, D, S);
  const int nct = ch / 8, ntot = 3 * nct;  // n8-tiles a stream, and of q, k, v together
  for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
    const TrainUnit t = train_unit(a, u);
    cp_async_wait(0);
    __syncthreads();  // the unit's rows (the first time, the weights) are in shared memory; the slot is free
    for (int p = warp; p < 2 * STEP / 8; p += THREADS / 32) {  // groups of 8 rows of both streams, a row a quad
      const int st = p >= STEP / 8, r = (p % (STEP / 8)) * 8 + (lane >> 2);
      ln_row_quad(xs + (st * STEP + r) * S, true, D, st ? a.ks : a.qs, st ? a.kb : a.qb);
    }
    __syncthreads();
    for (int j0 = warp; j0 < ntot; j0 += 16) {
      const bool two = j0 + 8 < ntot;
      int st[2], cs[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int j = j0 + 8 * p;
        st[p] = j / nct;  // 0 q, 1 k, 2 v
        cs[p] = (j - st[p] * nct) * 8;
      }
      const __nv_bfloat16* A0 = xs + (st[0] ? STEP * S : 0);
      const __nv_bfloat16* A1 = xs + (st[1] ? STEP * S : 0);
      const __nv_bfloat16* W0 = w + (st[0] * D + t.g * ch + cs[0] + r8) * S + 8 * hi8;
      const __nv_bfloat16* W1 = w + (st[1] * D + t.g * ch + cs[1] + r8) * S + 8 * hi8;
      float acc[4][2][4];
      zero_acc(acc);
      for (int k0 = 0; k0 < D; k0 += 16) {  // ln_proj_bf16_kernel's k-steps
        uint32_t b0[2], b1[2] = {0u, 0u};
        ldmatrix_x2(b0, W0 + k0);
        if (two) ldmatrix_x2(b1, W1 + k0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t a0[4];
          ldmatrix_x4(a0, A0 + (16 * i + r8 + 8 * hi8) * S + k0 + 8 * quad);
          mma_bf16(acc[i][0], a0, b0[0], b0[1]);
          if (two) {
            if (A1 != A0) ldmatrix_x4(a0, A1 + (16 * i + r8 + 8 * hi8) * S + k0 + 8 * quad);
            mma_bf16(acc[i][1], a0, b1[0], b1[1]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (p == 1 && !two) continue;
        const int o = t.g * ch + cs[p] + 2 * t4;  // the output column within its stream
        const __nv_bfloat16* bsrc = st[p] ? a.kvbias + (st[p] - 1) * D + o : a.qbias + o;
        const float bx = to_f(bsrc[0]), by = to_f(bsrc[1]);
        __nv_bfloat16* dst = slot + st[p] * STEP * ldq + cs[p] + 2 * t4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<__nv_bfloat162*>(dst + (16 * i + g8 + 8 * h) * ldq) =
                __floats2bfloat162_rn(acc[i][p][2 * h] + bx, acc[i][p][2 * h + 1] + by);
      }
    }
    __syncthreads();  // the slot holds the step's q, k, v; xs is free
    if (u + gridDim.x < a.n_units) gather(u + gridDim.x);
    cp_async_commit();
    train_step_any<DROP, HD>(a, t, slot);
  }
}

// Launch a training forward of every group (FUSED: window_block_fwd_bf16
// on a.xq ...; else window_attn_fwd_train on a.q, a.k, a.v), the args' grp,
// scale and dropout fields set by the caller.  L = H W a multiple of STEP,
// 1 to MAX_ATTN_GROUPS groups of windows 2, 4 or 8 dividing H and W, a
// head dim of 8, 16 or 32.
template <bool FUSED, bool DROP, int HD, typename OT>
cudaError_t launch_train_fwd_hd(TrainFwdArgs<OT>& a, cudaStream_t st) {
  const int ch = a.gh * HD;
  a.ldq = fwd_ldq<HD>(ch);
  const size_t slot = (size_t)3 * STEP * a.ldq * sizeof(__nv_bfloat16);
  const size_t smem = FUSED ? (size_t)(3 * a.D + 2 * STEP) * (a.D + 8) * sizeof(__nv_bfloat16) + slot
                            : TRAIN_STAGES * slot;
  void (*kern)(TrainFwdArgs<OT>);
  if constexpr (FUSED)
    kern = window_block_fwd_bf16_kernel<DROP, OT, HD>;
  else
    kern = window_attn_fwd_train_kernel<DROP, OT, HD>;
  static GridCap cache;
  int cap = 0;
  const cudaError_t err = persistent_cap(cache, kern, THREADS, smem, &cap);
  if (err != cudaSuccess) return err;
  const int grid = a.n_units < cap ? a.n_units : cap;
  if (grid == 0) return cudaSuccess;
  ++kernel_launches;
  kern<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// Fill a's geometry, tables and dropout fields and launch (see
// launch_train_fwd_hd); biases[g], masks[g] are group g's tables (masks[g]
// read only where shifts[g] > 0).
template <bool FUSED, typename OT>
cudaError_t launch_train_fwd(TrainFwdArgs<OT>& a, const float* const* biases,
                             const float* const* masks, int B, int H, int W, int D, int n_group, const int* ws,
                             const int* shifts, int gh, float scale, uint32_t seed, uint32_t thresh, float inv_keep,
                             int drop, cudaStream_t st) {
  if (n_group < 1 || n_group > MAX_ATTN_GROUPS || (H * W) % STEP) return cudaErrorInvalidValue;
  a.B = B, a.H = H, a.W = W, a.D = D, a.gh = gh, a.n_group = n_group;
  a.scale = __bfloat162float(__float2bfloat16_rn(scale));
  a.inv_keep = inv_keep, a.seed = seed, a.thresh = thresh;
  for (int g = 0; g < n_group; ++g) {
    if ((ws[g] != 2 && ws[g] != 4 && ws[g] != 8) || H % ws[g] || W % ws[g]) return cudaErrorInvalidValue;
    a.grp[g] = TrainGroup{biases[g], shifts[g] > 0 ? masks[g] : nullptr, ws[g], shifts[g]};
  }
  a.n_units = B * n_group * (H * W / STEP);
  const int hd = head_dim(D, n_group, gh);
  switch (hd * 2 + (drop ? 1 : 0)) {
    case 16: return launch_train_fwd_hd<FUSED, false, 8>(a, st);
    case 17: return launch_train_fwd_hd<FUSED, true, 8>(a, st);
    case 32: return launch_train_fwd_hd<FUSED, false, 16>(a, st);
    case 33: return launch_train_fwd_hd<FUSED, true, 16>(a, st);
    case 64: return launch_train_fwd_hd<FUSED, false, 32>(a, st);
    case 65: return launch_train_fwd_hd<FUSED, true, 32>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// The attention forward of the training cores on bf16 q, k, v (q and out
// rows of stride D, k and v of stride kvs, a multiple of 8), one launch.
template <typename OT>
cudaError_t launch_train_attn(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, int kvs,
                              const float* const* biases, const float* const* masks, OT* out, int B, int H, int W,
                              int D, int n_group, const int* ws, const int* shifts, int gh, float scale,
                              uint32_t seed, uint32_t thresh, float inv_keep, int drop, cudaStream_t st) {
  TrainFwdArgs<OT> a = {};
  a.q = q, a.k = k, a.v = v, a.out = out, a.kvs = kvs;
  a.vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) && kvs % 8 == 0;
  return launch_train_fwd<false>(a, biases, masks, B, H, W, D, n_group, ws, shifts, gh, scale, seed, thresh,
                          inv_keep, drop, st);
}

// K3's bf16 forward in one launch: LN (scales qs, ks, biases qb, kb) + the
// projections (q_w (D, D), kv_w (2D, D) in torch Linear layout) + the
// attention, out (B, L, D) of OT (bf16, or float32 for K5's tokens).  xq,
// xkv, q_w and kv_w 16-byte aligned; D a multiple of 16 up to 96.
template <typename OT>
cudaError_t launch_block_fwd_bf16(const __nv_bfloat16* xq, const __nv_bfloat16* xkv, const __nv_bfloat16* qs,
                                  const __nv_bfloat16* qb, const __nv_bfloat16* ks, const __nv_bfloat16* kb,
                                  const __nv_bfloat16* q_w, const __nv_bfloat16* q_b, const __nv_bfloat16* kv_w,
                                  const __nv_bfloat16* kv_b, const float* const* biases, const float* const* masks,
                                  OT* out, int B, int H, int W, int D, int n_group, const int* ws, const int* shifts,
                                  int gh, float scale, uint32_t seed, uint32_t thresh, float inv_keep, int drop,
                                  cudaStream_t st) {
  if (!aligned16(xq) || !aligned16(xkv) || !aligned16(q_w) || !aligned16(kv_w) || !aligned16(qs) || !aligned16(qb) ||
      !aligned16(ks) || !aligned16(kb))
    return cudaErrorMisalignedAddress;
  if (D % 16 || D < 16 || D > 96) return cudaErrorInvalidValue;
  TrainFwdArgs<OT> a = {};
  a.xq = xq, a.xkv = xkv, a.qs = qs, a.qb = qb, a.ks = ks, a.kb = kb, a.qw = q_w, a.qbias = q_b, a.kvw = kv_w,
  a.kvbias = kv_b, a.out = out;
  a.vec = aligned16(out);
  return launch_train_fwd<true>(a, biases, masks, B, H, W, D, n_group, ws, shifts, gh, scale, seed, thresh, inv_keep,
                          drop, st);
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
  ++kernel_launches;
  ln_proj_kernel<D><<<grid, LNP_THREADS, smem, st>>>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf,
                                                     ntok, do_ln);
  return cudaGetLastError();
}

// LN (when do_ln) + the q / kv projections of ntok tokens: qbuf (ntok, D),
// kvbuf (ntok, 2D).  D a multiple of 16 up to 96; xq and xkv 16-byte
// aligned.
inline cudaError_t launch_ln_proj(const float* xq, const float* xkv, const float* qs, const float* qb,
                                  const float* ks, const float* kb, const float* q_w, const float* q_b,
                                  const float* kv_w, const float* kv_b, float* qbuf, float* kvbuf, int ntok,
                                  int D, int do_ln, cudaStream_t st) {
  if (!aligned16(xq) || !aligned16(xkv)) return cudaErrorMisalignedAddress;
  switch (D) {
    case 16: return launch_ln_proj_d<16>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, do_ln, st);
    case 32: return launch_ln_proj_d<32>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, do_ln, st);
    case 48: return launch_ln_proj_d<48>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, do_ln, st);
    case 64: return launch_ln_proj_d<64>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, do_ln, st);
    case 80: return launch_ln_proj_d<80>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, do_ln, st);
    case 96: return launch_ln_proj_d<96>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, do_ln, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int D, typename OT>
cudaError_t launch_ln_proj_bf16_d(const __nv_bfloat16* xq, const __nv_bfloat16* xkv, const __nv_bfloat16* qs,
                                  const __nv_bfloat16* qb, const __nv_bfloat16* ks, const __nv_bfloat16* kb,
                                  const __nv_bfloat16* q_w, const __nv_bfloat16* q_b, const __nv_bfloat16* kv_w,
                                  const __nv_bfloat16* kv_b, OT* qbuf, OT* kvbuf, int ntok, int do_ln,
                                  cudaStream_t st) {
  const size_t smem = (size_t)(3 * D + 4 * TOK) * (D + 8) * sizeof(__nv_bfloat16);
  cudaError_t err =
      cudaFuncSetAttribute(ln_proj_bf16_kernel<D, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int grid = 0;
  if (err != cudaSuccess || (err = persistent_grid((ntok + TOK - 1) / TOK, &grid)) != cudaSuccess) return err;
  if (grid == 0) return cudaSuccess;
  ++kernel_launches;
  ln_proj_bf16_kernel<D, OT><<<grid, LNP_THREADS, smem, st>>>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf,
                                                              kvbuf, ntok, do_ln);
  return cudaGetLastError();
}

// launch_ln_proj for bf16 io: q and kv come out as OT, float32 (K1) or
// bf16 (K3).  D a multiple of 16 up to 96; xq, xkv, q_w and kv_w 16-byte
// aligned.
template <typename OT>
inline cudaError_t launch_ln_proj(const __nv_bfloat16* xq, const __nv_bfloat16* xkv, const __nv_bfloat16* qs,
                                  const __nv_bfloat16* qb, const __nv_bfloat16* ks, const __nv_bfloat16* kb,
                                  const __nv_bfloat16* q_w, const __nv_bfloat16* q_b, const __nv_bfloat16* kv_w,
                                  const __nv_bfloat16* kv_b, OT* qbuf, OT* kvbuf, int ntok, int D, int do_ln,
                                  cudaStream_t st) {
  if (!aligned16(xq) || !aligned16(xkv) || !aligned16(q_w) || !aligned16(kv_w)) return cudaErrorMisalignedAddress;
  if (sizeof(OT) == 2 && do_ln && (!aligned16(qs) || !aligned16(qb) || !aligned16(ks) || !aligned16(kb)))
    return cudaErrorMisalignedAddress;  // ln_row_quad's 16-byte parameter pieces
  switch (D) {
    case 16: return launch_ln_proj_bf16_d<16>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, do_ln, st);
    case 32: return launch_ln_proj_bf16_d<32>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, do_ln, st);
    case 48: return launch_ln_proj_bf16_d<48>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, do_ln, st);
    case 64: return launch_ln_proj_bf16_d<64>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, do_ln, st);
    case 80: return launch_ln_proj_bf16_d<80>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, do_ln, st);
    case 96: return launch_ln_proj_bf16_d<96>(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, do_ln, st);
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
// D/32 n-tiles of output columns [(w % 4) D/4, (w % 4 + 1) D/4) (D = 16,
// 48, 80: NT = ceil(D/32) tiles from column (w % 4) 8 NT, cut at D,
// tiles_below).
struct TileWarp {
  int mg, m0, n0, g8, t4;
  template <int NT>
  __device__ static TileWarp make() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return TileWarp{warp >> 2, 32 * (warp >> 2), (warp & 3) * NT * 8, lane >> 2, lane & 3};
  }
};

// (c1) feats = attn Wp^T + bp, and per-tile sums of gelu(feats), on
// persistent CTAs: Wp staged once (T = bf16: widened to float32), attn
// tiles by cp.async (two stages), the product on the tensor cores
// (mma_tile, 3xTF32; for T = bf16 two passes, the widened weight being
// exact in TF32).  A tile's sum is fixed in
// order: each thread's 4 rows, a shuffle tree over the 8 row groups of a
// warp, then the two m-groups.  Shared: w [D][D + 4], xs [2][TOK][D + 4],
// red [2][D].
template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
    skconv_proj_kernel(const float* __restrict__ attn, const T* __restrict__ pw, const T* __restrict__ pb,
                       float* __restrict__ feats, float* __restrict__ partial, int ntile) {
  constexpr int S = D + 4, NT = col_tiles<D>();
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
  const int nt = tiles_below<D>(tw.n0, D);
  float bias[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[j][e] = j < nt ? to_f(pb[tw.n0 + 8 * j + 2 * tw.t4 + e]) : 0.f;
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
    mma_tile<false, false, 2, NT, sizeof(T) == 2>(acc, xs + stage * TOK * S, S, tw.m0, w, S, tw.n0, D, 2, nt);
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
          if (j >= nt) continue;
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
        if (tw.g8 == 0 && j < nt) red[tw.mg * D + tw.n0 + 8 * j + 2 * tw.t4 + e] = gs[j][e];
      }
    __syncthreads();
    for (int o = threadIdx.x; o < D; o += blockDim.x) partial[(int64_t)tile * D + o] = red[o] + red[D + o];
  }
}

// SKConv's gate of image b, computed by the whole block: s = the GAP from
// the per-tile partial sums (a fixed-order sum), u = fc1 s + b1, z = gelu(u),
// a = fc2 z + b2, then the softmax over the groups of a, in place (so a
// holds the gate w); weights of type T (float32 or bf16), sums in float32.
// Shared: s [D], u [dz], z [dz], a [n_group * ch].
template <typename T>
__device__ void skconv_gate_block(const float* __restrict__ partial, const T* __restrict__ f1w,
                                  const T* __restrict__ f1b, const T* __restrict__ f2w, const T* __restrict__ f2b,
                                  float* s, float* u, float* z, float* a, int b, int L, int D, int dz, int n_group,
                                  int ch) {
  const int ntile = L / TOK;
  for (int o = threadIdx.x; o < D; o += blockDim.x) {
    float acc = 0.f;
    for (int tl = 0; tl < ntile; ++tl) acc += partial[((int64_t)b * ntile + tl) * D + o];
    s[o] = acc / L;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < dz; k += blockDim.x) {
    float acc = to_f(f1b[k]);
    for (int o = 0; o < D; ++o) acc = fmaf(s[o], to_f(f1w[k * D + o]), acc);
    u[k] = acc;
    z[k] = gelu_erf(acc);
  }
  __syncthreads();
  for (int m = threadIdx.x; m < n_group * ch; m += blockDim.x) {
    float acc = to_f(f2b[m]);
    for (int k = 0; k < dz; ++k) acc = fmaf(z[k], to_f(f2w[m * dz + k]), acc);
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
template <typename T>
__global__ void skconv_gate_kernel(const float* __restrict__ partial, const T* __restrict__ f1w,
                                   const T* __restrict__ f1b, const T* __restrict__ f2w, const T* __restrict__ f2b,
                                   float* __restrict__ gate, int L, int D, int dz, int n_group, int ch) {
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
// the tensor cores (mma_tile over K = ch; two TF32 passes for T = bf16, as
// in c1).  T is the type of Wph, bph, xkv and out: for bf16 the sum runs in
// float32 and is rounded once on store.
// A tile lies in one image (L % TOK == 0).  Shared: w [D][ch + 4], xs [2][TOK][D + 4], fv [TOK][ch + 4].
template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
    skconv_out_kernel(const float* __restrict__ attn, const float* __restrict__ feats, const float* __restrict__ gate,
                      const T* __restrict__ phw, const T* __restrict__ phb, const T* __restrict__ xkv,
                      T* __restrict__ out, int L, int n_group, int ch, int ntile, int residual) {
  constexpr int S = D + 4, NT = col_tiles<D>();
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
  const int nt = tiles_below<D>(tw.n0, D);
  float bias[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[j][e] = j < nt ? to_f(phb[tw.n0 + 8 * j + 2 * tw.t4 + e]) : 0.f;
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
    mma_tile<false, false, 2, NT, sizeof(T) == 2>(acc, fv, SC, tw.m0, w, SC, tw.n0, ch, 2, nt);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t t = (int64_t)tile * TOK + tw.m0 + 16 * i + tw.g8 + 8 * h;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j >= nt) continue;
          const int64_t off = t * D + tw.n0 + 8 * j + 2 * tw.t4;
          const float2 f = *reinterpret_cast<const float2*>(feats + off);
          float2 sk = make_float2(f.x + (acc[i][j][2 * h] + bias[j][0]), f.y + (acc[i][j][2 * h + 1] + bias[j][1]));
          if (residual) {
            const float2 r = ld2(xkv + off);
            sk = make_float2(r.x + sk.x, r.y + sk.y);
          }
          st2(out + off, sk);
        }
      }
  }
}

template <int D, typename T>
cudaError_t launch_skconv_d(const float* attn, const T* proj_w, const T* proj_b, const T* fc1_w, const T* fc1_b,
                            const T* fc2_w, const T* fc2_b, const T* ph_w, const T* ph_b, const T* xkv,
                            float* feats, float* partial, float* gate, T* out, int B, int L, int n_group, int dz,
                            int residual, cudaStream_t st) {
  const int ntile = B * L / TOK, ch = D / n_group;
  if (ntile == 0) return cudaSuccess;
  const size_t smem_c1 = (size_t)(D * (D + 4) + 2 * TOK * (D + 4) + 2 * D) * sizeof(float);
  const size_t smem_c3 = (size_t)(D * (ch + 4) + 2 * TOK * (D + 4) + TOK * (ch + 4)) * sizeof(float);
  // As many CTAs an SM as its registers and shared memory hold (2 of each
  // at D = 96), so that one CTA's tile loads, products and epilogue overlap
  // another's; one CTA an SM left them waiting on one another (3.3-3.4x the
  // bytes' bound on an H100, bf16 weights)
  static GridCap cap_c1, cap_c3;
  int cap = 0;
  cudaError_t err = persistent_cap(cap_c1, skconv_proj_kernel<D, T>, THREADS, smem_c1, &cap);
  if (err != cudaSuccess) return err;
  const int grid_c1 = ntile < cap ? ntile : cap;
  if ((err = persistent_cap(cap_c3, skconv_out_kernel<D, T>, THREADS, smem_c3, &cap)) != cudaSuccess) return err;
  const int grid_c3 = ntile < cap ? ntile : cap;
  ++kernel_launches;
  skconv_proj_kernel<D, T><<<grid_c1, THREADS, smem_c1, st>>>(attn, proj_w, proj_b, feats, partial, ntile);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem_c2 = (size_t)(D + 2 * dz + n_group * ch) * sizeof(float);
  ++kernel_launches;
  skconv_gate_kernel<T><<<B, 128, smem_c2, st>>>(partial, fc1_w, fc1_b, fc2_w, fc2_b, gate, L, D, dz, n_group, ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++kernel_launches;
  skconv_out_kernel<D, T><<<grid_c3, THREADS, smem_c3, st>>>(attn, feats, gate, ph_w, ph_b, xkv, out, L, n_group,
                                                             ch, ntile, residual);
  return cudaGetLastError();
}

// SKConv after the attention: (c1) feats and the GAP partials, (c2) the
// gate, (c3) out = [xkv +] feats + proj_head(sum_g gate_g * attn_g).  The
// tokens attn are float32; T is the type of the weights, xkv and out.
// Scratch: feats (B, L, D), partial (B, L/64, D), gate (B, n_group, ch).
// D a multiple of 16 up to 96, L % 64 == 0, ch = D / n_group a multiple of
// 8.
template <typename T>
cudaError_t launch_skconv_t(const float* attn, const T* proj_w, const T* proj_b, const T* fc1_w, const T* fc1_b,
                            const T* fc2_w, const T* fc2_b, const T* ph_w, const T* ph_b, const T* xkv,
                            float* feats, float* partial, float* gate, T* out, int B, int L, int D, int n_group,
                            int dz, int residual, cudaStream_t st) {
  if (!aligned16(attn) || (D / n_group) % 8 != 0) return cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_skconv_d<16>(attn, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ph_w, ph_b, xkv, feats, partial, gate, out, B, L, n_group, dz, residual, st);
    case 32: return launch_skconv_d<32>(attn, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ph_w, ph_b, xkv, feats, partial, gate, out, B, L, n_group, dz, residual, st);
    case 48: return launch_skconv_d<48>(attn, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ph_w, ph_b, xkv, feats, partial, gate, out, B, L, n_group, dz, residual, st);
    case 64: return launch_skconv_d<64>(attn, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ph_w, ph_b, xkv, feats, partial, gate, out, B, L, n_group, dz, residual, st);
    case 80: return launch_skconv_d<80>(attn, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ph_w, ph_b, xkv, feats, partial, gate, out, B, L, n_group, dz, residual, st);
    case 96: return launch_skconv_d<96>(attn, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ph_w, ph_b, xkv, feats, partial, gate, out, B, L, n_group, dz, residual, st);
    default: return cudaErrorInvalidValue;
  }
}

// launch_skconv_t on float32 weights, xkv (may be null when residual is 0)
// and out.
inline cudaError_t launch_skconv(const float* attn, const float* proj_w, const float* proj_b, const float* fc1_w,
                                 const float* fc1_b, const float* fc2_w, const float* fc2_b, const float* ph_w,
                                 const float* ph_b, const float* xkv, float* feats, float* partial, float* gate,
                                 float* out, int B, int L, int D, int n_group, int dz, int residual,
                                 cudaStream_t st) {
  return launch_skconv_t<float>(attn, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b, ph_w, ph_b, xkv, feats, partial,
                                gate, out, B, L, D, n_group, dz, residual, st);
}

}  // namespace
