// Attention tiles on the tensor cores, shared by the window-attention
// forward (window_common.cuh window_attn_fwd_kernel: K1, K3, K4, K5, K7) and
// the per-window attention tiles (window_tile_attention.cu, K8).
//
// A warp owns 16 query rows.  float32: S = Q K^T and O = P V run on mma.sync
// m16n8k8 with the 3xTF32 split of tc_common.cuh (hi*hi + hi*lo + lo*hi).
// P never leaves the registers: the accumulator of S holds, per lane (g8 =
// lane / 4, t4 = lane % 4), columns 2 t4 and 2 t4 + 1 of rows g8 and g8 + 8
// of each 8-key tile, and the product with V reads it as its A fragment by
// ordering the keys of each 8-key step as (0, 2, 4, 6, 1, 3, 5, 7): A's
// k-index t4 is key 2 t4, k-index t4 + 4 is key 2 t4 + 1, and V's B fragment
// rows follow.  The contraction of S is ordered the same way within each 8
// channels, so a lane reads its two adjacent channels of a q or k row as one
// 8-byte load.
//
// bf16 (K7's bf16 io): mma.sync m16n8k16 on bf16 operands with float32
// accumulation, fed by ldmatrix.  S over the head's 16 channels is one k16
// step an 8-key tile (products of bf16 values are exact in float32).  The
// S accumulators of 8-key tiles 2 kk and 2 kk + 1 are, element for element,
// the A fragment of P V's k16 step kk, so P stays in registers unpermuted; P
// is float32 after the softmax and goes in as hi = bf16(p) plus lo = bf16(p
// - hi), two products into one accumulator (about 2^-16 of P is lost).
//
// Shared-memory strides that keep the fragment reads free of bank
// conflicts (in elements of the staged type): float32 q and k rows at a
// stride of 8 mod 16 (8-byte reads of rows g8 0-3 of a half warp land on 4 x
// 8 distinct banks), v rows at 4 mod 8 (scalar reads of keys 2 t4 and
// columns g8); bf16 q, k and v rows at ch + 8 elements, an odd number of 16
// bytes (40 elements, 80 bytes, at ch = 32), so the eight 16-byte rows of
// every ldmatrix phase fall on disjoint bank groups.  A staged row is
// 16-byte aligned for cp.async and ldmatrix.
//
// The build hash of every csrc/*.cu covers this header (ops/kernels.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

// 16 bytes by cp.async, any element type
__device__ __forceinline__ void cp_async16_bytes(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem) : "memory");
}

// Two adjacent floats, and one.
__device__ __forceinline__ float2 ld_pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float ld_one(const float* p) { return *p; }

// s[j] += the warp's 16 query rows . keys 8 j + (0..7), j < nt, over kc
// channels (a multiple of 8) at 3xTF32: row r of Q at Q[r * ldq], key n of K
// at K[n * ldk], both in shared memory.
template <int NT>
__device__ __forceinline__ void qk_tile(float (&s)[NT][4], const float* Q, int ldq, const float* K, int ldk, int kc,
                                        int nt = NT) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  for (int k0 = 0; k0 < kc; k0 += 8) {
    const float2 x0 = ld_pair(Q + g8 * ldq + k0 + 2 * t4);
    const float2 x1 = ld_pair(Q + (g8 + 8) * ldq + k0 + 2 * t4);
    uint32_t ah[4], al[4];
    split_tf32_fast(x0.x, ah[0], al[0]);
    split_tf32_fast(x1.x, ah[1], al[1]);
    split_tf32_fast(x0.y, ah[2], al[2]);
    split_tf32_fast(x1.y, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const float2 y = ld_pair(K + (8 * j + g8) * ldk + k0 + 2 * t4);
        uint32_t bh[2], bl[2];
        split_tf32_fast(y.x, bh[0], bl[0]);
        split_tf32_fast(y.y, bh[1], bl[1]);
        mma_3xtf32(s[j], ah, al, bh, bl);
      }
    }
  }
}

// o[c] += P . V at 3xTF32 for the warp's 16 rows and output columns 8 c +
// (0..7), c < ct: p in the accumulator layout of qk_tile over NT x 8 keys
// (float32, split), key n of V at V[n * ldv] in shared memory.
template <int NT, int CT>
__device__ __forceinline__ void pv_tile(float (&o)[CT][4], const float (&p)[NT][4], const float* V, int ldv,
                                        int ct = CT) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kb = 0; kb < NT; ++kb) {
    uint32_t ah[4], al[4];
    split_tf32_fast(p[kb][0], ah[0], al[0]);  // (row g8, key 2 t4): k-index t4
    split_tf32_fast(p[kb][2], ah[1], al[1]);  // (row g8 + 8, key 2 t4)
    split_tf32_fast(p[kb][1], ah[2], al[2]);  // (row g8, key 2 t4 + 1): k-index t4 + 4
    split_tf32_fast(p[kb][3], ah[3], al[3]);
    const float* v0 = V + (8 * kb + 2 * t4) * ldv + g8;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      if (c < ct) {
        uint32_t bh[2], bl[2];
        split_tf32_fast(ld_one(v0 + 8 * c), bh[0], bl[0]);
        split_tf32_fast(ld_one(v0 + ldv + 8 * c), bh[1], bl[1]);
        mma_3xtf32(o[c], ah, al, bh, bl);
      }
    }
  }
}

// ldmatrix of four 8x8 bf16 matrices from shared memory (lane l gives the
// address of row l % 8 of matrix l / 8), plain or transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b on bf16 operands, float32 accumulation (m16n8k16; the fragment
// coordinates of tc_common.cuh's m16n8k8 with each register holding two
// adjacent k-indices: a0 (g8, 2 t4..+1), a1 (g8 + 8, ..), a2 (g8, 2 t4 +
// 8..+9), a3 (g8 + 8, ..); b0 (k 2 t4..+1, n g8), b1 (k 2 t4 + 8..+9, n g8)).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) = hi + lo as two bf16 pairs: hi rounded to nearest, lo the
// remainder rounded (x in the low half).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// s[j] += the warp's 16 query rows . keys 8 j + (0..7) over one head's 16
// channels, bf16 in shared memory: row r of Q at Q[r * ldq], key n of K at
// K[n * ldk] (ld* an odd number of 16-byte units).  NT even.
template <int NT>
__device__ __forceinline__ void qk_tile_bf16(float (&s)[NT][4], const __nv_bfloat16* Q, int ldq,
                                             const __nv_bfloat16* K, int ldk) {
  const int lane = threadIdx.x & 31, r8 = lane & 7, hi8 = (lane >> 3) & 1, quad = lane >> 4;
  uint32_t a[4];  // rows 0-7 / 8-15 x channels 0-7 / 8-15
  ldmatrix_x4(a, Q + (r8 + 8 * hi8) * ldq + 8 * quad);
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t b[4];  // keys 8 j .. + 7 x channels 0-7, 8-15, then keys 8 j + 8 .. + 15
    ldmatrix_x4(b, K + (8 * j + r8 + 8 * quad) * ldk + 8 * hi8);
    mma_bf16(s[j], a, b[0], b[1]);
    mma_bf16(s[j + 1], a, b[2], b[3]);
  }
}

// o[c] += P . V for the warp's 16 rows and one head's output columns 8 c +
// (0..7), c < 2: p in qk_tile_bf16's accumulator layout over NT x 8 keys
// (float32, split into bf16 hi + lo), key n of V at V[n * ldv] in shared
// memory (bf16, read transposed).
template <int NT>
__device__ __forceinline__ void pv_tile_bf16(float (&o)[2][4], const float (&p)[NT][4], const __nv_bfloat16* V,
                                             int ldv) {
  const int lane = threadIdx.x & 31, r8 = lane & 7, hi8 = (lane >> 3) & 1, quad = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);          // row g8, keys 2 t4, 2 t4 + 1
    split_bf16(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);          // row g8 + 8
    split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);  // row g8, keys 8 + 2 t4, ..
    split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
    uint32_t b[4];  // keys 0-7 / 8-15 of the step x columns 0-7, then 8-15
    ldmatrix_x4_trans(b, V + (16 * kk + r8 + 8 * hi8) * ldv + 8 * quad);
    mma_bf16(o[0], lo, b[0], b[1]);
    mma_bf16(o[1], lo, b[2], b[3]);
    mma_bf16(o[0], hi, b[0], b[1]);
    mma_bf16(o[1], hi, b[2], b[3]);
  }
}

// The max and the sum over the 4 lanes of a quad (one row of a tile).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// s (scores in the accumulator layout, rows g8 and g8 + 8) := the row
// softmax, in place, with one reciprocal a row.  Each row needs one finite
// entry.  FAST: exp by the hardware's ex2.approx (__expf, about 2^-21
// relative at the scores' range), for the 1e-4 gates; else expf, for K8's
// 1e-5.
template <bool FAST, int NT>
__device__ __forceinline__ void softmax_rows(float (&s)[NT][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mx = quad_max(mx);
    float den = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[j][e] = FAST ? __expf(s[j][e] - mx) : expf(s[j][e] - mx);
        den += s[j][e];
      }
    den = quad_sum(den);
    const float inv = 1.0f / den;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][2 * r] *= inv;
      s[j][2 * r + 1] *= inv;
    }
  }
}

// The resident-CTA cap of a persistent kernel: SMs x the CTAs of `threads`
// threads and `smem` bytes of dynamic shared memory an SM holds.  The
// caller's `cache` keeps it per device and size, so launches after the
// first skip the attribute and occupancy queries.
struct GridCap {
  int dev = -1;
  size_t smem = 0;
  int cap = 0;
};
template <typename K>
inline cudaError_t persistent_cap(GridCap& cache, K kern, int threads, size_t smem, int* cap) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cache.dev || smem != cache.smem) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) != cudaSuccess ||
        (err = device_sms(&sms)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)) != cudaSuccess)
      return err;
    cache.dev = dev;
    cache.smem = smem;
    cache.cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  *cap = cache.cap;
  return cudaSuccess;
}

}  // namespace
