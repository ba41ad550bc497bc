// Attention tiles on the tensor cores, shared by the window-attention
// forward (window_common.cuh window_attn_fwd_kernel: K1, K3, K4, K5, K7) and
// the per-window attention tiles (window_tile_attention.cu, K8).
//
// A warp owns 16 query rows.  S = Q K^T and O = P V run on mma.sync
// m16n8k8 with the 3xTF32 split of tc_common.cuh (hi*hi + hi*lo + lo*hi);
// operands that are bf16 values (K7's bf16 io) are exact in TF32, so their
// lo part is zero and its products are skipped (EXACT).  P never leaves the
// registers: the accumulator of S holds, per lane (g8 = lane / 4, t4 = lane
// % 4), columns 2 t4 and 2 t4 + 1 of rows g8 and g8 + 8 of each 8-key tile,
// and the product with V reads it as its A fragment by ordering the keys of
// each 8-key step as (0, 2, 4, 6, 1, 3, 5, 7): A's k-index t4 is key 2 t4,
// k-index t4 + 4 is key 2 t4 + 1, and V's B fragment rows follow.  The
// contraction of S is ordered the same way within each 8 channels, so a
// lane reads its two adjacent channels of a q or k row as one 8-byte load.
//
// Shared-memory strides that keep the fragment reads free of bank
// conflicts (in elements of the staged type): q and k rows at a stride of 8
// mod 16 (8-byte reads of rows g8 0-3 of a half warp land on 4 x 8 distinct
// banks), v rows at 4 mod 8 for float (scalar reads of keys 2 t4 and
// columns g8).  A staged row is 16-byte aligned for cp.async.
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

// Two adjacent elements as float (8 bytes of float, 4 of bf16), and one.
__device__ __forceinline__ float2 ld_pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float ld_one(const float* p) { return *p; }
__device__ __forceinline__ float ld_one(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// The 3xTF32 split of x, or (x, 0) where x is exact in TF32.
template <bool EXACT>
__device__ __forceinline__ void split_op(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    split_tf32_fast(x, hi, lo);
  }
}

// d += a . b, a split, b exact (EXACT) or split: 2 or 3 products.
template <bool EXACT>
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                          const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  if (EXACT) {
    mma_tf32(d, al, bh[0], bh[1]);
    mma_tf32(d, ah, bh[0], bh[1]);
  } else {
    mma_3xtf32(d, ah, al, bh, bl);
  }
}

// s[j] += the warp's 16 query rows . keys 8 j + (0..7), j < nt, over kc
// channels (a multiple of 8): row r of Q at Q[r * ldq], key n of K at
// K[n * ldk], both in shared memory.  EXACT: Q and K hold bf16 values (one
// product a step).
template <int NT, bool EXACT, typename T>
__device__ __forceinline__ void qk_tile(float (&s)[NT][4], const T* Q, int ldq, const T* K, int ldk, int kc,
                                        int nt = NT) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  for (int k0 = 0; k0 < kc; k0 += 8) {
    const float2 x0 = ld_pair(Q + g8 * ldq + k0 + 2 * t4);
    const float2 x1 = ld_pair(Q + (g8 + 8) * ldq + k0 + 2 * t4);
    uint32_t ah[4], al[4];
    split_op<EXACT>(x0.x, ah[0], al[0]);
    split_op<EXACT>(x1.x, ah[1], al[1]);
    split_op<EXACT>(x0.y, ah[2], al[2]);
    split_op<EXACT>(x1.y, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const float2 y = ld_pair(K + (8 * j + g8) * ldk + k0 + 2 * t4);
        uint32_t bh[2], bl[2];
        split_op<EXACT>(y.x, bh[0], bl[0]);
        split_op<EXACT>(y.y, bh[1], bl[1]);
        if (EXACT)
          mma_tf32(s[j], ah, bh[0], bh[1]);
        else
          mma_3xtf32(s[j], ah, al, bh, bl);
      }
    }
  }
}

// o[c] += P . V for the warp's 16 rows and output columns 8 c + (0..7), c <
// ct: p in the accumulator layout of qk_tile over NT x 8 keys (float32,
// split), key n of V at V[n * ldv] in shared memory.  EXACT: V holds bf16
// values.
template <int NT, int CT, bool EXACT, typename T>
__device__ __forceinline__ void pv_tile(float (&o)[CT][4], const float (&p)[NT][4], const T* V, int ldv,
                                        int ct = CT) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kb = 0; kb < NT; ++kb) {
    uint32_t ah[4], al[4];
    split_tf32_fast(p[kb][0], ah[0], al[0]);  // (row g8, key 2 t4): k-index t4
    split_tf32_fast(p[kb][2], ah[1], al[1]);  // (row g8 + 8, key 2 t4)
    split_tf32_fast(p[kb][1], ah[2], al[2]);  // (row g8, key 2 t4 + 1): k-index t4 + 4
    split_tf32_fast(p[kb][3], ah[3], al[3]);
    const T* v0 = V + (8 * kb + 2 * t4) * ldv + g8;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      if (c < ct) {
        uint32_t bh[2], bl[2];
        split_op<EXACT>(ld_one(v0 + 8 * c), bh[0], bl[0]);
        split_op<EXACT>(ld_one(v0 + ldv + 8 * c), bh[1], bl[1]);
        mma_split<EXACT>(o[c], ah, al, bh, bl);
      }
    }
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
