// Tensor-core and async-copy pieces shared by the kernels: the GRU scan
// (gru_scan.cu) and the window-attention kernels (window_common.cuh,
// window_train_common.cuh).
//
//   * cp.async copies of 16 bytes into shared memory (with a zero-filling
//     form for rows past the end of a tensor), their commit and wait;
//   * mma.sync m16n8k8 on TF32 operands with float32 accumulation, and the
//     3xTF32 split x = hi + lo that keeps float32 accuracy: a product takes
//     hi*hi + hi*lo + lo*hi (lo*lo, about 2^-22 of it, is dropped).  One
//     TF32 pass keeps about 3 decimal digits, too few for the 1e-4 gates;
//   * the product routine of the window kernels, a warp's tile of C (+)=
//     A . B from shared memory with either operand stored K-contiguous or
//     K-major: tokens x outputs = A . W^T (both K-contiguous), the weight
//     gradient dW = dy^T . x over a chunk of tokens (both token-major), and
//     the attention backward's products.
//
// Fragment coordinates of m16n8k8 (lane = 4 g8 + t4): A a0 (g8, t4), a1
// (g8 + 8, t4), a2 (g8, t4 + 4), a3 (g8 + 8, t4 + 4); B b0 (k t4, n g8), b1
// (k t4 + 4, n g8); C c0 (g8, 2 t4), c1 (g8, 2 t4 + 1), c2 (g8 + 8, 2 t4),
// c3 (g8 + 8, 2 t4 + 1).  So the fragment loads hit 32 distinct banks when
// a K-contiguous row stride is 4 mod 32 floats (A . B^T), and when a
// token-major row stride is 8 or 24 mod 32 floats (A^T . B).
//
// The build hash of every csrc/*.cu covers this header (ops/kernels.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem) : "memory");
}

// 16 bytes from gmem when `valid`, else 16 zero bytes (gmem is not read)
__device__ __forceinline__ void cp_async16_zfill(float* smem, const float* gmem, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most `pending` (0-7) of this thread's cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32: the 3xTF32 split
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// x = hi + lo for the window kernels' products, in 3 instructions: hi is x
// rounded to tf32 (half a tf32 ulp added to the bits, the 13 low bits
// cleared), lo = x - hi exactly in float32, which the tensor core reads
// truncated to tf32.  The dropped and truncated terms stay below 2^-20 of
// |a b| per product.  (cvt.rna.tf32.f32 of split_tf32 takes several
// instructions a conversion on sm_90; the GRU scan keeps it.)
__device__ __forceinline__ void split_tf32_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 3xTF32 product step: d += a . b with a, b split (the small terms first).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// mma_3xtf32 where b is exact in TF32 (a widened bf16 value: its 16 low
// bits are clear, so split_tf32_fast gives hi = b and lo = +0, and the
// ah . bl pass adds exact zeros): the two passes that remain, in the same
// order, give the same sums up to the sign of a zero.
__device__ __forceinline__ void mma_2xtf32(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// A warp's tile of C (+)= A . B over K (a multiple of 8), A (M x K) and B
// (K x N) in shared memory: element (m, k) of A at A[m * lda + k], or at
// A[k * lda + m] when AT; element (k, n) of B at B[n * ldb + k], or at
// B[k * ldb + n] when BT.  So <false, false> is tokens x outputs = A . W^T
// with both K-contiguous (strides 4 mod 32 floats: conflict-free), and
// <true, true> the transposed form dW = dy^T . x with both token-major
// (strides 8 or 24 mod 32).  The warp owns the m16-tiles at rows m0 + 16 i
// for i < mt and the n8-tiles at columns n0 + 8 j for j < nt (mt <= MT, nt
// <= NT; the rest of the register tile stays untouched).  Per k-step the B
// fragments are split once and serve all m-tiles.  BX: every element of B
// is exact in TF32 (SKConv's bf16 weights, widened as staged): B is not
// split and each step takes two passes (mma_2xtf32).
template <bool AT, bool BT, int MT, int NT, bool BX = false>
__device__ __forceinline__ void mma_tile(float (&acc)[MT][NT][4], const float* __restrict__ A, int lda, int m0,
                                         const float* __restrict__ Bm, int ldb, int n0, int K, int mt = MT,
                                         int nt = NT) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  auto a_at = [&](int m, int k) { return AT ? A[k * lda + m] : A[m * lda + k]; };
  auto b_at = [&](int n, int k) { return BT ? Bm[k * ldb + n] : Bm[n * ldb + k]; };
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const int n = n0 + 8 * j + g8;
        if constexpr (BX) {
          bh[j][0] = __float_as_uint(b_at(n, k0 + t4));
          bh[j][1] = __float_as_uint(b_at(n, k0 + t4 + 4));
        } else {
          split_tf32_fast(b_at(n, k0 + t4), bh[j][0], bl[j][0]);
          split_tf32_fast(b_at(n, k0 + t4 + 4), bh[j][1], bl[j][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < mt) {
        const int m = m0 + 16 * i + g8;
        uint32_t ah[4], al[4];
        split_tf32_fast(a_at(m, k0 + t4), ah[0], al[0]);
        split_tf32_fast(a_at(m + 8, k0 + t4), ah[1], al[1]);
        split_tf32_fast(a_at(m, k0 + t4 + 4), ah[2], al[2]);
        split_tf32_fast(a_at(m + 8, k0 + t4 + 4), ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j < nt) {
            if constexpr (BX)
              mma_2xtf32(acc[i][j], ah, al, bh[j]);
            else
              mma_3xtf32(acc[i][j], ah, al, bh[j], bl[j]);
          }
      }
    }
  }
}

// The SMs of the current device, the grid of a persistent kernel.
inline cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace
