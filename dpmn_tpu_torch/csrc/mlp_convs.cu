// The faithful PGRM Mlp conv pair, for sm_90a.
//
// Replaces the TPU kernel dpmn_tpu/ops/pallas_mlp.py::fused_mlp_convs
// (pallas_call at :76).  Per image, x (HW, hidden) is viewed in C order as
// (hidden, s, s) with s = sqrt(HW) (the reference's model/pgrm.py:33-38
// quirk), then:
//   (a) g = gelu(depthwise 3x3 of the view, zero padding 1, + dw_bias), with
//       the exact erf GELU;
//   (b) y = Wpw g + pw_bias, the 1x1 channel mix as a (hidden x hidden) by
//       (hidden x s*s) product per image;
// and the (hidden, s*s) result is read back as (HW, hidden): in memory the
// output is y itself, (B, hidden, s*s) in C order.
//
// Two kernels: (a) one thread per element of the (hidden, s, s) view, writing
// g (B, hidden, s*s) to a scratch buffer; (b) a tiled shared-memory SGEMM on
// the CUDA cores, 128 x 128 output tiles per block over 8-deep slices of the
// channel axis, an 8 x 8 register tile per thread, + the bias at the store.
// No library call: the TPU kernel computes the mix in its own body.
//
// What bounds it on an H100 at B = 64 and the flagship Mlp (HW = 1024,
// s = 32, hidden = 384), each input read once and each output written once:
// 201 MB (x and the output) = 60 us at 3.35 TB/s; 19.8 GFLOP (the mix
// 2 B hidden^2 HW = 19.3, the stencil 2 x 9 B hidden HW = 0.45) = 295 us at
// 67 TFLOP/s float32.  Bound by operations.  The g round trip through device
// memory (another 201 MB) and the simple SGEMM keep it above the bound; the
// mix on tensor cores (wgmma, TF32 or split bf16) with the stencil fused into
// its operand load is later work.  Its times, beside the cuDNN depthwise +
// GELU + 1x1 pair the port's Mlp runs, stand in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float gelu_erf(float x) { return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f)); }

// (a) g[b, c, r, col] = gelu(sum_{di,dj} x[b, c, r+di-1, col+dj-1] w[c, di, dj] + dw_b[c])
__global__ void dwconv_gelu_kernel(const float* __restrict__ x, const float* __restrict__ dw_w,
                                   const float* __restrict__ dw_b, float* __restrict__ g, int hidden, int s,
                                   int64_t total) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ss = s * s;
  const int col = (int)(idx % s), r = (int)((idx / s) % s), c = (int)((idx / ss) % hidden);
  const float* plane = x + (idx - (int64_t)r * s - col);
  const float* w = dw_w + c * 9;
  float acc = 0.f;
#pragma unroll
  for (int di = 0; di < 3; ++di) {
    const int rr = r + di - 1;
    if (rr < 0 || rr >= s) continue;
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const int cc = col + dj - 1;
      if (cc < 0 || cc >= s) continue;
      acc = fmaf(plane[rr * s + cc], __ldg(w + di * 3 + dj), acc);
    }
  }
  g[idx] = gelu_erf(acc + __ldg(dw_b + c));
}

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;
constexpr int GEMM_THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;                               // keeps rows 16-byte aligned

// (b) out[b, m, n] = sum_k W[m, k] G[b, k, n] + bias[m]; W (M, K), G (B, K, S).
// K is a multiple of BK; M and S are masked.
__global__ void __launch_bounds__(GEMM_THREADS)
    pw_gemm_kernel(const float* __restrict__ Wm, const float* __restrict__ G, const float* __restrict__ bias,
                   float* __restrict__ out, int M, int K, int S) {
  __shared__ __align__(16) float As[BK][BM + PAD];  // As[k][m] = W[m0 + m, k0 + k]
  __shared__ __align__(16) float Bs[BK][BN + PAD];  // Bs[k][n] = G[b, k0 + k, n0 + n]
  const int b = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* Gb = G + (int64_t)b * K * S;
  float* Ob = out + (int64_t)b * M * S;
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int rep = 0; rep < BM * BK / GEMM_THREADS; ++rep) {
      const int e = tid + rep * GEMM_THREADS, m = e / BK, kk = e % BK;
      As[kk][m] = (m0 + m < M) ? Wm[(int64_t)(m0 + m) * K + k0 + kk] : 0.f;
    }
#pragma unroll
    for (int rep = 0; rep < BN * BK / GEMM_THREADS; ++rep) {
      const int e = tid + rep * GEMM_THREADS, kk = e / BN, n = e % BN;
      Bs[kk][n] = (n0 + n < S) ? Gb[(int64_t)(k0 + kk) * S + n0 + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + 4]);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w, a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
      bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w, bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    const float bm = __ldg(bias + m);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < S) Ob[(int64_t)m * S + n] = acc[i][j] + bm;
    }
  }
}

}  // namespace

// Shapes: x, out (B, HW, hidden) with HW = s*s, float32, contiguous;
// dw_w (hidden, 1, 3, 3) and pw_w (hidden, hidden, 1, 1), torch Conv2d
// layouts; dw_b, pw_b (hidden).  Scratch the caller allocates: g (B, hidden,
// s*s).  Needs hidden % 32 == 0 (the Python wrapper checks it and that HW is
// a perfect square).  Returns cudaGetLastError() after the last launch (or
// the first failing one).
extern "C" int mlp_convs_forward(const float* x, const float* dw_w, const float* dw_b, const float* pw_w,
                                 const float* pw_b, float* g, float* out, int B, int s, int hidden, void* stream) {
  if (hidden % 32 != 0 || s < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = s * s;
  const int64_t total = (int64_t)B * hidden * S;
  dwconv_gelu_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(x, dw_w, dw_b, g, hidden, s, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BN - 1) / BN, (hidden + BM - 1) / BM, B);
  pw_gemm_kernel<<<grid, GEMM_THREADS, 0, st>>>(pw_w, g, pw_b, out, hidden, hidden, S);
  return static_cast<int>(cudaGetLastError());
}
