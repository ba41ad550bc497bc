// GRU recurrence over precomputed input projections, for sm_90a.
//
// Replaces the TPU kernel dpmn_tpu/ops/pallas_kernels.py::pallas_gru_scan
// (pallas_call at :76).  Computes, for each sequence n and step t (t running
// backwards when `reverse` is set, which equals scanning the time-flipped
// input and flipping the output back):
//     gh = h @ w_hh^T + b_hh                      (torch gate order [r; z; n])
//     r = sigmoid(gi_r + gh_r); z = sigmoid(gi_z + gh_z)
//     n = tanh(gi_n + r * gh_n); h = (1 - z) * n + z * h
// with gi = x_proj[n, t] and h0 = 0.  w_hh is (3H, H), torch's layout.
//
// What bounds it on an H100: the recurrence is serial in T, so the time is a
// chain of T dependent steps, each a tiny (H x 3H) matrix-vector product per
// sequence.  Two designs behind one entry point:
//   * H = 32 (the SRB sweeps): w_hh (12 KB) is staged transposed in shared
//     memory once per block; one warp carries SMALL_SEQ sequences, lane j
//     owning hidden unit j, h stays in shared memory for the whole sequence;
//     a step is 3H FMAs per unit and sequence, no block-wide barrier.
//     Bytes: x_proj read once and out written once.
//   * any other multiple of 32 (gru_encoding, H = 512): w_hh is 3 MB and fits
//     in no SM, so each step streams it from L2.  One block per sequence: a
//     warp per row of w_hh computes the coalesced dot product, then one
//     thread per unit does the gate math.  Time is bounded by the
//     L2-to-SM rate times T (each step re-reads w_hh); keeping w_hh on chip
//     across a thread-block cluster is later work.
// Sums run in a fixed order, so reruns agree bit for bit.  Bounds at B = 64
// (each input read once, each output written once): the SRB sweeps move
// 33.6 MB = 10 us at 3.35 TB/s; gru_encoding does 6.4 GFLOP = 96 us at
// 67 TFLOP/s.  Measured on an H100 SXM at 700 W: 0.058 and 0.223 ms per SRB
// sweep, 3.9 ms per gru_encoding direction (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

constexpr int SMALL_H = 32;     // hidden size of the shared-memory design: lane j owns unit j
constexpr int SMALL_WARPS = 4;  // warps per block
constexpr int SMALL_SEQ = 2;    // sequences per warp

__global__ void gru_small_kernel(const float* __restrict__ xp, const float* __restrict__ w,
                                 const float* __restrict__ b, float* __restrict__ out,
                                 int N, int T, int reverse) {
  constexpr int H = SMALL_H;
  constexpr int G = 3 * H;
  constexpr int WS = G + 1;  // padded row: conflict-free transposed staging
  __shared__ float wt[H * WS];                          // [H][3H + 1] transposed w_hh
  __shared__ float hs[SMALL_WARPS * SMALL_SEQ * H];     // [SMALL_WARPS][SMALL_SEQ][H]
  for (int idx = threadIdx.x; idx < G * H; idx += blockDim.x) {
    const int j = idx / H, k = idx % H;
    wt[k * WS + j] = w[idx];
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* h = hs + warp * SMALL_SEQ * H;
  for (int i = lane; i < SMALL_SEQ * H; i += 32) h[i] = 0.0f;
  const float br = b[lane], bz = b[H + lane], bn = b[2 * H + lane];
  __syncthreads();
  const int n0 = (blockIdx.x * SMALL_WARPS + warp) * SMALL_SEQ;
  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    float ar[SMALL_SEQ], az[SMALL_SEQ], an[SMALL_SEQ];
#pragma unroll
    for (int s = 0; s < SMALL_SEQ; ++s) {
      ar[s] = br;
      az[s] = bz;
      an[s] = bn;
    }
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float wr = wt[k * WS + lane], wz = wt[k * WS + H + lane], wn = wt[k * WS + 2 * H + lane];
#pragma unroll
      for (int s = 0; s < SMALL_SEQ; ++s) {
        const float hk = h[s * H + k];
        ar[s] = fmaf(hk, wr, ar[s]);
        az[s] = fmaf(hk, wz, az[s]);
        an[s] = fmaf(hk, wn, an[s]);
      }
    }
    float hn[SMALL_SEQ];
#pragma unroll
    for (int s = 0; s < SMALL_SEQ; ++s) {
      const int n = n0 + s;
      const float hold = h[s * H + lane];
      hn[s] = hold;
      if (n < N) {
        const float* gi = xp + ((int64_t)n * T + t) * G;
        const float r = sigmoidf_(gi[lane] + ar[s]);
        const float z = sigmoidf_(gi[H + lane] + az[s]);
        const float nn = tanhf(gi[2 * H + lane] + r * an[s]);
        hn[s] = (1.0f - z) * nn + z * hold;
        out[((int64_t)n * T + t) * H + lane] = hn[s];
      }
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < SMALL_SEQ; ++s) h[s * H + lane] = hn[s];
    __syncwarp();
  }
}

constexpr int LARGE_THREADS = 512;

// one block per sequence
__global__ void gru_large_kernel(const float* __restrict__ xp, const float* __restrict__ w,
                                 const float* __restrict__ b, float* __restrict__ out,
                                 int T, int H, int reverse) {
  const int G = 3 * H;
  extern __shared__ float sm[];
  float* h = sm;       // [H]
  float* gh = sm + H;  // [3H]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int n = blockIdx.x;
  for (int i = threadIdx.x; i < H; i += blockDim.x) h[i] = 0.0f;
  __syncthreads();
  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    for (int row = warp; row < G; row += nwarps) {
      const float* wrow = w + (int64_t)row * H;
      float acc = 0.0f;
      for (int k = lane; k < H; k += 32) acc = fmaf(__ldg(wrow + k), h[k], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) gh[row] = acc + b[row];
    }
    __syncthreads();
    const float* gi = xp + ((int64_t)n * T + t) * G;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float r = sigmoidf_(gi[j] + gh[j]);
      const float z = sigmoidf_(gi[H + j] + gh[H + j]);
      const float nn = tanhf(gi[2 * H + j] + r * gh[2 * H + j]);
      const float hnew = (1.0f - z) * nn + z * h[j];
      h[j] = hnew;
      out[((int64_t)n * T + t) * H + j] = hnew;
    }
    __syncthreads();
  }
}

}  // namespace

// x_proj (N, T, 3H), w_hh (3H, H), b_hh (3H) -> out (N, T, H); all float32,
// contiguous, on the device of `stream`.  Returns cudaGetLastError() after
// the launch.  H must be 32 (the SRB sweeps) or a larger multiple of 32
// (gru_encoding).
extern "C" int gru_scan_forward(const float* x_proj, const float* w_hh, const float* b_hh, float* out,
                                int N, int T, int H, int reverse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % 32 != 0 || N <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (H == SMALL_H) {
    const int per_block = SMALL_WARPS * SMALL_SEQ;
    gru_small_kernel<<<(N + per_block - 1) / per_block, SMALL_WARPS * 32, 0, st>>>(x_proj, w_hh, b_hh, out, N,
                                                                                 T, reverse);
  } else {
    const size_t smem = (size_t)(4 * H) * sizeof(float);
    cudaFuncSetAttribute(gru_large_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    gru_large_kernel<<<N, LARGE_THREADS, smem, st>>>(x_proj, w_hh, b_hh, out, T, H, reverse);
  }
  return static_cast<int>(cudaGetLastError());
}
