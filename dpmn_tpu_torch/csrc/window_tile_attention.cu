// Per-window attention tiles, for sm_90a.
//
// Replaces the TPU kernel dpmn_tpu/ops/pallas_kernels.py::
// pallas_window_attention (body _window_attn_kernel at :104, pallas_call at
// :140).  For W windows of N tokens with C channels (batch, windows and heads
// folded into W by the caller, q already scaled):
//     out[w] = softmax(q[w] k[w]^T + bias[w] [+ mask[w]]) v[w]
// with q, k, v, out (W, N, C) and bias, mask (W, N, N), all float32.  The
// TPU kernel pads W to a multiple of its tile of windows; blocks here mask
// their ragged end instead, so no padding exists.
//
// Design: a block takes WPB consecutive windows, one thread per (window,
// query row).  It stages q, k, v and bias (+ mask) of its windows in shared
// memory with coalesced loads; each thread forms its row of scores on top of
// the staged bias row, takes the row softmax and the product with v, and
// writes its output row back into its q row; the block then stores the
// outputs with coalesced writes.  Rows are padded by one float so that the
// threads of a warp read distinct banks.  N <= 64 and C <= 64.
//
// What bounds it on an H100: each input read once and each output written
// once, 4 (4 W N C + 2 W N N) bytes, against 4 W N^2 C float32 operations:
// about 1 operation per byte, so bytes bound it at every shape.  At the
// flagship's folded shapes (B = 64: W = 32768, 8192, 2048 for N = 4, 16, 64,
// C = 16) it moves 37.7, 50.3 and 100.7 MB (9.6 to 30 us at 3.35 TB/s); at
// N = 64 the (W, N, N) bias and mask are two thirds of it.  Its times stand
// in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 64;
constexpr int MAX_C = 64;
constexpr int TARGET_THREADS = 128;
constexpr size_t SMEM_SOFT_LIMIT = 48 * 1024;

struct TileLayout {
  int q_w, kv_w, s_w;  // floats per window: q rows of C + 1, k / v blocks of N C + 1, score rows of N + 1
  __host__ __device__ TileLayout(int n, int c) : q_w(n * (c + 1)), kv_w(n * c + 1), s_w(n * (n + 1)) {}
  __host__ __device__ int floats() const { return q_w + 2 * kv_w + s_w; }
};

__global__ void tile_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ bias,
                                 const float* __restrict__ mask, float* __restrict__ out, int n_win, int N, int C,
                                 int wpb) {
  extern __shared__ float sm[];
  const TileLayout lay(N, C);
  float* qs = sm;
  float* ks = qs + wpb * lay.q_w;
  float* vs = ks + wpb * lay.kv_w;
  float* sc = vs + wpb * lay.kv_w;
  const int64_t w0 = (int64_t)blockIdx.x * wpb;
  const int64_t left = (int64_t)n_win - w0;
  const int nwin = left < wpb ? (int)left : wpb;
  const int nc = N * C, nn = N * N;
  const int64_t xbase = w0 * nc, sbase = w0 * nn;
  for (int e = threadIdx.x; e < nwin * nc; e += blockDim.x) {
    const int lw = e / nc, r = e % nc, i = r / C, d = r % C;
    qs[lw * lay.q_w + i * (C + 1) + d] = q[xbase + e];
    ks[lw * lay.kv_w + r] = k[xbase + e];
    vs[lw * lay.kv_w + r] = v[xbase + e];
  }
  for (int e = threadIdx.x; e < nwin * nn; e += blockDim.x) {
    const int lw = e / nn, r = e % nn, i = r / N, j = r % N;
    float b = bias[sbase + e];
    if (mask) b += mask[sbase + e];
    sc[lw * lay.s_w + i * (N + 1) + j] = b;
  }
  __syncthreads();
  const int lw = threadIdx.x / N, i = threadIdx.x % N;
  if (lw < nwin) {
    float* qrow = qs + lw * lay.q_w + i * (C + 1);
    const float* kw = ks + lw * lay.kv_w;
    const float* vw = vs + lw * lay.kv_w;
    float* srow = sc + lw * lay.s_w + i * (N + 1);
    float mx = -INFINITY;
    for (int j = 0; j < N; ++j) {
      float acc = 0.f;
      for (int d = 0; d < C; ++d) acc = fmaf(qrow[d], kw[j * C + d], acc);
      const float s = acc + srow[j];
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    float den = 0.f;
    for (int j = 0; j < N; ++j) {
      const float p = expf(srow[j] - mx);
      srow[j] = p;
      den += p;
    }
    for (int j = 0; j < N; ++j) srow[j] /= den;
    // the thread's own q row is no longer read: it takes the output row
    for (int d = 0; d < C; ++d) {
      float o = 0.f;
      for (int j = 0; j < N; ++j) o = fmaf(srow[j], vw[j * C + d], o);
      qrow[d] = o;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nwin * nc; e += blockDim.x) {
    const int lw2 = e / nc, r = e % nc, i2 = r / C, d = r % C;
    out[xbase + e] = qs[lw2 * lay.q_w + i2 * (C + 1) + d];
  }
}

}  // namespace

// Shapes: q, k, v, out (n_win, N, C); bias and mask (n_win, N, N), all
// float32 and contiguous; mask may be null (no mask).  Needs 1 <= N <= 64 and
// 1 <= C <= 64; the Python wrapper checks these.  Returns cudaGetLastError()
// after the launch.
extern "C" int window_tile_attention_forward(const float* q, const float* k, const float* v, const float* bias,
                                             const float* mask, float* out, int n_win, int N, int C,
                                             void* stream) {
  if (N < 1 || N > MAX_N || C < 1 || C > MAX_C || n_win < 1) return static_cast<int>(cudaErrorInvalidValue);
  const TileLayout lay(N, C);
  int wpb = N >= TARGET_THREADS ? 1 : TARGET_THREADS / N;
  while (wpb > 1 && (size_t)wpb * lay.floats() * sizeof(float) > SMEM_SOFT_LIMIT) --wpb;
  const size_t smem = (size_t)wpb * lay.floats() * sizeof(float);
  cudaFuncSetAttribute(tile_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int blocks = (n_win + wpb - 1) / wpb;
  tile_attn_kernel<<<blocks, wpb * N, smem, static_cast<cudaStream_t>(stream)>>>(q, k, v, bias, mask, out, n_win, N,
                                                                                  C, wpb);
  return static_cast<int>(cudaGetLastError());
}
