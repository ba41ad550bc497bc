// Per-window attention tiles, for sm_90a.
//
// Replaces the TPU kernel dpmn_tpu/ops/pallas_kernels.py::
// pallas_window_attention (body _window_attn_kernel at :104, pallas_call at
// :140).  For W windows of N tokens with C channels (batch, windows and heads
// folded into W by the caller, q already scaled):
//     out[w] = softmax(q[w] k[w]^T + bias[w] [+ mask[w]]) v[w]
// with q, k, v, out (W, N, C) and bias, mask (W, N, N), all float32.  The
// TPU kernel pads W to a multiple of its tile of windows; the kernels here
// mask their ragged end instead, so no padding exists.
//
// What bounds it on an H100: each input read once and each output written
// once, 4 (4 W N C + 2 W N N) bytes, against 4 W N^2 C float32 operations:
// about 1 operation per byte, so bytes bound it at every shape.  At the
// flagship's folded shapes (B = 64: W = 32768, 8192, 2048 for N = 4, 16, 64,
// C = 16, masked) it moves 37.7, 50.3 and 100.7 MB (11 to 30 us at 3.35
// TB/s); at N = 64 the (W, N, N) bias and mask are two thirds of it.
//
// Design.  N > 8 runs on the tensor cores (attn_tile.cuh): persistent CTAs
// of 8 warps walk steps of WPS windows; a step's q, k, v rows land in a
// shared slot by 16-byte cp.async (C % 4 == 0 and 16-byte aligned tensors;
// element by element otherwise) while the previous step is computed (two
// buffers).  N is padded to NP (a multiple of 16) and C to a multiple of 8
// in shared memory, where the padding is zeroed once and never written: a
// warp owns 16 query rows of a window, S = q k^T and P v run on mma.sync at
// 3xTF32 (1xTF32 keeps about 3 digits, too few for 1e-5), the bias and mask
// are read once, straight into the score registers (a lane's two adjacent
// columns as one 8-byte load, so a quad covers a 32-byte sector), padded
// keys score -inf, and padded rows are not stored.  The bias and mask, two
// thirds of the bytes at N = 64, never touch shared memory.  N <= 8 (a
// 16-row tile would be mostly padding) runs on the CUDA cores, a thread per
// (window, query row): its q row and the window's k and v rows read as
// 16-byte pieces (the window's N threads share them through L1), its N
// scores, softmax and output row in registers.  Its times stand in PERF.md.

#include "attn_tile.cuh"

namespace {

constexpr int MAX_N = 64;
constexpr int MAX_C = 64;
constexpr int TPB = 256;

// A staged window (floats): q and k rows at a stride of 8 mod 16, v rows at
// 4 mod 8, over cp = C padded to 8 channels; np = N padded to 16 rows.
struct TileLayout {
  int cp, ldk, ldv, np;
  __host__ __device__ TileLayout(int n, int c)
      : cp((c + 7) & ~7), ldk(cp % 16 ? cp : cp + 8), ldv(cp + 4), np((n + 15) & ~15) {}
  __host__ __device__ int slot() const { return np * (2 * ldk + ldv); }
};

// Two CTAs an SM at least (registers up to 128 a thread): shared memory
// holds two or three at C = 16.
template <int NP>
__global__ void __launch_bounds__(TPB, 2)
    tile_attn_tc_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ bias, const float* __restrict__ mask, float* __restrict__ out,
                        int n_win, int N, int C, int vec, int pair, int opair) {
  constexpr int MT = NP / 16, NT = NP / 8, WPS = (TPB / 32) / MT;
  extern __shared__ __align__(16) float sm[];
  const TileLayout lay(N, C);
  const int slot = lay.slot(), ldk = lay.ldk, ldv = lay.ldv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  for (int e = threadIdx.x; e < 2 * WPS * slot; e += TPB) sm[e] = 0.f;  // the padding stays zero
  __syncthreads();
  const int64_t steps = ((int64_t)n_win + WPS - 1) / WPS;
  const int per = vec ? C / 4 : C, each = vec ? 4 : 1;  // pieces of a row, elements of a piece
  // a step's q, k, v rows into buffer buf: a thread takes (row, piece)
  // pairs, the same piece of q, k and v, in the order of memory (each
  // tensor's windows of the step are contiguous)
  auto stage = [&](int64_t step, int buf) {
    float* dst0 = sm + buf * WPS * slot;
    for (int e = threadIdx.x; e < WPS * N * per; e += TPB) {
      const int row = e / per, c = (e - row * per) * each, l = row / N, j = row - l * N;
      const int64_t w = step * WPS + l;
      if (w >= n_win) continue;
      const int64_t off = (w * N + j) * C + c;
      float* dst = dst0 + l * slot + j * ldk + c;
      float* vdst = dst0 + l * slot + 2 * NP * ldk + j * ldv + c;
      if (vec) {
        cp_async16(dst, q + off);
        cp_async16(dst + NP * ldk, k + off);
        cp_async16(vdst, v + off);
      } else {
        dst[0] = __ldg(q + off);
        dst[NP * ldk] = __ldg(k + off);
        vdst[0] = __ldg(v + off);
      }
    }
    cp_async_commit();
  };
  int buf = 0;
  if (blockIdx.x < steps) stage(blockIdx.x, 0);
  for (int64_t step = blockIdx.x; step < steps; step += gridDim.x, buf ^= 1) {
    if (step + gridDim.x < steps) stage(step + gridDim.x, buf ^ 1);
    cp_async_wait(step + gridDim.x < steps ? 1 : 0);
    __syncthreads();  // this step's rows are in shared memory
    if (warp < WPS * MT) {
      const int lw = warp / MT, mi = warp % MT;
      const int64_t w = step * WPS + lw;
      if (w < n_win) {
        const float* Qs = sm + (buf * WPS + lw) * slot;
        float s[NT][4] = {};
        qk_tile<NT>(s, Qs + 16 * mi * ldk, ldk, Qs + NP * ldk, ldk, lay.cp);
        const int i0 = 16 * mi + g8;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = i0 + 8 * r, j = 8 * jn + 2 * t4;
            if (i < N && j < N) {
              const int64_t off = (w * N + i) * N + j;
              float2 add;
              if (pair) {  // N even: j + 1 < N
                add = __ldg(reinterpret_cast<const float2*>(bias + off));
                if (mask) {
                  const float2 mm = __ldg(reinterpret_cast<const float2*>(mask + off));
                  add.x += mm.x;
                  add.y += mm.y;
                }
              } else {
                add.x = __ldg(bias + off) + (mask ? __ldg(mask + off) : 0.f);
                add.y = j + 1 < N ? __ldg(bias + off + 1) + (mask ? __ldg(mask + off + 1) : 0.f) : 0.f;
              }
              s[jn][2 * r] += add.x;
              s[jn][2 * r + 1] += add.y;
            }
            if (j >= N) s[jn][2 * r] = -INFINITY;
            if (j + 1 >= N) s[jn][2 * r + 1] = -INFINITY;
          }
        softmax_rows<false>(s);
        float o[8][4] = {};
        pv_tile<NT, 8>(o, s, Qs + 2 * NP * ldk, ldv, lay.cp / 8);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + 8 * r;
          if (i >= N) continue;
          float* orow = out + (w * N + i) * C;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int col = 8 * c + 2 * t4;
            if (col >= C) continue;
            if (opair) {  // C even: col + 1 < C
              *reinterpret_cast<float2*>(orow + col) = make_float2(o[c][2 * r], o[c][2 * r + 1]);
            } else {
              orow[col] = o[c][2 * r];
              if (col + 1 < C) orow[col + 1] = o[c][2 * r + 1];
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
}

__global__ void __launch_bounds__(TPB)
    tile_attn_small_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                           const float* __restrict__ bias, const float* __restrict__ mask, float* __restrict__ out,
                           int n_win, int N, int C, int vec) {
  const int64_t t = (int64_t)blockIdx.x * TPB + threadIdx.x;  // (window, query row)
  if (t >= (int64_t)n_win * N) return;
  const int64_t w = t / N;
  const float* qr = q + t * C;
  const float* kw = k + w * N * C;
  const float* vw = v + w * N * C;
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = 0.f;
  if (vec) {
    for (int c0 = 0; c0 < C; c0 += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(qr + c0));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < N) {
          const float4 b = __ldg(reinterpret_cast<const float4*>(kw + j * C + c0));
          s[j] = fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, s[j]))));
        }
      }
    }
  } else {
    for (int c = 0; c < C; ++c) {
      const float a = __ldg(qr + c);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < N) s[j] = fmaf(a, __ldg(kw + j * C + c), s[j]);
    }
  }
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < N) {
      s[j] += __ldg(bias + t * N + j) + (mask ? __ldg(mask + t * N + j) : 0.f);
      mx = fmaxf(mx, s[j]);
    }
  }
  float den = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j] = j < N ? expf(s[j] - mx) : 0.f;
    den += s[j];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] /= den;
  float* orow = out + t * C;
  if (vec) {
    for (int c0 = 0; c0 < C; c0 += 4) {
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < N) {
          const float4 b = __ldg(reinterpret_cast<const float4*>(vw + j * C + c0));
          o.x = fmaf(s[j], b.x, o.x), o.y = fmaf(s[j], b.y, o.y), o.z = fmaf(s[j], b.z, o.z),
          o.w = fmaf(s[j], b.w, o.w);
        }
      }
      *reinterpret_cast<float4*>(orow + c0) = o;
    }
  } else {
    for (int c = 0; c < C; ++c) {
      float o = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < N) o = fmaf(s[j], __ldg(vw + j * C + c), o);
      orow[c] = o;
    }
  }
}

inline bool aligned(const void* p, int bytes) { return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0; }

template <int NP>
cudaError_t launch_tc(const float* q, const float* k, const float* v, const float* bias, const float* mask,
                      float* out, int n_win, int N, int C, int vec, cudaStream_t st) {
  constexpr int WPS = (TPB / 32) / (NP / 16);
  const size_t smem = (size_t)2 * WPS * TileLayout(N, C).slot() * sizeof(float);
  static GridCap cache;
  int cap = 0;
  const cudaError_t err = persistent_cap(cache, tile_attn_tc_kernel<NP>, TPB, smem, &cap);
  if (err != cudaSuccess) return err;
  const int64_t steps = ((int64_t)n_win + WPS - 1) / WPS;
  const int pair = N % 2 == 0 && aligned(bias, 8) && (!mask || aligned(mask, 8));
  const int opair = C % 2 == 0 && aligned(out, 8);
  tile_attn_tc_kernel<NP><<<(int)(steps < cap ? steps : cap), TPB, smem, st>>>(q, k, v, bias, mask, out, n_win, N,
                                                                                  C, vec, pair, opair);
  return cudaGetLastError();
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = C % 4 == 0 && aligned(q, 16) && aligned(k, 16) && aligned(v, 16) && aligned(out, 16);
  if (N <= 8) {
    const int64_t threads = (int64_t)n_win * N;
    tile_attn_small_kernel<<<(unsigned)((threads + TPB - 1) / TPB), TPB, 0, st>>>(q, k, v, bias, mask, out, n_win,
                                                                                   N, C, vec);
    return static_cast<int>(cudaGetLastError());
  }
  switch ((N + 15) / 16) {
    case 1: return static_cast<int>(launch_tc<16>(q, k, v, bias, mask, out, n_win, N, C, vec, st));
    case 2: return static_cast<int>(launch_tc<32>(q, k, v, bias, mask, out, n_win, N, C, vec, st));
    case 3: return static_cast<int>(launch_tc<48>(q, k, v, bias, mask, out, n_win, N, C, vec, st));
    default: return static_cast<int>(launch_tc<64>(q, k, v, bias, mask, out, n_win, N, C, vec, st));
  }
}
