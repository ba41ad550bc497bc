// GRU recurrence over precomputed input projections, for sm_90a: one or both
// directions of a bidirectional GRU in one launch.
//
// Replaces the TPU kernel dpmn_tpu/ops/pallas_kernels.py::pallas_gru_scan
// (pallas_call at :76) and, with both directions in one launch, pallas_bigru
// (:92).  Computes, for each direction d, sequence n and step t (t running
// backwards in a reversed direction, which equals scanning the time-flipped
// input and flipping the output back):
//     gh = h @ w_hh^T + b_hh                      (torch gate order [r; z; n])
//     r = sigmoid(gi_r + gh_r); z = sigmoid(gi_z + gh_z)
//     n = tanh(gi_n + r * gh_n); h = (1 - z) * n + z * h
// with gi = x_proj_d[n, t] and h0 = 0, written to out[n, t, d*H : (d+1)*H].
// w_hh is (3H, H), torch's layout.  x_proj is read through a sequence and a
// step stride (the gate axis contiguous), so a projection broadcast along
// time (stride 0) is never materialized.
//
// What bounds it on an H100: the recurrence is serial in T, so the time is a
// chain of T dependent steps, each an (N x H) . (H x 3H) product.  Two
// regimes behind one entry point (any H from 1 to 512):
//   * H = 32 (the SRB sweeps, N = 1024-4096; and H < 32, lanes j >= H idle,
//     w_hh zero past H, `PART`): bound by bytes in total and by
//     latency per step.  One warp per sequence; lane j keeps rows j, H+j and
//     2H+j of w_hh in registers (96 floats, staged once per block through
//     padded shared memory); h_{t-1} is broadcast from a per-warp double
//     buffer in shared memory (one __syncwarp per step); gi runs AHEAD steps
//     ahead of use through a cp.async ring, so no step waits on global
//     memory.  blockIdx.y is the direction.
//   * any H above 32 up to 512 (gru_encoding: N = 64, T = B = 64, H = 512;
//     where H is not a multiple of 8, `PART`: the last CTA's units past H
//     and the k-steps' rows past H read as zeros, so their h stays exactly
//     0): bound by operations, and w_hh (3 MB a direction) fits in no
//     SM.  One cooperative launch over ndir x H/8 CTAs: CTA p of direction d
//     owns hidden units [8p, 8p + 8), so the gate math of its units is
//     local.  Its r, z and n rows of w_hh (24 x H) stay on chip for the
//     whole launch, spread over its 8 warps' registers as mma B fragments,
//     so w_hh crosses L2 once.  A step is a (64 x H) . (H x 24) product per
//     CTA on the tensor cores (mma.sync m16n8k8 with the 3xTF32 hi/lo split,
//     which keeps float32 accuracy), K split over the 8 warps, each
//     streaming its K-slice of h_{t-1} from L2 with cp.async.cg one k-step
//     ahead of use; then a fixed-order reduction of the 8 partial tiles in
//     shared memory, the gate math for the CTA's 64 x 8 outputs, h_t written
//     to a ping-pong buffer in global memory, and a grid sync.  Sequences
//     beyond 64 run in chunks inside the launch.
// Sums run in a fixed order and there are no atomics, so reruns agree bit
// for bit.  Bounds at B = 64 (each input read once, each output written
// once): a launch of an SRB sweep moves 67.1 MB = 20 us at 3.35 TB/s;
// gru_encoding does 12.9 GFLOP = 0.19 ms at 67 TFLOP/s.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"  // cp.async, the 3xTF32 split, mma_tf32

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float gru_cell(float gir, float giz, float gin, float ghr, float ghz, float ghn,
                                          float h) {
  const float r = sigmoidf_(gir + ghr);
  const float z = sigmoidf_(giz + ghz);
  const float n = tanhf(gin + r * ghn);
  return (1.0f - z) * n + z * h;
}

struct Dir {
  const float* xp;  // (N, T, 3H) through the strides below
  const float* w;   // (3H, H)
  const float* b;   // (3H)
  int reverse;
};

struct Args {
  Dir dir[2];
  float* out;   // (N, T, ndir * H)
  float* hbuf;  // cooperative regime: [2][ndir][H][LNC] ping-pong h
  int N, T, H, ndir;
  long long sn, st;  // x_proj strides (elements) of a sequence and of a step
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(gmem) : "memory");
}

// ---------------------------------------------------------------- H = 32

constexpr int SMALL_H = 32;     // lane j owns hidden unit j
constexpr int SMALL_WARPS = 4;  // warps per block, one sequence each
constexpr int AHEAD = 4;        // steps of gi in flight ahead of use

// PART: a.H < 32 hidden units, lane j < a.H owning unit j; w_hh staged as
// 3 x 32 rows of 32 with zeros past a.H, the idle lanes' h held at 0.
template <bool PART = false>
__global__ void __launch_bounds__(SMALL_WARPS * 32) gru_small_kernel(Args a) {
  constexpr int H = SMALL_H, G = 3 * H, WS = H + 1, NSLOT = AHEAD + 1;
  __shared__ float wsm[G * WS];                          // w_hh, rows padded: conflict-free reads
  __shared__ __align__(16) float hs[SMALL_WARPS][2][H];  // h_{t-1}, double-buffered per warp
  __shared__ float gs[SMALL_WARPS][NSLOT][G];            // the gi ring
  const Dir dir = blockIdx.y ? a.dir[1] : a.dir[0];
  const int hn = PART ? a.H : H;  // the hidden units
  for (int idx = threadIdx.x; idx < G * H; idx += SMALL_WARPS * 32) {
    if constexpr (PART) {
      const int row = idx / H, k = idx % H, j = row % H;
      wsm[row * WS + k] = j < hn && k < hn ? __ldg(dir.w + ((row / H) * hn + j) * hn + k) : 0.f;
    } else {
      wsm[(idx / H) * WS + idx % H] = __ldg(dir.w + idx);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool on = !PART || lane < hn;
  const int n = blockIdx.x * SMALL_WARPS + warp;
  if (n >= a.N) return;  // the whole warp: no block-wide barrier follows
  float wr[H], wz[H], wn[H];
#pragma unroll
  for (int k = 0; k < H; ++k) {
    wr[k] = wsm[lane * WS + k];
    wz[k] = wsm[(H + lane) * WS + k];
    wn[k] = wsm[(2 * H + lane) * WS + k];
  }
  const float br = on ? __ldg(dir.b + lane) : 0.f, bz = on ? __ldg(dir.b + hn + lane) : 0.f,
              bn = on ? __ldg(dir.b + 2 * hn + lane) : 0.f;
  const int T = a.T;
  const float* xp = dir.xp + (int64_t)n * a.sn + lane;
  const int64_t ostep = (int64_t)a.ndir * hn;
  float* out = a.out + (int64_t)n * T * ostep + blockIdx.y * hn + lane;
  auto prefetch = [&](int step) {  // this lane's gi of `step` into its slot; one group per step
    if (step < T && on) {
      const float* gi = xp + (int64_t)(dir.reverse ? T - 1 - step : step) * a.st;
#pragma unroll
      for (int g = 0; g < 3; ++g) cp_async4(&gs[warp][step % NSLOT][g * H + lane], gi + g * hn);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) prefetch(i);
  float h = 0.0f;
  for (int step = 0; step < T; ++step) {
    const int t = dir.reverse ? T - 1 - step : step;
    cp_async_wait(AHEAD - 1);  // this step's gi has landed (each lane reads only what it copied)
    const float* slot = &gs[warp][step % NSLOT][lane];
    const float gr = slot[0], gz = slot[H], gn = slot[2 * H];
    prefetch(step + AHEAD);  // into the slot read one step ago
    float* hb = hs[warp][step & 1];
    hb[lane] = on ? h : 0.f;
    __syncwarp();
    float ar = br, az = bz, an = bn;
#pragma unroll
    for (int k = 0; k < H; k += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(hb + k);
      ar = fmaf(hv.x, wr[k], ar);
      az = fmaf(hv.x, wz[k], az);
      an = fmaf(hv.x, wn[k], an);
      ar = fmaf(hv.y, wr[k + 1], ar);
      az = fmaf(hv.y, wz[k + 1], az);
      an = fmaf(hv.y, wn[k + 1], an);
      ar = fmaf(hv.z, wr[k + 2], ar);
      az = fmaf(hv.z, wz[k + 2], az);
      an = fmaf(hv.z, wn[k + 2], an);
      ar = fmaf(hv.w, wr[k + 3], ar);
      az = fmaf(hv.w, wz[k + 3], az);
      an = fmaf(hv.w, wn[k + 3], an);
    }
    h = gru_cell(gr, gz, gn, ar, az, an, h);
    if (on) out[t * ostep] = h;
  }
  cp_async_wait(0);
}

// ------------------------------------------------- other H: cooperative

constexpr int LU = 8;          // hidden units a CTA owns
constexpr int LG = 3 * LU;     // its gate columns: r, z, n of each unit
constexpr int LNC = 64;        // sequences per chunk
constexpr int LNCP = LNC + 8;  // padded row of h in shared memory: conflict-free A fragments
constexpr int LWARPS = 8;      // the K split
constexpr int LTHREADS = LWARPS * 32;
constexpr int LKS = 8;         // most 8-deep k-steps a warp holds
constexpr int LMAX_H = 8 * LKS * LWARPS;

size_t large_smem_bytes(int H) { return sizeof(float) * ((size_t)H * LNCP + (size_t)LWARPS * LNC * LG); }

// PART: H not a multiple of 8, run as Hp = H rounded up to 8 (hs, hbuf and
// the k-steps over Hp rows; units and rows past H zero).
template <bool PART = false>
__global__ void __launch_bounds__(LTHREADS, 1) gru_large_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float sm[];
  const int H = a.H, Hp = PART ? (H + 7) / 8 * 8 : H, P = Hp / LU;
  const int d = blockIdx.x / P, p = blockIdx.x % P;
  const Dir dir = d ? a.dir[1] : a.dir[0];
  float* hs = sm;               // [Hp][LNCP]  h_{t-1}, each warp its K-slice
  float* red = hs + Hp * LNCP;  // [LWARPS][LNC][LG]  partial products
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;  // the mma fragment coordinates
  const int ks_all = Hp / 8, ks0 = warp * ks_all / LWARPS, nks = (warp + 1) * ks_all / LWARPS - ks0;
  // B fragments of this warp's k-steps: column n = gate * 8 + unit of the
  // CTA's 24 rows of w_hh, split into tf32 hi / lo, held for the whole launch
  uint32_t bh[LKS][3][2], bl[LKS][3][2];
#pragma unroll
  for (int i = 0; i < LKS; ++i) {
    if (i < nks) {
      const int k = (ks0 + i) * 8 + t4;
      const bool unit = !PART || p * LU + g8 < H;
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        const float* row = dir.w + ((int64_t)gate * H + p * LU + g8) * H;
        split_tf32(unit && (!PART || k < H) ? __ldg(row + k) : 0.f, bh[i][gate][0], bl[i][gate][0]);
        split_tf32(unit && (!PART || k + 4 < H) ? __ldg(row + k + 4) : 0.f, bh[i][gate][1], bl[i][gate][1]);
      }
    }
  }
  // the gate threads: unit j of the CTA, chunk rows m0 and m0 + LNC / 2
  const int j = threadIdx.x % LU, m0 = threadIdx.x / LU;
  const bool mine = !PART || p * LU + j < H;  // a unit of the H (else its h stays 0)
  float bias[3];
#pragma unroll
  for (int gate = 0; gate < 3; ++gate) bias[gate] = mine ? dir.b[gate * H + p * LU + j] : 0.f;
  const int64_t ocols = (int64_t)a.ndir * H;
  const int64_t hdir = (int64_t)Hp * LNC;  // one direction's h in the ping-pong buffer
  int pp = 0;  // the half of hbuf that holds h_{t-1}
  for (int c0 = 0; c0 < a.N; c0 += LNC) {  // every CTA runs every chunk and step: no early exit
    float hold[2] = {0.0f, 0.0f};
    for (int step = 0; step < a.T; ++step) {
      const int t = dir.reverse ? a.T - 1 - step : step;
      float gi[2][3];  // in flight during the product
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = c0 + m0 + r * (LNC / 2);
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
          gi[r][gate] = n < a.N && mine
                            ? __ldg(dir.xp + (int64_t)n * a.sn + (int64_t)t * a.st + gate * H + p * LU + j)
                            : 0.0f;
      }
      if (step > 0) {
        // h_{t-1}[k][m] of this warp's k-steps from L2, one cp.async group
        // per k-step (.cg skips L1, which is not coherent with the other
        // SMs' writes)
        const float* src = a.hbuf + (int64_t)(pp * a.ndir + d) * hdir;
#pragma unroll
        for (int i = 0; i < LKS; ++i) {
          if (i < nks) {
            for (int c = lane; c < 8 * (LNC / 4); c += 32) {
              const int k = (ks0 + i) * 8 + c / (LNC / 4), q = (c % (LNC / 4)) * 4;
              cp_async16(hs + k * LNCP + q, src + k * LNC + q);
            }
            cp_async_commit();
          }
        }
        float acc[LNC / 16][3][4];
#pragma unroll
        for (int mt = 0; mt < LNC / 16; ++mt)
#pragma unroll
          for (int gate = 0; gate < 3; ++gate)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][gate][e] = 0.0f;
#pragma unroll
        for (int i = 0; i < LKS; ++i) {
          if (i < nks) {
            cp_async_wait(nks - 1 - i);
            __syncwarp();
            const float* hk = hs + ((ks0 + i) * 8 + t4) * LNCP + g8;
#pragma unroll
            for (int mt = 0; mt < LNC / 16; ++mt) {
              uint32_t ah[4], al[4];
              split_tf32(hk[mt * 16], ah[0], al[0]);
              split_tf32(hk[mt * 16 + 8], ah[1], al[1]);
              split_tf32(hk[4 * LNCP + mt * 16], ah[2], al[2]);
              split_tf32(hk[4 * LNCP + mt * 16 + 8], ah[3], al[3]);
#pragma unroll
              for (int gate = 0; gate < 3; ++gate) {  // small terms first
                mma_tf32(acc[mt][gate], al, bh[i][gate][0], bh[i][gate][1]);
                mma_tf32(acc[mt][gate], ah, bl[i][gate][0], bl[i][gate][1]);
                mma_tf32(acc[mt][gate], ah, bh[i][gate][0], bh[i][gate][1]);
              }
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < LNC / 16; ++mt) {
#pragma unroll
          for (int gate = 0; gate < 3; ++gate) {
            float* dst = red + (warp * LNC + mt * 16 + g8) * LG + gate * LU + 2 * t4;
            *reinterpret_cast<float2*>(dst) = make_float2(acc[mt][gate][0], acc[mt][gate][1]);
            *reinterpret_cast<float2*>(dst + 8 * LG) = make_float2(acc[mt][gate][2], acc[mt][gate][3]);
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + r * (LNC / 2);
        float gh[3];
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          float sum = 0.0f;
          if (step > 0) {
#pragma unroll
            for (int w = 0; w < LWARPS; ++w) sum += red[(w * LNC + m) * LG + gate * LU + j];
          }
          gh[gate] = sum + bias[gate];
        }
        const float hn = gru_cell(gi[r][0], gi[r][1], gi[r][2], gh[0], gh[1], gh[2], hold[r]);
        hold[r] = hn;
        const int n = c0 + m;
        if (n < a.N && mine) a.out[((int64_t)n * a.T + t) * ocols + d * H + p * LU + j] = hn;
        a.hbuf[(int64_t)((pp ^ 1) * a.ndir + d) * hdir + (p * LU + j) * LNC + m] = hn;
      }
      pp ^= 1;
      grid.sync();  // h_t complete in L2 for every CTA; this step's reads of hs and red done
    }
  }
}

}  // namespace

// One or both directions of the GRU recurrence.  Direction d reads
// x_proj_d (N, T, 3H) at element n * sn + t * st + g (g contiguous), w_hh_d
// (3H, H) and b_hh_d (3H), and writes out[:, :, d*H : (d+1)*H] of out
// (N, T, ndir * H); with ndir = 2 direction 0 runs forward and direction 1
// reversed, with ndir = 1 the one direction follows `reverse`.  All float32
// on the device of `stream`.  H up to 32 takes the register regime; any H
// above 32 up to 512 the cooperative one, which needs `hbuf`, 2 * ndir * Hp
// * 64 floats of scratch (Hp = H rounded up to 8), and its ndir * Hp / 8
// CTAs co-resident (else it returns cudaErrorCooperativeLaunchTooLarge and
// launches nothing).  Returns the first CUDA error of the launch, 0 when
// there is none.
extern "C" int gru_scan_forward(const float* xp0, const float* xp1, const float* w0, const float* w1,
                                const float* b0, const float* b1, float* out, float* hbuf, int N, int T, int H,
                                int ndir, int reverse, long long sn, long long st, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (H <= 0 || H > LMAX_H || N <= 0 || T <= 0 || ndir < 1 || ndir > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.dir[0] = Dir{xp0, w0, b0, ndir == 2 ? 0 : (reverse != 0)};
  a.dir[1] = Dir{xp1, w1, b1, 1};
  a.out = out;
  a.hbuf = hbuf;
  a.N = N;
  a.T = T;
  a.H = H;
  a.ndir = ndir;
  a.sn = sn;
  a.st = st;
  if (H <= SMALL_H) {
    const dim3 grid((N + SMALL_WARPS - 1) / SMALL_WARPS, ndir);
    if (H == SMALL_H)
      gru_small_kernel<<<grid, SMALL_WARPS * 32, 0, cs>>>(a);
    else
      gru_small_kernel<true><<<grid, SMALL_WARPS * 32, 0, cs>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (hbuf == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int Hp = (H + 7) / 8 * 8;
  const size_t smem = large_smem_bytes(Hp);
  auto kern = H == Hp ? gru_large_kernel<false> : gru_large_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, LTHREADS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int blocks = ndir * (Hp / LU);
  if (blocks > per_sm * sms) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(blocks), dim3(LTHREADS), params, smem,
                                    cs);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
