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
// One kernel; g never reaches device memory.  Persistent CTAs of two
// warpgroups walk the output tiles (image, 384 rows of y, a block of 8 x 16
// positions of the s x s plane) as a stream of chunks of 32 channels.  Per
// chunk:
//   * the loads, by cp.async: the chunk's weight rows (W is read from L2:
//     at 590 KB it does not stay in shared memory) and the block's rows and
//     columns with a one-wide halo (10 x 18 values a channel, zero outside
//     the image: the stencil's padding), with the depthwise weights;
//   * every thread computes the stencil + GELU of 4 positions of one
//     channel from the staged block, and g and W go, split into tf32 hi and
//     lo, into shared memory with the 128-byte swizzle: W as the A operand
//     [row][k], g as the B operand [position][k], both K-major as TF32 wgmma
//     requires;
//   * the mix runs on wgmma m64n128k8 at 3xTF32 (hi*lo + lo*hi + hi*hi into
//     float32): warpgroup w owns rows [192 w, 192 w + 192) of the tile as
//     three 64-row accumulators (192 registers a thread).
// A warp that hands a wgmma to the tensor cores waits until they take it,
// so the products and the building of the next chunk follow one another
// whatever the staging; one operand stage, and the next chunk's loads start
// just before the products and land meanwhile.  A CTA spans all 384 rows so
// that the stencil and the staging of each position are done once, not
// once per row group.  Every sum has a fixed order and nothing is
// accumulated across CTAs: reruns agree bit for bit.
//
// What bounds it on an H100 at B = 64 and the flagship Mlp (HW = 1024,
// s = 32, hidden = 384), each input read once and each output written once:
// 201 MB (x and the output) = 60 us at 3.35 TB/s; 19.8 GFLOP (the mix
// 2 B hidden^2 HW = 19.3, the stencil 2 x 9 B hidden HW = 0.45) = 295 us at
// 67 TFLOP/s float32; the mix as 3xTF32 on the tensor cores, 3 x 19.3 GFLOP
// at 495 TFLOP/s = 117 us.  Its times, beside the cuDNN depthwise + GELU +
// 1x1 pair the port's Mlp runs, stand in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int KC = 32;                    // channels a chunk: one 128-byte swizzle row of tf32
constexpr int TR = 8, TC = 16;            // a tile's block of positions: rows x columns of the plane
constexpr int BN = TR * TC;               // positions a tile: the wgmma's N
constexpr int HR = TR + 2, HC = TC + 2;   // the block with its halo
constexpr int HP = HR * HC + 1;           // floats a channel of the staged block (odd: no bank conflicts)
constexpr int X_FL = (KC * HP + KC * 9 + KC + 3) / 4 * 4;  // the staged block + depthwise weights and biases
constexpr int WGS = 2;                    // warpgroups
constexpr int MBW = 3;                    // 64-row blocks a warpgroup: w owns tile rows [192 w, 192 w + 192)
constexpr int BM = 64 * MBW * WGS;        // rows of y a tile
constexpr int THREADS = 128 * WGS;
constexpr int A_FL = BM * KC;             // floats of the A operand of a chunk (hi or lo)
constexpr int B_FL = BN * KC;             // floats of the B operand of a chunk (hi or lo)
constexpr int STAGE_FL = 2 * A_FL + 2 * B_FL;
constexpr size_t SMEM_BYTES = (STAGE_FL + X_FL + BM * KC) * sizeof(float) + 1024;  // + the 1024-byte alignment
constexpr int W_PIECES = BM * KC / 4 / THREADS;  // 16-byte pieces of W a thread a chunk
constexpr int X_ROWS = (KC * HR / 2 + THREADS / 32 - 1) / (THREADS / 32);  // row pairs of the block a warp
constexpr int X_HALO = (KC * HR * 2 + THREADS - 1) / THREADS;              // halo values a thread
static_assert(BM * KC / 4 % THREADS == 0, "W pieces must divide among the threads");

__device__ __forceinline__ float gelu_erf(float x) { return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f)); }

// Float offset of element (row, k < 32) of a [rows][32] tf32 tile stored with
// the 128-byte swizzle: row r is 128 bytes at r * 128, and its 16-byte piece
// j sits at piece j ^ (r mod 8).  8-row groups are 1024 bytes apart.
__device__ __forceinline__ int swz(int row, int k) { return row * KC + ((((k >> 2) ^ row) & 7) << 2) + (k & 3); }

// The wgmma descriptor of a K-major operand in that layout, starting at p
// (the tile's base, 1024-byte aligned, + 32 bytes per k-step of 8): start
// address >> 4, leading offset 1 (not read for swizzled K-major), stride
// offset 1024 bytes (the next 8 rows), layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (64 x 128, this warpgroup's fragment) += A (64 x 8) . B (128 x 8)^T,
// both tf32 from shared memory.  Fragment: thread (warp w, lane = 4 g + t)
// holds d[4 j + 2 h + e] = D[16 w + g + 8 h][8 j + 2 t + e].
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products.
__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory writes of this thread made visible to the tensor cores'
// (async proxy) reads after the next barrier.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void store_split(float* hi, float* lo, const float (&v)[4]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) split_tf32_fast(v[j], h[j], l[j]);
  *reinterpret_cast<float4*>(hi) =
      make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
  *reinterpret_cast<float4*>(lo) =
      make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// 4 bytes from gmem when `valid`, else 4 zero bytes (gmem is not read).
__device__ __forceinline__ void cp_async4_zfill(float* smem, const float* gmem, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

// The loads of one chunk, by cp.async as one committed group: W rows [m0,
// m0 + BM) x channels [k0, k0 + KC) (rows past M zero) into ws [BM][KC];
// the block of positions rows [r0, r0 + TR) x columns [c0, c0 + TC) of
// those channels with its one-wide halo into xs as [k][HR][HC] at pitch HP
// a channel (zero outside the image: the stencil's padding; a warp copies
// the TC inner columns of two rows at a time, then the halo columns), then
// the channels' depthwise weights [k][9] and biases [k].
__device__ __forceinline__ void fetch(float* xs, float* ws, const float* __restrict__ xb,
                                      const float* __restrict__ dw_w, const float* __restrict__ dw_b,
                                      const float* __restrict__ pw_w, int k0, int m0, int M, int r0, int c0, int s) {
  static_assert(TC == 16, "two rows of the block's inner columns a warp");
  int tid = threadIdx.x;
  // The thread's offsets below are recomputed in every call: hoisted out of
  // the chunk loop they would take registers that the accumulators need.
  asm volatile("" : "+r"(tid));
  const int lane = tid & 31;
  const int64_t N = (int64_t)s * s;
#pragma unroll
  for (int i = 0; i < W_PIECES; ++i) {
    const int e = tid + i * THREADS, m = m0 + (e >> 3);
    cp_async16_zfill(ws + 4 * e, m < M ? pw_w + (int64_t)m * M + k0 + 4 * (e & 7) : pw_w, m < M);
  }
  const int col = c0 + (lane & 15);
#pragma unroll
  for (int i = 0; i < X_ROWS; ++i) {  // (channel, halo row) pairs, inner columns
    const int seg = 2 * ((tid >> 5) + i * (THREADS / 32)) + (lane >> 4), kk = seg / HR, hr = seg - kk * HR;
    const int row = r0 - 1 + hr;
    const bool ok = row >= 0 && row < s && col < s;
    if (seg < KC * HR)
      cp_async4_zfill(xs + kk * HP + hr * HC + 1 + (lane & 15), ok ? xb + (k0 + kk) * N + row * s + col : xb, ok);
  }
#pragma unroll
  for (int i = 0; i < X_HALO; ++i) {  // the halo columns 0 and HC - 1
    const int e = tid + i * THREADS, seg = e >> 1, kk = seg / HR, hr = seg - kk * HR;
    const int row = r0 - 1 + hr, hc = (e & 1) * (HC - 1), cc = c0 - 1 + hc;
    const bool ok = row >= 0 && row < s && cc >= 0 && cc < s;
    if (e < KC * HR * 2) cp_async4_zfill(xs + kk * HP + hr * HC + hc, ok ? xb + (k0 + kk) * N + row * s + cc : xb, ok);
  }
  for (int e = tid; e < KC * 10; e += THREADS)
    cp_async4_zfill(xs + KC * HP + e, e < KC * 9 ? dw_w + k0 * 9 + e : dw_b + k0 + e - KC * 9, true);
  cp_async_commit();
}

// One chunk's operands into stage st, from the fetched xs and ws: every
// thread computes the stencil + GELU of 4 positions of its channel (its
// lane) at a time, and B = g at the tile's positions (n = 16 row + column
// within the block; positions outside the image zero), then A = W are
// stored as hi and lo.
__device__ __forceinline__ void build(float* st, const float* xs, const float* ws, int rmax, int cmax) {
  float* ahi = st;
  float* alo = st + A_FL;
  float* bhi = st + 2 * A_FL;
  float* blo = bhi + B_FL;
  int tid = threadIdx.x;
  asm volatile("" : "+r"(tid));  // as in fetch
  const int k = tid & 31;        // THREADS % 32 == 0
  float w9[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) w9[t] = xs[KC * HP + k * 9 + t];
  const float bias = xs[KC * HP + KC * 9 + k];
  for (int e = tid; e < KC * BN / 4; e += THREADS) {  // (channel, block row, 4 columns); a warp: 32 channels
    const int rest = e >> 5, lr = rest / (TC / 4), c4 = 4 * (rest % (TC / 4));
    const float* h = xs + k * HP + lr * HC + c4;  // halo rows lr .. lr + 2, columns c4 .. c4 + 5
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int di = 0; di < 3; ++di) {  // a halo row at a time (registers: the accumulators hold 192 values)
      float v[6];
#pragma unroll
      for (int dj = 0; dj < 6; ++dj) v[dj] = h[di * HC + dj];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) acc[p] = fmaf(v[p + dj], w9[di * 3 + dj], acc[p]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float g = lr < rmax && c4 + p < cmax ? gelu_erf(acc[p] + bias) : 0.f;
      uint32_t hi, lo;
      split_tf32_fast(g, hi, lo);
      const int n = lr * TC + c4 + p, off = swz(n, k);
      bhi[off] = __uint_as_float(hi);
      blo[off] = __uint_as_float(lo);
    }
  }
#pragma unroll 2
  for (int i = 0; i < W_PIECES; ++i) {  // a few pieces at a time (registers)
    const int e = tid + i * THREADS, r = e >> 3, kk = 4 * (e & 7);
    const float4 w = *reinterpret_cast<const float4*>(ws + 4 * e);
    const float v[4] = {w.x, w.y, w.z, w.w};
    store_split(ahi + swz(r, kk), alo + swz(r, kk), v);
  }
}

// A tile: image b, rows [m0, m0 + BM) of y, the block of positions at
// (r0, c0).  Consecutive tiles are the row groups of one block (they read
// the same x).
struct Tile {
  int b, m0, r0, c0;
};

__device__ __forceinline__ Tile tile_at(int tile, int nmg, int nblk, int nbc) {
  const int mg = tile % nmg, blk = (tile / nmg) % nblk;
  return Tile{tile / (nmg * nblk), mg * BM, blk / nbc * TR, blk % nbc * TC};
}

// d (one 64-row block) += A . B^T over one chunk, hi and lo: the three
// products of each k-step, the small terms first.
__device__ __forceinline__ void mix_chunk(float (&d)[64], const float* ahi, const float* bhi) {
  const float* alo = ahi + A_FL;
  const float* blo = bhi + B_FL;
#pragma unroll
  for (int ks = 0; ks < KC / 8; ++ks) {  // 32 bytes of each row a k-step
    wgmma_tf32(d, sw128_desc(ahi + 8 * ks), sw128_desc(blo + 8 * ks));
    wgmma_tf32(d, sw128_desc(alo + 8 * ks), sw128_desc(bhi + 8 * ks));
    wgmma_tf32(d, sw128_desc(ahi + 8 * ks), sw128_desc(bhi + 8 * ks));
  }
}

// y = acc + bias for the 64 rows [m0, m0 + 64) of a tile (those below M),
// and the accumulator zeroed.
__device__ __forceinline__ void store_y(float (&acc)[64], float* __restrict__ ob, const float* __restrict__ pw_b,
                                        int m0, int M, int r0, int c0, int s) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, t4 = lane & 3;
  const int N = s * s, rmax = s - r0, cmax = s - c0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 16 * warp + (lane >> 2) + 8 * h;
    if (m >= M) continue;
    const float bias = __ldg(pw_b + m);
    float* orow = ob + (int64_t)m * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {  // columns 8 j + 2 t4 (+ 1): block row j / 2, column 8 (j % 2) + 2 t4
      const int lr = j / 2, lc = 8 * (j % 2) + 2 * t4;
      if (lr >= rmax || lc >= cmax) continue;
      const int n = (r0 + lr) * s + c0 + lc;
      const float v0 = acc[4 * j + 2 * h] + bias, v1 = acc[4 * j + 2 * h + 1] + bias;
      if ((s & 1) == 0 && lc + 1 < cmax) {
        *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
      } else {
        orow[n] = v0;
        if (lc + 1 < cmax) orow[n + 1] = v1;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
}

// Each CTA walks its tiles blockIdx.x, + gridDim.x, ... as one stream of
// (tile, channel chunk) steps g: step g starts the loads of chunk g + 1,
// runs the products of chunk g, then builds chunk g + 1, so a tile's first
// chunk is prepared during the previous tile's last.
__global__ void __launch_bounds__(THREADS, 1)
    mlp_convs_kernel(const float* __restrict__ x, const float* __restrict__ dw_w, const float* __restrict__ dw_b,
                     const float* __restrict__ pw_w, const float* __restrict__ pw_b, float* __restrict__ out, int B,
                     int s, int M) {
  extern __shared__ float sm_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(sm_raw));
  float* sm = sm_raw + ((1024 - (raw & 1023)) & 1023) / sizeof(float);  // the swizzle needs 1024-byte atoms
  float* xs = sm + STAGE_FL;  // the staged block of positions
  float* ws = xs + X_FL;      // the staged W rows
  const int N = s * s, nk = M / KC;
  const int nmg = (M + BM - 1) / BM, nbc = (s + TC - 1) / TC, nblk = (s + TR - 1) / TR * nbc;
  const int ntile = B * nblk * nmg;
  const int mine = (int)blockIdx.x < ntile ? (ntile - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int steps = mine * nk;
  if (steps == 0) return;
  const int wg = threadIdx.x >> 7;
  auto tile_of = [&](int g) { return tile_at(blockIdx.x + g / nk * gridDim.x, nmg, nblk, nbc); };
  auto fetch_step = [&](int g) {  // the loads of step g into xs and ws
    const Tile t = tile_of(g);
    fetch(xs, ws, x + (int64_t)t.b * N * M, dw_w, dw_b, pw_w, g % nk * KC, t.m0, M, t.r0, t.c0, s);
  };
  auto build_step = [&](int g) {  // step g's operands, once its loads have landed and the products are done
    const Tile t = tile_of(g);
    cp_async_wait(0);
    __syncthreads();
    build(sm, xs, ws, s - t.r0, s - t.c0);
  };
  float a0[64], a1[64], a2[64];  // the warpgroup's three 64-row blocks
#pragma unroll
  for (int i = 0; i < 64; ++i) a0[i] = a1[i] = a2[i] = 0.f;
  fetch_step(0);
  build_step(0);
  const float* ahi = sm + wg * MBW * 64 * KC;
  const float* bhi = sm + 2 * A_FL;
  // Every warpgroup starts its products, also for rows past M (zero rows of
  // A): a product in a divergent branch makes the compiler serialize every
  // wgmma of the kernel.  Handing a wgmma to the tensor cores waits until
  // they take it; the next chunk's loads, started just before, land
  // meanwhile.
  for (int g = 0; g < steps; ++g) {
    fence_async_shared();
    __syncthreads();  // step g's operands are in shared memory; xs and ws are free
    if (g + 1 < steps) fetch_step(g + 1);
    acc_fence(a0);
    acc_fence(a1);
    acc_fence(a2);
    wgmma_fence();
    mix_chunk(a0, ahi, bhi);
    mix_chunk(a1, ahi + 64 * KC, bhi);
    mix_chunk(a2, ahi + 128 * KC, bhi);
    wgmma_commit();
    wgmma_wait_all();
    acc_fence(a0);
    acc_fence(a1);
    acc_fence(a2);
    if (g % nk == nk - 1) {  // the tile's last chunk: y = acc + bias
      const Tile t = tile_of(g);
      const int m0 = t.m0 + wg * MBW * 64;
      float* ob = out + (int64_t)t.b * M * N;
      store_y(a0, ob, pw_b, m0, M, t.r0, t.c0, s);
      store_y(a1, ob, pw_b, m0 + 64, M, t.r0, t.c0, s);
      store_y(a2, ob, pw_b, m0 + 128, M, t.r0, t.c0, s);
    }
    if (g + 1 < steps) build_step(g + 1);
  }
}

}  // namespace

// Shapes: x, out (B, HW, hidden) with HW = s*s, float32, contiguous, 16-byte
// aligned; dw_w (hidden, 1, 3, 3) and pw_w (hidden, hidden, 1, 1), torch
// Conv2d layouts; dw_b, pw_b (hidden).  Needs hidden % 32 == 0 (the Python
// wrapper checks it and that HW is a perfect square).  Returns
// cudaGetLastError() after the launch (or the first failing call).
extern "C" int mlp_convs_forward(const float* x, const float* dw_w, const float* dw_b, const float* pw_w,
                                 const float* pw_b, float* out, int B, int s, int hidden, void* stream) {
  if (hidden % KC != 0 || hidden < KC || s < 1 || B < 1 || (reinterpret_cast<uintptr_t>(pw_w) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntile = B * ((s + TR - 1) / TR) * ((s + TC - 1) / TC) * ((hidden + BM - 1) / BM);
  int sms = 0;
  cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaFuncSetAttribute(mlp_convs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(SMEM_BYTES))) != cudaSuccess)
    return static_cast<int>(err);
  mlp_convs_kernel<<<ntile < sms ? ntile : sms, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      x, dw_w, dw_b, pw_w, pw_b, out, B, s, hidden);
  return static_cast<int>(cudaGetLastError());
}
