// The training forward and backward of a whole PGRM window attention with
// SKConv fused in, for sm_90a.
//
// Replaces the TPU kernel pair dpmn_tpu/ops/pallas_window_train.py::
// window_attention_full_core: the forward _full_fwd (pallas_call at :766)
// and the recomputing backward _full_bwd_impl (pallas_call at :952), the
// path the JAX package takes with DPMN_TPU_FUSE_SKCONV=1 on the faithful
// layout.  For pre-norm tokens xq, xkv of shape (B, L = H*W, D):
//   forward  K3's function (LN of both streams, the q / kv projections, the
//            grouped window attention with dropout, the faithful raw layout)
//            into tokens t, then SKConv without the residual: feats = t Wp^T
//            + bp; s = the mean over the L tokens of gelu(feats); u = fc1 s;
//            z = gelu(u); a = fc2 z; w = softmax over the groups of a;
//            out = feats + (sum_j t_j * w_j) Wph^T + bph (exact erf GELU).
//            Besides out it hands the backward the tokens t, the per-tile
//            GAP sums of gelu(feats) and the gate w (the caller keeps them);
//   backward from the primal inputs, those three and dout: recompute LN and
//            the projections (q and kv, for the attention backward);
//            SKConv's backward in two token passes — (A) dfv = dout Wph,
//            fv = sum_j t_j * w_j, dw_j = sum over the image's tokens of dfv
//            * t_j, dWph = dout^T fv — then the softmax, fc2, GELU and fc1
//            backward per image to dgap = ds / L, then (B) feats recomputed,
//            dfeats = dout + dgap * gelu'(feats), dt = dfeats Wp + dfv * w_j,
//            dWp = dfeats^T t; then K3's attention backward from dt and K3's
//            projection and LN backward.
// The TPU kernel recomputes the attention twice and accumulates every
// weight gradient in resident VMEM over its sequential grid; here the
// forward keeps what the backward would recompute, and blocks on the card
// run in no order, so every cross-block sum goes through per-block partials
// and a fixed-order second pass (sum_rows_kernel, or one thread per output
// summing over the images): no float atomics, so reruns agree bit for bit.
//
// What bounds it on an H100 at B = 64 and the flagship geometry (L = 1024,
// D = 96, windows 2/4/8, 2 heads of 16 per group, dz = 16), each input read
// once and each output written once: forward 75.5 MB (xq, xkv, out) and
// 5.94 GFLOP (K3's 4.33, SKConv's 1.61) = 89 us at 67 TFLOP/s float32;
// backward 126 MB (xq, xkv, dout, dxq, dxkv) and 17.81 GFLOP (K3's
// backward 12.63, the tokens' P v 0.35, the recomputed SKConv forward 1.61,
// its backward 3.22) = 266 us (the row's bound, the function's work; this
// backward skips the tokens' P v and most of SKConv's forward).  Both are
// bound by operations.  Every product runs on the tensor cores (mma.sync,
// 3xTF32, tc_common.cuh) on persistent CTAs that stage their weight once,
// and so does the forward attention of the 4x4 and 8x8 windows
// (window_common.cuh window_attn_fwd_kernel); the 2x2 windows' attention
// runs on the CUDA cores; q, kv and the tokens' gradient still round-trip
// through device memory.
//
// bf16 io (the bf16 AMP step under DPMN_TPU_FUSE_SKCONV=1; the JAX kernel on
// bf16 inputs takes dt = xq.dtype, :716 and :791): xq, xkv, the 16 weights,
// out, dout, dxq, dxkv and the weight gradients bf16; the bias, the mask,
// dbias and what the forward keeps float32.  The JAX kernel's rounding
// points (_full_fwd :706-775, _full_bwd_impl :778-973): the LN in float32
// rounded to bf16, q / kv summed in float32 with their bias and rounded, q
// times the scale rounded to bf16 and the product rounded, P rounded once
// before P v; the attention's tokens float32 and unrounded (tok_sc, :740,
// :772); SKConv in float32 on them with the weights widened (:749-754), out
// rounded once.  Backward: dout widened; SKConv's backward in float32; the
// tokens' gradient rounded to bf16 before the attention backward (:902); P*M
// and dS rounded before their products, dbias from the unrounded dS; dq /
// dkv in float32, rounded before the projection backward (:917-933; the
// bias sums take them unrounded); the 16 weight gradients summed in float32
// and rounded once (:971).  The forward runs K3's one-launch bf16 forward
// writing float32 tokens (window_block_fwd_bf16_kernel<DROP, float>: LN,
// projections and attention, q and kv kept in shared memory) and SKConv on
// bf16 weights in float32 sums (launch_skconv_t<bf16>, K1's bf16 tail
// without the residual): 4 launches.  The
// backward reads every bf16 tensor as it is (21 launches at three window
// groups): q and kv recomputed in bf16 (ln_proj_bf16_kernel); SKConv's
// backward in float32 (its products at 3xTF32) on dout and the weights
// widened as they are staged, the tokens' gradient stored rounded to bf16
// (skconv_bwd_b_kernel<D, bf16>) and the fc / proj / proj_head gradients
// rounded once by the kernels that finish their sums; then K3's bf16
// attention and projection backward (window_train_common.cuh: products on
// bf16 m16n8k16, dxq, dxkv and the LN, q and kv gradients written as bf16).
// No float32 copy of xq, xkv, dout, q, kv or the weights is made.
// Bound at B = 64, flagship geometry: forward 37.7 MB of bf16 (xq, xkv,
// out) = 11 us, and 4.33 GFLOP on bf16 operands at 989 TFLOP/s plus SKConv's
// 1.61 in float32 at 67 = 28 us; backward 62.9 MB = 19 us, and 12.98 GFLOP
// on bf16 operands plus 4.83 in float32 = 85 us; both bound by operations.

#include "window_train_common.cuh"

using bf16 = __nv_bfloat16;

namespace {

__device__ __forceinline__ float gelu_erf_grad(float x) {
  return 0.5f * (1.0f + erff(x * 0.70710678118654752440f)) + x * expf(-0.5f * x * x) * 0.3989422804014327f;
}

// The warp layout of a transposed product dW (R x c) = dy^T x over a tile's
// TOK tokens, as wgrad_kernel's: warp w owns the m-tiles of rows [(w / 4)
// R/2, (w / 4 + 1) R/2) and the n-tiles of columns [(w % 4) P, (w % 4 + 1)
// P), P = 8 ceil(c / 32); R a multiple of 16 up to 96 (R / 16 m-tiles, the
// first warp row taking the odd one), c a multiple of 8 up to 96.
struct WgradWarp {
  int mt, m0, nt, n0;
  __device__ static WgradWarp make(int R, int c) {
    const int warp = threadIdx.x >> 5, ct = c / 8, per = (ct + 3) / 4, first = (R / 16 + 1) / 2;
    return WgradWarp{(warp >> 2) ? R / 16 - first : first, (warp >> 2) * first * 16,
                     min(per, max(0, ct - (warp & 3) * per)), (warp & 3) * per * 8};
  }
};

// A CTA's [dW (R x c) | db (R)] partial row: the transposed product's
// fragments and the per-thread bias sums of threads [b0, b0 + R).
__device__ __forceinline__ void store_wgrad_part(float* __restrict__ p, const float (&acc)[3][3][4],
                                                 const WgradWarp& ww, int c, float bacc, int R, int b0) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (i < ww.mt && j < ww.nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = ww.m0 + 16 * i + g8 + 8 * h, col = ww.n0 + 8 * j + 2 * t4;
          *reinterpret_cast<float2*>(p + o * c + col) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
  if (threadIdx.x >= b0 && threadIdx.x < b0 + R) p[R * c + threadIdx.x - b0] = bacc;
}

// Stage W (rows x k, row-major, float32 or bf16) transposed into shared
// memory as float32 [k][ld].
template <typename T>
__device__ __forceinline__ void stage_cols(float* dst, const T* __restrict__ w, int rows, int k, int ld) {
  for (int idx = threadIdx.x; idx < rows * k; idx += blockDim.x) dst[(idx % k) * ld + idx / k] = ldg_one(w + idx);
}

// load_tile for bf16 rows widened to float32 as they land: plain 16-byte
// loads, each stored as two float4 (rows past ntok are zero).  c % 8 == 0;
// rows 16-byte aligned.
__device__ __forceinline__ void load_tile_widen(float* dst, int ld, const __nv_bfloat16* __restrict__ x, int64_t t0,
                                                int ntok, int c, int64_t row_stride) {
  const int c8 = c / 8;
  for (int e = threadIdx.x; e < TOK * c8; e += blockDim.x) {
    const int r = e / c8, k = (e % c8) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < ntok) u = __ldg(reinterpret_cast<const uint4*>(x + (t0 + r) * row_stride + k));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    const float2 c2 = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
    *reinterpret_cast<float4*>(dst + r * ld + k) = make_float4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<float4*>(dst + r * ld + k + 4) = make_float4(c2.x, c2.y, d.x, d.y);
  }
}

// A tile of dout (float32 by cp.async, bf16 widened as it lands).
__device__ __forceinline__ void load_dout_tile(float* dst, int ld, const float* __restrict__ x, int64_t t0, int ntok,
                                               int c) {
  load_tile(dst, ld, x, t0, ntok, c, c);
}
__device__ __forceinline__ void load_dout_tile(float* dst, int ld, const __nv_bfloat16* __restrict__ x, int64_t t0,
                                               int ntok, int c) {
  load_tile_widen(dst, ld, x, t0, ntok, c, c);
}

// SKConv backward, pass A, on persistent CTAs over the tiles of TOK tokens
// (a tile lies in one image; dout and t tiles by cp.async, two stages):
//   dfv = dout Wph (tensor cores; Wph (D, ch) staged transposed once), to
//         device memory and shared memory;
//   fv = sum_j t_j * w_j (the proj_head input) into shared memory;
//   dwpart[tile][m] = sum over the tile's tokens of dfv[c] * t[m], c = m mod
//         ch (threads [0, D), rows in order);
//   the CTA's dWph += dout^T fv (tensor cores) and dbph += the tile's sums
//         of dout (threads [D, 2D)), written as its partial row [dWph (D x
//         ch) | dbph (D)] at the end.
// Shared: wt [ch][D + 4], dos, ts [2][TOK][D + 4], fvs [TOK][ch + 8] (token-
// major B operand), dfs [TOK][ch + 4], gs [2][D] (the tile's gate, with
// the tile by cp.async).  T: the type of dout and Wph (bf16: widened to
// float32 as they are staged, the arithmetic float32 as the JAX kernel's).
template <int D, typename T = float>
__global__ void __launch_bounds__(THREADS, 1)
    skconv_bwd_a_kernel(const T* __restrict__ dout, const float* __restrict__ tok,
                        const float* __restrict__ gate, const T* __restrict__ phw, float* __restrict__ dfv,
                        float* __restrict__ dwpart, float* __restrict__ part, int L, int ch, int ntile) {
  constexpr int S = D + 4;
  const int SF = ch + 8, SD = ch + 4;
  extern __shared__ __align__(16) float sm[];
  float* wt = sm;
  float* dos = wt + ch * S;
  float* ts = dos + 2 * TOK * S;
  float* fvs = ts + 2 * TOK * S;
  float* dfs = fvs + TOK * SF;
  float* gs = dfs + TOK * SD;
  const int ntok = ntile * TOK;
  auto load = [&](int tile, int stage) {
    load_dout_tile(dos + stage * TOK * S, S, dout, (int64_t)tile * TOK, ntok, D);
    load_tile(ts + stage * TOK * S, S, tok, (int64_t)tile * TOK, ntok, D, D);
    if (threadIdx.x < D / 4)
      cp_async16(gs + stage * D + 4 * threadIdx.x, gate + (int64_t)tile * TOK / L * D + 4 * threadIdx.x);
    cp_async_commit();
  };
  if (blockIdx.x < ntile) load(blockIdx.x, 0);
  stage_cols(wt, phw, D, ch, S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const WgradWarp pw = WgradWarp::make(64, ch);  // the dfv product: TOK x ch, the same split of 64 rows
  const WgradWarp ww = WgradWarp::make(D, ch);   // dWph: D x ch
  float wacc[3][3][4];
  zero_acc(wacc);
  float bacc = 0.f;
  int stage = 0;
  for (int tile = blockIdx.x; tile < ntile; tile += gridDim.x, stage ^= 1) {
    const int next = tile + gridDim.x;
    if (next < ntile) load(next, stage ^ 1);
    const int64_t t0 = (int64_t)tile * TOK;
    cp_async_wait(next < ntile ? 1 : 0);
    __syncthreads();
    const float* dt = dos + stage * TOK * S;
    const float* tt = ts + stage * TOK * S;
    const float* gt = gs + stage * D;
    float acc[2][3][4];
    zero_acc(acc);
    mma_tile<false, false, 2, 3>(acc, dt, S, pw.m0, wt, S, pw.n0, D, 2, pw.nt);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (j < pw.nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = pw.m0 + 16 * i + g8 + 8 * h, c = pw.n0 + 8 * j + 2 * t4;
            const float2 v = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
            *reinterpret_cast<float2*>(dfs + r * SD + c) = v;
            *reinterpret_cast<float2*>(dfv + (t0 + r) * ch + c) = v;
          }
    for (int r = warp; r < TOK; r += THREADS / 32)
      for (int c = lane; c < ch; c += 32) {
        float f = 0.f;
        for (int m = c; m < D; m += ch) f = fmaf(tt[r * S + m], gt[m], f);
        fvs[r * SF + c] = f;
      }
    __syncthreads();
    if (threadIdx.x < D) {
      const int m = threadIdx.x, c = m % ch;
      float a = 0.f;
      for (int r = 0; r < TOK; ++r) a = fmaf(dfs[r * SD + c], tt[r * S + m], a);
      dwpart[(int64_t)tile * D + m] = a;
    } else if (threadIdx.x < 2 * D) {
      for (int r = 0; r < TOK; ++r) bacc += dt[r * S + threadIdx.x - D];
    }
    mma_tile<true, true, 3, 3>(wacc, dt, S, ww.m0, fvs, SF, ww.n0, TOK, ww.mt, ww.nt);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_wgrad_part(part + (int64_t)blockIdx.x * (D * ch + D), wacc, ww, ch, bacc, D, D);
}

// SKConv backward, pass B, on persistent CTAs over the tiles of TOK tokens
// (t and dout tiles by cp.async, two stages):
//   feats = t Wp^T + bp (tensor cores), dfeats = dout + dgap * gelu'(feats)
//         into shared memory;
//   dt = dfeats Wp + dfv * w_j (tensor cores), to device memory;
//   the CTA's dWp += dfeats^T t (tensor cores) and dbp += the tile's sums of
//         dfeats (threads [0, D)), written as its partial row [dWp (D x D) |
//         dbp (D)] at the end.
// Wp (D, D) staged once as it is (the feats product) and transposed (dt).
// Shared: w, wt [D][D + 4], ts, dos [2][TOK][D + 4], dfs [TOK][D + 4], gs
// [2][2][D] (the tile's gate and GAP gradient, with the tile by cp.async).
// T: the type of dout, Wp, bp and dt (bf16: dout and the weights widened
// as they are staged, dt rounded once as it is stored, the JAX kernel's
// cast of the tokens' gradient before the attention backward).
template <int D, typename T = float>
__global__ void __launch_bounds__(THREADS, 1)
    skconv_bwd_b_kernel(const T* __restrict__ dout, const float* __restrict__ tok,
                        const float* __restrict__ gate, const float* __restrict__ dgap,
                        const float* __restrict__ dfv, const T* __restrict__ pw, const T* __restrict__ pb,
                        T* __restrict__ dtok, float* __restrict__ part, int L, int ch, int ntile) {
  constexpr int S = D + 4, NT = col_tiles<D>();
  extern __shared__ __align__(16) float sm[];
  float* w = sm;
  float* wt = w + D * S;
  float* ts = wt + D * S;
  float* dos = ts + 2 * TOK * S;
  float* dfs = dos + 2 * TOK * S;
  float* gs = dfs + TOK * S;
  const int ntok = ntile * TOK;
  auto load = [&](int tile, int stage) {
    load_tile(ts + stage * TOK * S, S, tok, (int64_t)tile * TOK, ntok, D, D);
    load_dout_tile(dos + stage * TOK * S, S, dout, (int64_t)tile * TOK, ntok, D);
    const int64_t row = (int64_t)tile * TOK / L * D;
    if (threadIdx.x < D / 4) cp_async16(gs + stage * 2 * D + 4 * threadIdx.x, gate + row + 4 * threadIdx.x);
    else if (threadIdx.x < D / 2)
      cp_async16(gs + stage * 2 * D + D + 4 * (threadIdx.x - D / 4), dgap + row + 4 * (threadIdx.x - D / 4));
    cp_async_commit();
  };
  if (blockIdx.x < ntile) load(blockIdx.x, 0);
  stage_rows(w, pw, D, D, S);
  stage_cols(wt, pw, D, D, S);
  const TileWarp tw = TileWarp::make<NT>();
  const int nt = tiles_below<D>(tw.n0, D);
  const WgradWarp ww = WgradWarp::make(D, D);
  float bias[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[j][e] = j < nt ? to_f(pb[tw.n0 + 8 * j + 2 * tw.t4 + e]) : 0.f;
  float wacc[3][3][4];
  zero_acc(wacc);
  float bacc = 0.f;
  int stage = 0;
  for (int tile = blockIdx.x; tile < ntile; tile += gridDim.x, stage ^= 1) {
    const int next = tile + gridDim.x;
    if (next < ntile) load(next, stage ^ 1);
    const int64_t t0 = (int64_t)tile * TOK;
    cp_async_wait(next < ntile ? 1 : 0);
    __syncthreads();
    const float* tt = ts + stage * TOK * S;
    const float* dt = dos + stage * TOK * S;
    const float* gt = gs + stage * 2 * D;
    const float* dgt = gt + D;
    float acc[2][NT][4];
    zero_acc(acc);
    mma_tile<false, false, 2, NT>(acc, tt, S, tw.m0, w, S, tw.n0, D, 2, nt);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tw.m0 + 16 * i + tw.g8 + 8 * h;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (j >= nt) continue;
            const int o = tw.n0 + 8 * j + 2 * tw.t4 + e;
            dfs[r * S + o] = fmaf(dgt[o], gelu_erf_grad(acc[i][j][2 * h + e] + bias[j][e]), dt[r * S + o]);
          }
      }
    __syncthreads();
    if (threadIdx.x < D)
      for (int r = 0; r < TOK; ++r) bacc += dfs[r * S + threadIdx.x];
    zero_acc(acc);
    mma_tile<false, false, 2, NT>(acc, dfs, S, tw.m0, wt, S, tw.n0, D, 2, nt);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t t = t0 + tw.m0 + 16 * i + tw.g8 + 8 * h;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j >= nt) continue;
          const int m = tw.n0 + 8 * j + 2 * tw.t4;  // m and m + 1 lie in one group (ch is even)
          const float2 f = *reinterpret_cast<const float2*>(dfv + t * ch + m % ch);
          st2(dtok + t * D + m,
              make_float2(fmaf(f.x, gt[m], acc[i][j][2 * h]), fmaf(f.y, gt[m + 1], acc[i][j][2 * h + 1])));
        }
      }
    mma_tile<true, true, 3, 3>(wacc, dfs, S, ww.m0, tt, S, ww.n0, TOK, ww.mt, ww.nt);
    __syncthreads();  // every warp is done with this stage and dfs before they are refilled
  }
  store_wgrad_part(part + (int64_t)blockIdx.x * (D * D + D), wacc, ww, D, bacc, D, 0);
}

// SKConv backward (2), one block per image: the gate recomputed as the
// forward computes it (s, u, z, w), dw = the fixed-order sum of the image's
// dwpart rows, then da = w * (dw - sum_j dw_j w_j) (the softmax over the
// groups), dz = da fc2_w, du = dz * gelu'(u), ds = du fc1_w.  Writes per
// image da (B, D), z and du (B, dz), s (B, D) for the fc weight gradients,
// and dgap = ds / L (B, D).  Shared: s [D], u, z [dz], w [D], dw [D], da
// [D], du [dz].  T: the fc weights' type (bf16 widened as read).
template <typename T = float>
__global__ void skconv_gate_bwd_kernel(const float* __restrict__ partial, const float* __restrict__ dwpart,
                                       const T* __restrict__ f1w, const T* __restrict__ f1b,
                                       const T* __restrict__ f2w, const T* __restrict__ f2b,
                                       float* __restrict__ da_out, float* __restrict__ z_out,
                                       float* __restrict__ du_out, float* __restrict__ s_out,
                                       float* __restrict__ dgap, int L, int D, int dz, int n_group, int ch) {
  extern __shared__ float sm[];
  float* s = sm;
  float* u = s + D;
  float* z = u + dz;
  float* w = z + dz;
  float* dw = w + D;
  float* da = dw + D;
  float* du = da + D;
  const int b = blockIdx.x, ntile = L / TOK;
  skconv_gate_block(partial, f1w, f1b, f2w, f2b, s, u, z, w, b, L, D, dz, n_group, ch);
  for (int m = threadIdx.x; m < D; m += blockDim.x) {
    float acc = 0.f;
    for (int tl = 0; tl < ntile; ++tl) acc += dwpart[((int64_t)b * ntile + tl) * D + m];
    dw[m] = acc;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < D; m += blockDim.x) {
    const int c = m % ch;
    float wsum = 0.f;
    for (int g = 0; g < n_group; ++g) wsum = fmaf(dw[g * ch + c], w[g * ch + c], wsum);
    da[m] = w[m] * (dw[m] - wsum);
    da_out[(int64_t)b * D + m] = da[m];
    s_out[(int64_t)b * D + m] = s[m];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < dz; k += blockDim.x) {
    float acc = 0.f;
    for (int m = 0; m < D; ++m) acc = fmaf(da[m], to_f(f2w[m * dz + k]), acc);
    du[k] = acc * gelu_erf_grad(u[k]);
    du_out[(int64_t)b * dz + k] = du[k];
    z_out[(int64_t)b * dz + k] = z[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < dz; ++k) acc = fmaf(du[k], to_f(f1w[k * D + i]), acc);
    dgap[(int64_t)b * D + i] = acc / L;
  }
}

// SKConv backward (3): the fc weight gradients, one thread per output
// summing over the B images in order.  g = [dfc1_w (dz, D) | dfc1_b (dz) |
// dfc2_w (D, dz) | dfc2_b (D)], torch layouts, of type T (bf16: rounded
// once as stored).
template <typename T = float>
__global__ void skconv_fc_wgrad_kernel(const float* __restrict__ da, const float* __restrict__ z,
                                       const float* __restrict__ du, const float* __restrict__ s,
                                       T* __restrict__ g, int B, int D, int dz) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int n1w = dz * D, n1 = n1w + dz, n2w = n1 + D * dz, n2 = n2w + D;
  if (e >= n2) return;
  float acc = 0.f;
  if (e < n1w) {
    const int k = e / D, i = e % D;
    for (int b = 0; b < B; ++b) acc = fmaf(du[b * dz + k], s[b * D + i], acc);
  } else if (e < n1) {
    for (int b = 0; b < B; ++b) acc += du[b * dz + (e - n1w)];
  } else if (e < n2w) {
    const int m = (e - n1) / dz, k = (e - n1) % dz;
    for (int b = 0; b < B; ++b) acc = fmaf(da[b * D + m], z[b * dz + k], acc);
  } else {
    for (int b = 0; b < B; ++b) acc += da[b * D + (e - n2w)];
  }
  from_f(g[e], acc);
}


// Scratch carved from one float buffer: with base == nullptr it only
// counts.  Every piece starts on a 128-byte boundary.
struct Carver {
  float* base;
  size_t n = 0;
  float* take(size_t k) {
    float* p = base ? base + n : nullptr;
    n += (k + 31) / 32 * 32;
    return p;
  }
};

// What the forward hands the backward (the caller allocates and keeps
// them): the tokens t (B, L, D), the per-tile GAP sums of gelu(feats) (B *
// L / TOK, D) and the gate (B, n_group, ch).
struct Kept {
  float *tok, *partial, *gate;
};

// The forward, from pre-norm tokens to SKConv's output: LN + projections,
// the attention of every group into the tokens, SKConv (no residual).
// Scratch: qbuf (B, L, D), kvbuf (B, L, 2D), feats (B, L, D).
cudaError_t full_forward(const float* xq, const float* xkv, const float* const* wt, const float* bias,
                         const float* mask, float* scratch, const Kept& k, float* out, int B, int H, int W, int D,
                         int n_group, const int* ws, const int* shifts, int gh, int dz, float scale, uint32_t seed,
                         uint32_t thresh, float inv_keep, int drop, cudaStream_t st) {
  const int L = H * W;
  Carver c{scratch};
  float* qbuf = c.take((size_t)B * L * D);
  float* kvbuf = c.take((size_t)B * L * 2 * D);
  float* feats = c.take((size_t)B * L * D);
  cudaError_t err = launch_ln_proj(xq, xkv, wt[0], wt[1], wt[2], wt[3], wt[4], wt[5], wt[6], wt[7], qbuf, kvbuf,
                                   B * L, D, 1, st);
  if (err != cudaSuccess) return err;
  err = launch_attn_groups_any(qbuf, kvbuf, kvbuf + D, 2 * D, bias, mask, k.tok, B, H, W, D, n_group, ws, shifts,
                               gh, scale, 0, seed, thresh, inv_keep, drop, st);
  if (err != cudaSuccess) return err;
  return launch_skconv(k.tok, wt[8], wt[9], wt[10], wt[11], wt[12], wt[13], wt[14], wt[15], nullptr, feats,
                       k.partial, k.gate, out, B, L, D, n_group, dz, 0, st);
}

}  // namespace

// Weights: wt is a host array of 16 device pointers, in this order: qs, qb,
// ks, kb (D each), q_w (D, D), q_b (D), kv_w (2D, D), kv_b (2D), proj_w
// (D, D), proj_b (D), fc1_w (dz, D), fc1_b (dz), fc2_w (D, dz), fc2_b (D),
// ph_w (D, ch), ph_b (D) — torch Linear layouts, ch = D / n_group.  Shapes:
// xq, xkv, out (B, L, D) with L = H*W.  bias: per group (gh, N_g, N_g),
// concatenated; mask: per shifted group (nW_g, N_g, N_g), concatenated.  ws
// and shifts are host arrays of n_group ints.  With drop, entries whose hash
// clears thresh are kept and scaled by inv_keep.  Needs L % 64 == 0, D a
// multiple of 16 up to 96, windows of 2, 4 or 8 dividing H and W, and a head
// dim (D / n_group / gh) of 8, 16 or 32; the Python wrapper checks these.  Each entry point returns
// cudaGetLastError() after its last launch (or the first failing one).

// The kernels this library has launched since it was loaded
// (kernel_launches, window_common.cuh).
extern "C" unsigned long long window_attention_full_kernel_launches() { return kernel_launches; }

// The floats of the forward's scratch.
extern "C" size_t window_attention_full_forward_scratch(int B, int H, int W, int D) {
  const size_t T = (size_t)B * H * W;
  Carver c{nullptr};
  c.take(T * D);
  c.take(T * 2 * D);
  c.take(T * D);
  return c.n;
}

// The forward: out, and what the backward takes besides the inputs: tok (B,
// L, D), partial (B * L / 64, D), gate (B, D).
extern "C" int window_attention_full_forward(const float* xq, const float* xkv, const float* const* wt,
                                             const float* bias, const float* mask, float* scratch, float* out,
                                             float* tok, float* partial, float* gate, int B, int H, int W, int D,
                                             int n_group, const int* ws, const int* shifts, int gh, int dz,
                                             float scale, uint32_t seed, uint32_t thresh, float inv_keep, int drop,
                                             void* stream) {
  if (!head_dim(D, n_group, gh)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(full_forward(xq, xkv, wt, bias, mask, scratch, Kept{tok, partial, gate}, out, B, H, W, D,
                                       n_group, ws, shifts, gh, dz, scale, seed, thresh, inv_keep, drop,
                                       static_cast<cudaStream_t>(stream)));
}

namespace {

struct BwdBufs {
  float *qbuf, *kvbuf, *dfv, *dwpart, *da, *z, *du, *s, *dgap, *dtok, *dq, *dkv, *dbias_part;
  float *wpart_q, *wpart_kv, *lnpart_q, *lnpart_kv, *part_p, *part_ph;
};

// `grid`: the CTAs of the persistent token passes, one partial row each.
// `io`: the bytes of an element of q, kv and the tokens' gradient (4, or 2
// for the bf16 backward, whose pieces hold bf16 values).
BwdBufs carve_bwd(Carver& c, int B, int H, int W, int D, int n_group, const int* ws, int gh, int dz, int grid,
                  int io = 4) {
  const int L = H * W, ch = D / n_group;
  const size_t T = (size_t)B * L, S = (T + TOKC - 1) / TOKC;
  BwdBufs r;
  r.qbuf = c.take(T * D * io / 4);
  r.kvbuf = c.take(T * 2 * D * io / 4);
  r.dfv = c.take(T * ch);
  r.dwpart = c.take(T / TOK * D);
  r.da = c.take((size_t)B * D);
  r.z = c.take((size_t)B * dz);
  r.du = c.take((size_t)B * dz);
  r.s = c.take((size_t)B * D);
  r.dgap = c.take((size_t)B * D);
  r.dtok = c.take(T * D * io / 4);
  r.dq = c.take(T * D);
  r.dkv = c.take(T * 2 * D);
  r.dbias_part = c.take(attn_bwd_part_floats(B, H, W, n_group, ws, gh));
  r.wpart_q = c.take(S * (D * D + D));
  r.wpart_kv = c.take(S * (2 * D * D + 2 * D));
  r.lnpart_q = c.take(T / TOK * 2 * D);
  r.lnpart_kv = c.take(T / TOK * 2 * D);
  r.part_p = c.take((size_t)grid * (D * D + D));
  r.part_ph = c.take((size_t)grid * (D * ch + D));
  return r;
}

template <int D, typename T>
cudaError_t launch_skconv_bwd_d(const T* dout, const Kept& k, const T* const* wt, const BwdBufs& r, T* g_fc,
                                T* g_p, T* g_ph, int B, int L, int n_group, int dz, int grid, cudaStream_t st) {
  const int ntile = B * L / TOK, ch = D / n_group;
  const size_t smem_a =
      (size_t)(ch * (D + 4) + 4 * TOK * (D + 4) + TOK * (ch + 8) + TOK * (ch + 4) + 2 * D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(skconv_bwd_a_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_a);
  if (err != cudaSuccess) return err;
  ++kernel_launches;
  skconv_bwd_a_kernel<D, T><<<grid, THREADS, smem_a, st>>>(dout, k.tok, k.gate, wt[14], r.dfv, r.dwpart, r.part_ph,
                                                           L, ch, ntile);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_sum_rows(r.part_ph, g_ph, grid, D * ch + D, st)) != cudaSuccess) return err;
  const size_t smem_g = (size_t)(4 * D + 3 * dz) * sizeof(float);
  ++kernel_launches;
  skconv_gate_bwd_kernel<T><<<B, 128, smem_g, st>>>(k.partial, r.dwpart, wt[10], wt[11], wt[12], wt[13], r.da,
                                                    r.z, r.du, r.s, r.dgap, L, D, dz, n_group, ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n_fc = 2 * dz * D + dz + D;
  ++kernel_launches;
  skconv_fc_wgrad_kernel<T><<<(n_fc + 255) / 256, 256, 0, st>>>(r.da, r.z, r.du, r.s, g_fc, B, D, dz);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem_b = (size_t)(2 * D * (D + 4) + 5 * TOK * (D + 4) + 4 * D) * sizeof(float);
  if ((err = cudaFuncSetAttribute(skconv_bwd_b_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_b)) != cudaSuccess)
    return err;
  ++kernel_launches;
  skconv_bwd_b_kernel<D, T><<<grid, THREADS, smem_b, st>>>(dout, k.tok, k.gate, r.dgap, r.dfv, wt[8], wt[9],
                                                           reinterpret_cast<T*>(r.dtok), r.part_p, L, ch, ntile);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_rows(r.part_p, g_p, grid, D * D + D, st);
}

// SKConv's backward: pass A (+ the fixed-order sum of the dWph partials),
// the gate backward, the fc weight gradients, pass B (+ the dWp sum); dt
// into r.dtok.  D a multiple of 16 up to 96, ch a multiple of 8.  T: the
// type of dout, the weights, their gradients and dt (float32, or bf16 with
// float32 arithmetic).
template <typename T>
cudaError_t launch_skconv_bwd(const T* dout, const Kept& k, const T* const* wt, const BwdBufs& r, T* g_fc, T* g_p,
                              T* g_ph, int B, int L, int D, int n_group, int dz, int grid, cudaStream_t st) {
  if (!aligned16(dout) || !aligned16(k.tok) || (D / n_group) % 8 != 0) return cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_skconv_bwd_d<16>(dout, k, wt, r, g_fc, g_p, g_ph, B, L, n_group, dz, grid, st);
    case 32: return launch_skconv_bwd_d<32>(dout, k, wt, r, g_fc, g_p, g_ph, B, L, n_group, dz, grid, st);
    case 48: return launch_skconv_bwd_d<48>(dout, k, wt, r, g_fc, g_p, g_ph, B, L, n_group, dz, grid, st);
    case 64: return launch_skconv_bwd_d<64>(dout, k, wt, r, g_fc, g_p, g_ph, B, L, n_group, dz, grid, st);
    case 80: return launch_skconv_bwd_d<80>(dout, k, wt, r, g_fc, g_p, g_ph, B, L, n_group, dz, grid, st);
    case 96: return launch_skconv_bwd_d<96>(dout, k, wt, r, g_fc, g_p, g_ph, B, L, n_group, dz, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The floats of the backward's scratch (on the current device: the token
// passes' partial rows follow its SM count).
extern "C" size_t window_attention_full_backward_scratch(int B, int H, int W, int D, int n_group, const int* ws,
                                                         int gh, int dz) {
  int grid = 0;
  if (persistent_grid(B * H * W / TOK, &grid) != cudaSuccess) return 0;
  Carver c{nullptr};
  carve_bwd(c, B, H, W, D, n_group, ws, gh, dz, grid);
  return c.n;
}

// The backward, from the forward's inputs, what it kept (tok, partial,
// gate) and dout (B, L, D).  Outputs: dxq, dxkv (B, L, D); gw, the
// gradients of the 16 weights of wt concatenated in wt's order; dbias laid
// out as bias.
extern "C" int window_attention_full_backward(const float* xq, const float* xkv, const float* const* wt,
                                              const float* bias, const float* mask, const float* dout,
                                              const float* tok, const float* partial, const float* gate,
                                              float* scratch, float* dxq, float* dxkv, float* gw, float* dbias,
                                              int B, int H, int W, int D, int n_group, const int* ws,
                                              const int* shifts, int gh, int dz, float scale, uint32_t seed,
                                              uint32_t thresh, float inv_keep, int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!head_dim(D, n_group, gh)) return static_cast<int>(cudaErrorInvalidValue);
  const int L = H * W, ntok = B * L;
  int grid = 0;
  cudaError_t err = persistent_grid(ntok / TOK, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  Carver c{scratch};
  const BwdBufs r = carve_bwd(c, B, H, W, D, n_group, ws, gh, dz, grid);
  const Kept k{const_cast<float*>(tok), const_cast<float*>(partial), const_cast<float*>(gate)};
  // offsets of the 16 gradients in gw
  float* g_ln_q = gw;
  float* g_ln_kv = g_ln_q + 2 * D;
  float* g_q = g_ln_kv + 2 * D;
  float* g_kv = g_q + D * D + D;
  float* g_p = g_kv + 2 * D * D + 2 * D;
  float* g_fc = g_p + D * D + D;
  float* g_ph = g_fc + 2 * dz * D + dz + D;

  // q and kv for the attention backward (the tokens come from the forward)
  err = launch_ln_proj(xq, xkv, wt[0], wt[1], wt[2], wt[3], wt[4], wt[5], wt[6], wt[7], r.qbuf, r.kvbuf, ntok, D, 1,
                       st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = launch_skconv_bwd(dout, k, wt, r, g_fc, g_p, g_ph, B, L, D, n_group, dz, grid, st)) != cudaSuccess)
    return static_cast<int>(err);

  // attention backward from the tokens' gradient, then LN + projections
  err = launch_attn_bwd_groups_any(r.qbuf, r.kvbuf, r.kvbuf + D, 2 * D, r.dtok, bias, mask, r.dq, r.dkv, r.dkv + D,
                                   r.dbias_part, dbias, B, H, W, D, n_group, ws, shifts, gh, scale, seed, thresh,
                                   inv_keep, drop, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ln_proj_bwd(xq, xkv, wt[0], wt[1], wt[2], wt[3], wt[4], wt[6], r.dq, r.dkv,
                                             r.wpart_q, r.wpart_kv, r.lnpart_q, r.lnpart_kv, dxq, dxkv, g_q, g_kv,
                                             g_ln_q, g_ln_kv, ntok, D, st));
}

// The bf16 forward: the arguments of window_attention_full_forward with xq,
// xkv, the 16 weights of wt and out bf16 (tok, partial, gate float32), the
// tables as per-group pointers (biases[g], masks[g], float32; masks[g] read
// only where shifts[g] > 0) and scratch of
// window_attention_full_forward_bf16_scratch floats (feats).  Four
// launches: K3's one-launch bf16 forward writing float32 tokens
// (window_block_fwd_bf16_kernel<DROP, float>), then SKConv's three.
extern "C" size_t window_attention_full_forward_bf16_scratch(int B, int H, int W, int D) {
  Carver c{nullptr};
  c.take((size_t)B * H * W * D);
  return c.n;
}

extern "C" int window_attention_full_forward_bf16(const bf16* xq, const bf16* xkv, const bf16* const* wt,
                                                  const float* const* biases, const float* const* masks,
                                                  float* scratch, bf16* out, float* tok, float* partial, float* gate,
                                                  int B, int H, int W, int D, int n_group, const int* ws,
                                                  const int* shifts, int gh, int dz, float scale, uint32_t seed,
                                                  uint32_t thresh, float inv_keep, int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!head_dim(D, n_group, gh)) return static_cast<int>(cudaErrorInvalidValue);
  const int L = H * W;
  Carver c{scratch};
  float* feats = c.take((size_t)B * L * D);
  cudaError_t err = launch_block_fwd_bf16(xq, xkv, wt[0], wt[1], wt[2], wt[3], wt[4], wt[5], wt[6], wt[7], biases,
                                          masks, tok, B, H, W, D, n_group, ws, shifts, gh, scale, seed, thresh,
                                          inv_keep, drop, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_skconv_t(static_cast<const float*>(tok), wt[8], wt[9], wt[10], wt[11], wt[12],
                                          wt[13], wt[14], wt[15], static_cast<const bf16*>(nullptr), feats, partial,
                                          gate, out, B, L, D, n_group, dz, 0, st));
}

// The floats of the bf16 backward's scratch (on the current device):
// carve_bwd's pieces with q, kv and the tokens' gradient in bf16.
extern "C" size_t window_attention_full_backward_bf16_scratch(int B, int H, int W, int D, int n_group,
                                                              const int* ws, int gh, int dz) {
  int grid = 0;
  if (persistent_grid(B * H * W / TOK, &grid) != cudaSuccess) return 0;
  Carver c{nullptr};
  carve_bwd(c, B, H, W, D, n_group, ws, gh, dz, grid, sizeof(bf16));
  return c.n;
}

// The bf16 backward: the arguments of window_attention_full_backward with
// xq, xkv, the weights of wt, dout, dxq, dxkv and gw bf16 (bias, mask, tok,
// partial, gate and dbias float32) and scratch of
// window_attention_full_backward_bf16_scratch floats.  Every kernel reads
// its bf16 operands as they are and writes its bf16 results itself: q and
// kv recomputed in bf16, SKConv's backward in float32 on dout and the
// weights widened as staged, the tokens' gradient stored rounded to bf16,
// the bf16 attention and projection backward, and each weight gradient
// rounded once by the kernel that finishes its sum (21 launches at three
// window groups).
extern "C" int window_attention_full_backward_bf16(const bf16* xq, const bf16* xkv, const bf16* const* wt,
                                                   const float* bias, const float* mask, const bf16* dout,
                                                   const float* tok, const float* partial, const float* gate,
                                                   float* scratch, bf16* dxq, bf16* dxkv, bf16* gw, float* dbias,
                                                   int B, int H, int W, int D, int n_group, const int* ws,
                                                   const int* shifts, int gh, int dz, float scale, uint32_t seed,
                                                   uint32_t thresh, float inv_keep, int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!head_dim(D, n_group, gh)) return static_cast<int>(cudaErrorInvalidValue);
  const int L = H * W, ntok = B * L;
  int grid = 0;
  cudaError_t err = persistent_grid(ntok / TOK, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  Carver c{scratch};
  const BwdBufs r = carve_bwd(c, B, H, W, D, n_group, ws, gh, dz, grid, sizeof(bf16));
  bf16* const qh = reinterpret_cast<bf16*>(r.qbuf);
  bf16* const kvh = reinterpret_cast<bf16*>(r.kvbuf);
  const Kept k{const_cast<float*>(tok), const_cast<float*>(partial), const_cast<float*>(gate)};
  // offsets of the 16 gradients in gw
  bf16* g_ln_q = gw;
  bf16* g_ln_kv = g_ln_q + 2 * D;
  bf16* g_q = g_ln_kv + 2 * D;
  bf16* g_kv = g_q + D * D + D;
  bf16* g_p = g_kv + 2 * D * D + 2 * D;
  bf16* g_fc = g_p + D * D + D;
  bf16* g_ph = g_fc + 2 * dz * D + dz + D;
  // q and kv recomputed as the forward rounds them (the attention backward
  // scales q as the forward does)
  if ((err = launch_ln_proj(xq, xkv, wt[0], wt[1], wt[2], wt[3], wt[4], wt[5], wt[6], wt[7], qh, kvh, ntok, D, 1,
                            st)) != cudaSuccess ||
      (err = launch_skconv_bwd(dout, k, wt, r, g_fc, g_p, g_ph, B, L, D, n_group, dz, grid, st)) != cudaSuccess)
    return static_cast<int>(err);
  err = launch_attn_bwd_groups_any(static_cast<const bf16*>(qh), static_cast<const bf16*>(kvh),
                                   static_cast<const bf16*>(kvh + D), 2 * D,
                                   static_cast<const bf16*>(reinterpret_cast<bf16*>(r.dtok)), bias, mask, r.dq,
                                   r.dkv, r.dkv + D, r.dbias_part, dbias, B, H, W, D, n_group, ws, shifts, gh,
                                   scale, seed, thresh, inv_keep, drop, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ln_proj_bwd(xq, xkv, wt[0], wt[1], wt[2], wt[3], wt[4], wt[6], r.dq, r.dkv,
                                                  r.wpart_q, r.wpart_kv, r.lnpart_q, r.lnpart_kv, dxq, dxkv, g_q, g_kv,
                                                  g_ln_q, g_ln_kv, ntok, D, st));
}
