// Backward pieces shared by the training window-attention kernels
// (window_attention_train.cu, window_attention_core.cu,
// window_attention_full.cu): the per-group attention backward (on the
// tensor cores for windows of 16 and 64 tokens with 1 or 2 heads, a thread
// per row otherwise), the LN + projection backward and the weight-gradient
// kernel (both on the tensor cores), and the fixed-order second pass over
// per-block partials (sum_rows_kernel) that every cross-block sum goes
// through: no float atomics, so reruns agree bit for bit.
//
// On bf16 io (the bf16 AMP step) every core reads bf16 as it is, with the
// rounding points of the JAX kernel (dpmn_tpu/ops/pallas_window_train.py):
// window_attn_bwd_tc_bf16_kernel (the 4x4 and 8x8 windows' products on bf16
// m16n8k16, q scaled as it is staged, round_bf16(q * bf16(scale)), :208,
// :835, so the scores and dK take no further scale while dQ takes the
// float32 scale, :114), the 2x2 and thread-per-row kernels with T = bf16
// (rows widened and q scaled as they are staged, float32 arithmetic), P*M
// rounded before dV and dS before dQ / dK (:103, :111; dbias sums the
// unrounded dS).  dq, dk and dv are float32 for K3 and K5,
// whose projection backward (proj_ln_bwd_bf16_kernel, wgrad_bf16_kernel)
// rounds them before dx_ln and dW (:488-502; db sums them unrounded) and
// the recomputed LN before dW (:430-431) on bf16 m16n8k16, dx and the
// parameter gradients written as bf16 by the kernels that finish them
// (:511-512); bf16 for K4 (OT = bf16), rounded once at the store as the JAX
// kernel stores them in its io dtype (:260-263).
//
// The build hash of every csrc/*.cu covers this header (ops/kernels.py).

#pragma once

#include "window_common.cuh"

namespace {

// Tokens per block of the weight-gradient kernel.  At B = 64 (65536 tokens)
// that is 128 blocks for a D-row weight, one wave of 132 SMs, and 256 for
// the kv weight, two blocks an SM: longer chunks leave SMs idle, shorter
// ones add partials for the fixed-order sum to read.
constexpr int TOKC = 512;

// Attention backward of one channel group's windows of 16 or 64 tokens, a
// thread per row: kept for the shapes the tensor-core kernel
// (window_attn_bwd_tc_kernel) does not take, more than 2 heads a group or
// rows that are not 16-byte aligned; the windows of 4 tokens go to
// window_attn_bwd4_kernel.  No flagship path launches it.  Block (chunk,
// image) walks `wchunk` windows, `wpb` at a time; thread (window, head,
// row).  q, dq and dout rows have stride D; k, v, dk and dv rows stride kvs
// (as in window_attn_fwd_kernel).  Shared:
// scaled q, k, v and dout of the wpb windows [wpb][N][ch] each; dS and P*M
// [wpb][gh][N][N + 1] (padded rows); the block's dbias sum [gh][N][N].
// HD: the head dim, 8, 16 or 32.  T: the type of q, k, v and dout; bf16
// widens the rows and scales q as they are staged (module comment), and
// rounds dS and P*M to bf16 before their products (dbias sums the
// unrounded dS).  OT: the type of dq, dk, dv (bf16: K4's bf16 backward,
// each rounded once as it is stored).
template <int N, bool DROP, int HD = 16, typename T = float, typename OT = float>
__global__ void window_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v, int kvs, const T* __restrict__ dout,
                                       const float* __restrict__ bias, const float* __restrict__ mask,
                                       OT* __restrict__ dq, OT* __restrict__ dk, OT* __restrict__ dv,
                                       float* __restrict__ dbias_part, int H, int W,
                                       int D, int g, int gh, int ws, int sh, int wpb, int wchunk, float scale,
                                       uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ float sm[];
  constexpr int NP = N + 1;
  constexpr bool BF16 = sizeof(T) == 2;
  const int ch = gh * HD, L = H * W;
  const int nwc = W / ws, nw = (H / ws) * nwc;
  const int b = blockIdx.y;
  const int wspan = wpb * N * ch, nb = gh * N * N;
  float* qs_ = sm;
  float* ks_ = qs_ + wspan;
  float* vs_ = ks_ + wspan;
  float* dos_ = vs_ + wspan;
  float* ds_ = dos_ + wspan;
  float* pd_ = ds_ + wpb * gh * N * NP;
  float* dbacc = pd_ + wpb * gh * N * NP;
  for (int e = threadIdx.x; e < nb; e += blockDim.x) dbacc[e] = 0.f;
  const int64_t base = (int64_t)b * L;
  const int lw = threadIdx.x / (gh * N), hd = (threadIdx.x / N) % gh, r = threadIdx.x % N;
  const int w_begin = blockIdx.x * wchunk, w_end = min(nw, w_begin + wchunk);
  for (int w0 = w_begin; w0 < w_end; w0 += wpb) {
    for (int e = threadIdx.x; e < wspan; e += blockDim.x) {
      const int l = e / (N * ch), j = (e / ch) % N, c = e % ch;
      const int widx = w0 + l;
      float qv = 0.f, kval = 0.f, vval = 0.f, dov = 0.f;
      if (widx < w_end) {
        const int64_t tok = base + window_token(widx, j, ws, nwc, sh, H, W);
        if constexpr (sizeof(T) == 2) {  // bf16 rows widened, q scaled as the forward scales it
          qv = round_bf16(to_f(q[tok * D + g * ch + c]) * __bfloat162float(__float2bfloat16_rn(scale)));
          kval = to_f(k[tok * kvs + g * ch + c]);
          vval = to_f(v[tok * kvs + g * ch + c]);
          dov = to_f(dout[(base + (int64_t)widx * N + j) * D + g * ch + c]);
        } else {
          qv = q[tok * D + g * ch + c] * scale;
          kval = k[tok * kvs + g * ch + c];
          vval = v[tok * kvs + g * ch + c];
          dov = dout[(base + (int64_t)widx * N + j) * D + g * ch + c];
        }
      }
      qs_[e] = qv;
      ks_[e] = kval;
      vs_[e] = vval;
      dos_[e] = dov;
    }
    __syncthreads();
    const int widx = w0 + lw;
    const bool valid = widx < w_end;
    float* dsrow = ds_ + ((lw * gh + hd) * N + r) * NP;
    float* pdrow = pd_ + ((lw * gh + hd) * N + r) * NP;
    // row pass: thread row r is query i
    if (valid) {
      const float* kw = ks_ + lw * N * ch + hd * HD;
      const float* vw = vs_ + lw * N * ch + hd * HD;
      float qv[HD], dov[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        qv[d] = qs_[(lw * N + r) * ch + hd * HD + d];
        dov[d] = dos_[(lw * N + r) * ch + hd * HD + d];
      }
      const float* brow = bias + (hd * N + r) * N;
      const float* mrow = sh > 0 ? mask + ((int64_t)widx * N + r) * N : nullptr;
      float s[N];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc = fmaf(qv[d], kw[j * ch + d], acc);
        acc += __ldg(brow + j);
        if (sh > 0) acc += __ldg(mrow + j);
        s[j] = acc;
        mx = fmaxf(mx, acc);
      }
      float den = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        s[j] = expf(s[j] - mx);
        den += s[j];
      }
      const uint32_t rkey = DROP ? dropout_row_key(seed, b, g, hd, widx, r) : 0u;
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float p = s[j] / den;
        s[j] = p;
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dp = fmaf(dov[d], vw[j * ch + d], dp);
        float pm = p;
        if (DROP) {
          const float m = (hash_step(rkey, j) & 0x7fffffffu) < thresh ? inv_keep : 0.f;
          dp *= m;
          pm = p * m;
        }
        pdrow[j] = BF16 ? round_bf16(pm) : pm;
        dsrow[j] = dp;
        rowsum = fmaf(dp, p, rowsum);
      }
      float dqv[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) dqv[d] = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float dsv = s[j] * (dsrow[j] - rowsum);
        dsrow[j] = dsv;
#pragma unroll
        for (int d = 0; d < HD; ++d) dqv[d] = fmaf(BF16 ? round_bf16(dsv) : dsv, kw[j * ch + d], dqv[d]);
      }
      OT* dqrow = dq + (base + window_token(widx, r, ws, nwc, sh, H, W)) * D + g * ch + hd * HD;
#pragma unroll
      for (int d = 0; d < HD; ++d) from_f(dqrow[d], dqv[d] * scale);
    } else {
      for (int j = 0; j < N; ++j) dsrow[j] = pdrow[j] = 0.f;
    }
    __syncthreads();
    // column pass: thread row r is key j
    if (valid) {
      const float* qw = qs_ + lw * N * ch + hd * HD;
      const float* dow = dos_ + lw * N * ch + hd * HD;
      const float* dsb = ds_ + (lw * gh + hd) * N * NP;
      const float* pdb = pd_ + (lw * gh + hd) * N * NP;
      float dkv_[HD], dvv[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) dkv_[d] = dvv[d] = 0.f;
      for (int i = 0; i < N; ++i) {
        const float a = BF16 ? round_bf16(dsb[i * NP + r]) : dsb[i * NP + r], pm = pdb[i * NP + r];
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          dkv_[d] = fmaf(a, qw[i * ch + d], dkv_[d]);
          dvv[d] = fmaf(pm, dow[i * ch + d], dvv[d]);
        }
      }
      const int64_t off = (base + window_token(widx, r, ws, nwc, sh, H, W)) * kvs + g * ch + hd * HD;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        from_f(dk[off + d], dkv_[d]);
        from_f(dv[off + d], dvv[d]);
      }
    }
    for (int e = threadIdx.x; e < nb; e += blockDim.x) {
      const int h2 = e / (N * N), i = (e / N) % N, j = e % N;
      float acc = dbacc[e];
      for (int l = 0; l < wpb; ++l) acc += ds_[((l * gh + h2) * N + i) * NP + j];
      dbacc[e] = acc;
    }
    __syncthreads();
  }
  float* part = dbias_part + ((int64_t)b * gridDim.x + blockIdx.x) * nb;
  for (int e = threadIdx.x; e < nb; e += blockDim.x) part[e] = dbacc[e];
}

// Windows a block of window_attn_bwd4_kernel takes: 4 gh threads each, at
// most 128 threads.
__host__ __device__ inline int bwd4_windows(int gh) { return gh >= 32 ? 1 : 32 / gh; }

// Attention backward of one group's windows of 4 tokens (2x2), any number
// of heads.  Block (chunk, image) takes bwd4_windows(gh) consecutive
// windows: their q, k, v rows (token order) and dout rows (faithful raw
// rows) land in shared memory by 16-byte cp.async where `vec` (element by
// element otherwise), [4][windows][4][ch + 4].  Thread (window, head, row r)
// in the 4 lanes of a quad:
//   row pass (query r): S = scale q k^T + bias [+ mask], P = softmax(S),
//     M the dropout mask, dP = (dO v^T) M, PM = P M, dS = P (dP -
//     rowsum(dP P)); dQ_r = scale dS_r K, written as 16-byte pieces;
//   column pass (key r): dS and PM of the window's 4 rows by quad shuffles,
//     dK_r = scale dS^T_r Q, dV_r = PM^T_r dO.
// Rows of q, k, v, dout move as 16-byte pieces (4 lanes a row).  dbias: the
// block's windows' dS summed in order into dbias_part [block][gh][4][4] (the
// fixed-order sum_rows_kernel adds the blocks; no float atomics).  At
// least 4 blocks an SM with dropout (registers up to 128 a thread: 4 %
// faster than 3 on an H100 SXM at 700 W), 3 without (it spills at 128).
// HD: the head dim, 8, 16 or 32 (2 blocks an SM at 32, whose rows take
// twice the registers).  T: the type of q, k, v and dout; bf16 (the bf16
// backwards) widens the rows as they are staged and scales q there, so the
// kernel computes as on float32 rows holding those values, and rounds dS
// and PM to bf16 before their products.  OT: the type of dq, dk, dv (bf16: K4's bf16
// backward, each rounded once as it is stored, in 8-byte pieces).
template <bool DROP, int HD = 16, typename T = float, typename OT = float>
__global__ void __launch_bounds__(128, HD > 16 ? 2 : DROP ? 4 : 3)
    window_attn_bwd4_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                            int kvs, const T* __restrict__ dout, const float* __restrict__ bias,
                            const float* __restrict__ mask, OT* __restrict__ dq, OT* __restrict__ dk,
                            OT* __restrict__ dv, float* __restrict__ dbias_part, int H, int W, int D, int g,
                            int gh, int sh, float scale, uint32_t seed, uint32_t thresh, float inv_keep, int vec) {
  extern __shared__ __align__(16) float sm[];
  constexpr bool BF16 = sizeof(T) == 2;
  const int ch = gh * HD, ld = ch + 4, L = H * W, nwc = W / 2, nw = (H / 2) * nwc, b = blockIdx.y;
  const int wb = bwd4_windows(gh), w0 = blockIdx.x * wb, span = wb * 4 * ld;
  const int64_t base = (int64_t)b * L;
  const int per = vec ? ch / 4 : ch, each = vec ? 4 : 1;  // pieces of a row, elements of a piece
  // a thread takes (row, piece) pairs, the same piece of q, k, v and dout
  for (int e = threadIdx.x; e < wb * 4 * per; e += blockDim.x) {
    const int row = e / per, c = (e - row * per) * each, l = row >> 2, j = row & 3, widx = w0 + l;
    float* dst = sm + row * ld + c;
    if (widx >= nw) {  // windows past the end compute on zeros
      for (int m = 0; m < each; ++m) dst[m] = dst[span + m] = dst[2 * span + m] = dst[3 * span + m] = 0.f;
      continue;
    }
    const int64_t tok = base + window_token_c<2>(widx, j, nwc, sh, H, W), raw = base + widx * 4 + j;
    const T* qs = q + tok * D + g * ch + c;
    const T* ks = k + tok * kvs + g * ch + c;
    const T* vs = v + tok * kvs + g * ch + c;
    const T* os = dout + raw * D + g * ch + c;
    if constexpr (sizeof(T) == 2) {  // bf16 rows widened as they land, q scaled as the forward scales it
      const float qscale = __bfloat162float(__float2bfloat16_rn(scale));
      for (int m = 0; m < each; ++m) {
        dst[m] = round_bf16(ldg_one(qs + m) * qscale);
        dst[span + m] = ldg_one(ks + m);
        dst[2 * span + m] = ldg_one(vs + m);
        dst[3 * span + m] = ldg_one(os + m);
      }
    } else if (vec) {
      cp_async16(dst, qs);
      cp_async16(dst + span, ks);
      cp_async16(dst + 2 * span, vs);
      cp_async16(dst + 3 * span, os);
    } else {
      dst[0] = __ldg(qs);
      dst[span] = __ldg(ks);
      dst[2 * span] = __ldg(vs);
      dst[3 * span] = __ldg(os);
    }
  }
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();
  const int l = threadIdx.x / (4 * gh), hd = (threadIdx.x >> 2) % gh, r = threadIdx.x & 3;
  const int widx = w0 + l;
  const bool valid = widx < nw;
  const int64_t tok_r = base + (valid ? window_token_c<2>(widx, r, nwc, sh, H, W) : 0);
  const int quad = (threadIdx.x & 31) & ~3;  // the lanes of this window and head: quad .. quad + 3
  const unsigned qmask = 0xfu << quad;
  const float* Qw = sm + l * 4 * ld + hd * HD;  // row j at + j ld
  const float* Kw = Qw + span;
  const float* Vw = Kw + span;
  const float* Ow = Vw + span;
  auto row16 = [&](const float* p, float (&x)[HD]) {
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) {
      const float4 t = *reinterpret_cast<const float4*>(p + 4 * c);
      x[4 * c] = t.x, x[4 * c + 1] = t.y, x[4 * c + 2] = t.z, x[4 * c + 3] = t.w;
    }
  };
  // row pass: query r
  float qr[HD], dor[HD], s[4], dp[4];
  row16(Qw + r * ld, qr);
  row16(Ow + r * ld, dor);
  const float* brow = bias + (hd * 4 + r) * 4;
  const float* mrow = sh > 0 && valid ? mask + ((int64_t)widx * 4 + r) * 4 : nullptr;
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float kv[HD], vv[HD];
    row16(Kw + j * ld, kv);
    row16(Vw + j * ld, vv);
    float acc = 0.f, dacc = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      acc = fmaf(qr[d], kv[d], acc);
      dacc = fmaf(dor[d], vv[d], dacc);
    }
    if constexpr (BF16)
      acc += __ldg(brow + j);
    else
      acc = acc * scale + __ldg(brow + j);
    if (sh > 0 && valid) acc += __ldg(mrow + j);
    s[j] = acc;
    dp[j] = dacc;
    mx = fmaxf(mx, acc);
  }
  float den = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = __expf(s[j] - mx);  // as the forward (window_attn_fwd_kernel)
    den += s[j];
  }
  const float inv = 1.0f / den;
  const uint32_t rkey = DROP ? dropout_row_key(seed, b, g, hd, widx, r) : 0u;
  float pm[4], rowsum = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float p = s[j] * inv;
    s[j] = p;
    pm[j] = p;
    if (DROP) {
      const float m = (hash_step(rkey, j) & 0x7fffffffu) < thresh ? inv_keep : 0.f;
      dp[j] *= m;
      pm[j] = p * m;
    }
    rowsum = fmaf(dp[j], p, rowsum);
  }
  float ds[4], dsr[4];  // dS; dS as the products take it
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ds[j] = s[j] * (dp[j] - rowsum);
    dsr[j] = ds[j];
    if constexpr (BF16) {
      dsr[j] = round_bf16(ds[j]);
      pm[j] = round_bf16(pm[j]);
    }
  }
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float kv[HD];
    row16(Kw + j * ld, kv);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = fmaf(dsr[j], kv[d], acc[d]);
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] *= scale;
  if (valid) store_row(dq + tok_r * D + g * ch + hd * HD, acc, vec);
  // column pass: key r; round t brings row i = (r + t) & 3 of dS and PM
  float dka[HD], dva[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) dka[d] = dva[d] = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int want = (r - t) & 3, i = (r + t) & 3;  // the column this lane sends; the row it takes
    const float sd = want == 0 ? dsr[0] : want == 1 ? dsr[1] : want == 2 ? dsr[2] : dsr[3];
    const float sp = want == 0 ? pm[0] : want == 1 ? pm[1] : want == 2 ? pm[2] : pm[3];
    const float a = __shfl_sync(qmask, sd, quad + i), pmv = __shfl_sync(qmask, sp, quad + i);
    float qi[HD], oi[HD];
    row16(Qw + i * ld, qi);
    row16(Ow + i * ld, oi);
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dka[d] = fmaf(a, qi[d], dka[d]);
      dva[d] = fmaf(pmv, oi[d], dva[d]);
    }
  }
  if constexpr (!BF16) {
#pragma unroll
    for (int d = 0; d < HD; ++d) dka[d] *= scale;
  }
  if (valid) {
    const int64_t off = tok_r * kvs + g * ch + hd * HD;
    store_row(dk + off, dka, vec);
    store_row(dv + off, dva, vec);
  }
  // dbias: the windows' dS rows in order
  __syncthreads();  // every thread is done with the staged rows
  float* red = sm;  // [wb][gh][4][4]
#pragma unroll
  for (int j = 0; j < 4; ++j) red[((l * gh + hd) * 4 + r) * 4 + j] = valid ? ds[j] : 0.f;
  __syncthreads();
  float* part = dbias_part + ((int64_t)b * gridDim.x + blockIdx.x) * gh * 16;
  for (int e = threadIdx.x; e < gh * 16; e += blockDim.x) {
    float a = 0.f;
    for (int w = 0; w < wb; ++w) a += red[w * gh * 16 + e];
    part[e] = a;
  }
}

// Attention backward of one group on the tensor cores, for windows of N =
// 16 or 64 tokens and GH = 1 or 2 heads of HD = 8, 16 or 32 channels (the
// flagship's 4x4 and 8x8 windows).  Block (chunk, image) walks `wchunk` windows, WPS =
// 128 / (N GH) at a time, one slot of shared memory each; warp (slot, head
// hd, m-tile mi) owns query rows [16 mi, 16 mi + 16) of its head, then key
// rows [16 mi, 16 mi + 16).  Per window, staged once by cp.async: q, k, v in
// token order and dout in the faithful raw rows, [N][CH + 4] each; then on
// mma.sync (3xTF32, mma_tile):
//   S = scale q k^T + bias [+ mask], dPM = dO v^T      (the warp's rows)
//   P = softmax(S); M the dropout mask; dP = dPM * M; PM = P * M;
//   dS = P (dP - rowsum(dP P))                        (registers, quad sums)
//   dQ = scale dS k                                    (the warp's rows)
//   dK = scale dS^T q, dV = PM^T dO                    (the warp's keys)
// with dS and PM shared per head [N][N + 4].  dbias: each warp sums its dS
// over its windows in registers, the slots are added in order into the
// block's partial (dbias_part [block][gh][N][N]).  Shared per slot: q, k, v,
// dout [N][CH + 4]; dS, PM [GH][N][N + 4].  The bf16 backwards take
// window_attn_bwd_tc_bf16_kernel.
template <int N, int GH, bool DROP, int HD = 16>
__global__ void __launch_bounds__(THREADS)
    window_attn_bwd_tc_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                              int kvs, const float* __restrict__ dout, const float* __restrict__ bias,
                              const float* __restrict__ mask, float* __restrict__ dq, float* __restrict__ dk,
                              float* __restrict__ dv, float* __restrict__ dbias_part, int H, int W, int D, int g,
                              int ws, int sh, int wchunk, float scale, uint32_t seed, uint32_t thresh,
                              float inv_keep) {
  // CT: the output column tiles of one product pass (head dim 32 in two
  // passes of 16 columns, which keeps its registers from spilling)
  constexpr int CH = HD * GH, SQ = CH + 4, SN = N + 4, MT = N / 16, NTN = N / 8, CT = HD < 16 ? HD / 8 : 2;
  constexpr int WPW = GH * MT, WPS = (THREADS / 32) / WPW, SLOT = 4 * N * SQ + 2 * GH * N * SN;
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int lw = warp / WPW, hd = (warp % WPW) / MT, mi = (warp % WPW) % MT;
  float* Qs = sm + lw * SLOT;
  float* Ks = Qs + N * SQ;
  float* Vs = Ks + N * SQ;
  float* Os = Vs + N * SQ;
  float* dSs = Os + N * SQ + hd * N * SN;  // this warp's head
  float* PMs = Os + N * SQ + GH * N * SN + hd * N * SN;
  const int L = H * W, nwc = W / ws, nw = (H / ws) * nwc, b = blockIdx.y;
  const int64_t base = (int64_t)b * L;
  const int w_begin = blockIdx.x * wchunk, w_end = min(nw, w_begin + wchunk);
  const float* bh = bias + hd * N * N;
  const int i0 = 16 * mi + g8;  // this thread's rows i0 and i0 + 8 of the warp's m-tile
  float dbacc[NTN][4];
#pragma unroll
  for (int jn = 0; jn < NTN; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbacc[jn][e] = 0.f;
  for (int w0 = w_begin; w0 < w_end; w0 += WPS) {
    for (int e = threadIdx.x; e < WPS * N * (CH / 4); e += THREADS) {
      const int l = e / (N * (CH / 4)), j = (e / (CH / 4)) % N, c = (e % (CH / 4)) * 4;
      const int widx = w0 + l;
      if (widx >= w_end) continue;
      float* sl = sm + l * SLOT + j * SQ + c;
      const int64_t tok = base + window_token(widx, j, ws, nwc, sh, H, W);
      cp_async16(sl, q + tok * D + g * CH + c);
      cp_async16(sl + N * SQ, k + tok * kvs + g * CH + c);
      cp_async16(sl + 2 * N * SQ, v + tok * kvs + g * CH + c);
      cp_async16(sl + 3 * N * SQ, dout + (base + (int64_t)widx * N + j) * D + g * CH + c);
    }
    cp_async_commit();
    cp_async_wait(0);
    __syncthreads();
    const int widx = w0 + lw;
    const bool valid = widx < w_end;
    if (valid) {
      float s[1][NTN][4], dp[1][NTN][4];
      zero_acc(s);
      zero_acc(dp);
      mma_tile<false, false, 1, NTN>(s, Qs + hd * HD, SQ, 16 * mi, Ks + hd * HD, SQ, 0, HD);
      mma_tile<false, false, 1, NTN>(dp, Os + hd * HD, SQ, 16 * mi, Vs + hd * HD, SQ, 0, HD);
      const float* mw = sh > 0 ? mask + (int64_t)widx * N * N : nullptr;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jn = 0; jn < NTN; ++jn)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = (i0 + 8 * r) * N + 8 * jn + 2 * t4;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(bh + off));
          float s0 = s[0][jn][2 * r] * scale + bb.x;
          float s1 = s[0][jn][2 * r + 1] * scale + bb.y;
          if (sh > 0) {  // the shift, not the pointer, is tested (window_common.cuh)
            const float2 mm = __ldg(reinterpret_cast<const float2*>(mw + off));
            s0 += mm.x;
            s1 += mm.y;
          }
          s[0][jn][2 * r] = s0;
          s[0][jn][2 * r + 1] = s1;
          mx[r] = fmaxf(mx[r], fmaxf(s0, s1));
        }
      float den[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
#pragma unroll
      for (int jn = 0; jn < NTN; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[0][jn][e] = expf(s[0][jn][e] - mx[e >> 1]);
          den[e >> 1] += s[0][jn][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        den[r] += __shfl_xor_sync(0xffffffffu, den[r], 1);
        den[r] += __shfl_xor_sync(0xffffffffu, den[r], 2);
      }
      uint32_t rkey[2] = {0u, 0u};
      if (DROP) {
        rkey[0] = dropout_row_key(seed, b, g, hd, widx, i0);
        rkey[1] = dropout_row_key(seed, b, g, hd, widx, i0 + 8);
      }
#pragma unroll
      for (int jn = 0; jn < NTN; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, j = 8 * jn + 2 * t4 + (e & 1);
          const float p = s[0][jn][e] / den[r];
          float d = dp[0][jn][e], pm = p;
          if (DROP) {
            const float m = (hash_step(rkey[r], j) & 0x7fffffffu) < thresh ? inv_keep : 0.f;
            d *= m;
            pm = p * m;
          }
          s[0][jn][e] = p;
          dp[0][jn][e] = d;
          PMs[(i0 + 8 * r) * SN + j] = pm;
          rs[r] = fmaf(d, p, rs[r]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      }
#pragma unroll
      for (int jn = 0; jn < NTN; ++jn)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float d0 = s[0][jn][2 * r] * (dp[0][jn][2 * r] - rs[r]);
          const float d1 = s[0][jn][2 * r + 1] * (dp[0][jn][2 * r + 1] - rs[r]);
          dbacc[jn][2 * r] += d0;
          dbacc[jn][2 * r + 1] += d1;
          *reinterpret_cast<float2*>(dSs + (i0 + 8 * r) * SN + 8 * jn + 2 * t4) = make_float2(d0, d1);
        }
      __syncwarp();
      if constexpr (HD == 32) {  // dQ in two passes of 16 columns
#pragma unroll
        for (int c0 = 0; c0 < HD; c0 += 16) {
          float a[1][CT][4];
          zero_acc(a);
          mma_tile<false, true, 1, CT>(a, dSs, SN, 16 * mi, Ks + hd * HD + c0, SQ, 0, N);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int64_t tok = base + window_token(widx, i0 + 8 * r, ws, nwc, sh, H, W);
#pragma unroll
            for (int jn = 0; jn < CT; ++jn)
              *reinterpret_cast<float2*>(dq + tok * D + g * CH + hd * HD + c0 + 8 * jn + 2 * t4) =
                  make_float2(a[0][jn][2 * r] * scale, a[0][jn][2 * r + 1] * scale);
          }
        }
      } else {  // one pass, as head dim 16's machine code has it
        float a[1][CT][4];
        zero_acc(a);
        mma_tile<false, true, 1, CT>(a, dSs, SN, 16 * mi, Ks + hd * HD, SQ, 0, N);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int64_t tok = base + window_token(widx, i0 + 8 * r, ws, nwc, sh, H, W);
#pragma unroll
          for (int jn = 0; jn < CT; ++jn)
            *reinterpret_cast<float2*>(dq + tok * D + g * CH + hd * HD + 8 * jn + 2 * t4) =
                make_float2(a[0][jn][2 * r] * scale, a[0][jn][2 * r + 1] * scale);
        }
      }
    }
    __syncthreads();  // dS and PM of every head complete
    if constexpr (HD == 32) {  // dK and dV in two passes of 16 columns
#pragma unroll
      for (int c0 = 0; c0 < HD; c0 += 16) {
        if (!valid) break;
        float a[1][CT][4], c[1][CT][4];
        zero_acc(a);
        zero_acc(c);
        mma_tile<true, true, 1, CT>(a, dSs, SN, 16 * mi, Qs + hd * HD + c0, SQ, 0, N);
        mma_tile<true, true, 1, CT>(c, PMs, SN, 16 * mi, Os + hd * HD + c0, SQ, 0, N);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int64_t off =
              (base + window_token(widx, i0 + 8 * r, ws, nwc, sh, H, W)) * kvs + g * CH + hd * HD + c0;
#pragma unroll
          for (int jn = 0; jn < CT; ++jn) {
            *reinterpret_cast<float2*>(dk + off + 8 * jn + 2 * t4) =
                make_float2(a[0][jn][2 * r] * scale, a[0][jn][2 * r + 1] * scale);
            *reinterpret_cast<float2*>(dv + off + 8 * jn + 2 * t4) =
                make_float2(c[0][jn][2 * r], c[0][jn][2 * r + 1]);
          }
        }
      }
    } else if (valid) {
      float a[1][CT][4], c[1][CT][4];
      zero_acc(a);
      zero_acc(c);
      mma_tile<true, true, 1, CT>(a, dSs, SN, 16 * mi, Qs + hd * HD, SQ, 0, N);
      mma_tile<true, true, 1, CT>(c, PMs, SN, 16 * mi, Os + hd * HD, SQ, 0, N);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int64_t off = (base + window_token(widx, i0 + 8 * r, ws, nwc, sh, H, W)) * kvs + g * CH + hd * HD;
#pragma unroll
        for (int jn = 0; jn < CT; ++jn) {
          *reinterpret_cast<float2*>(dk + off + 8 * jn + 2 * t4) =
              make_float2(a[0][jn][2 * r] * scale, a[0][jn][2 * r + 1] * scale);
          *reinterpret_cast<float2*>(dv + off + 8 * jn + 2 * t4) = make_float2(c[0][jn][2 * r], c[0][jn][2 * r + 1]);
        }
      }
    }
    __syncthreads();  // the slots are refilled next
  }
  // dbias: the slots' sums in order
  float* part = dbias_part + ((int64_t)b * gridDim.x + blockIdx.x) * GH * N * N;
  float* red = sm;  // [WPS][GH][N][N]
#pragma unroll
  for (int jn = 0; jn < NTN; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[((lw * GH + hd) * N + i0 + 8 * (e >> 1)) * N + 8 * jn + 2 * t4 + (e & 1)] = dbacc[jn][e];
  __syncthreads();
  for (int e = threadIdx.x; e < GH * N * N; e += THREADS) {
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < WPS; ++l) acc += red[l * GH * N * N + e];
    part[e] = acc;
  }
}

// window_attn_bwd_tc_kernel for bf16 io (K3's and K5's bf16 backward): q,
// k, v and dout bf16 rows read from device memory as they are, staged per
// slot as bf16 [N][LD] (LD = fwd_ldq<HD>(CH), the forward's strides), q
// times the bf16-rounded scale and rounded to bf16 in place by the thread
// that staged it, as the forward scales it (attn_tile.cuh scale_bf16x2).
// Every product on bf16 m16n8k16 (m16n8k8 for S and dPM at head dim 8) with
// float32 accumulation, fed by ldmatrix (products of bf16 values are exact
// in float32, so one pass computes what 3xTF32 did on the widened values):
//   S = qs k^T + bias [+ mask], dPM = dO v^T   qk_tile_bf16 (the warp's rows)
//   P = softmax(S); M the dropout mask; dP = dPM * M; PM = P * M;
//   dS = P (dP - rowsum(dP P))                 (registers, quad sums)
//   dQ = scale round(dS) k                     pv_tile_bf16<ONCE>, dS from registers
//   dK = round(dS)^T qs, dV = round(PM)^T dO    mma_tile_bf16<true, true> (the warp's keys)
// with round(dS) and round(PM) shared per head as bf16 [N][N + 8]; dbias
// sums the unrounded dS in registers, the slots added in order as in the
// float32 kernel.  OT: the type of dq, dk, dv: float32 for K3 and K5 (the
// projection backward's bias sums take them unrounded), bf16 for K4 (each
// rounded once as it is stored, dQ after its float32 scale, as the JAX
// kernel stores in its io dtype).  Blocks, slots and warps as
// window_attn_bwd_tc_kernel.
// Shared per slot (bf16): q, k, v, dout [N][LD]; dS, PM [GH][N][N + 8].
// Registers: up to 128 a thread for the 4x4 windows (2 CTAs an SM), up to
// 255 for the 8x8 (whose 8 key tiles a row take more; left to itself ptxas
// holds some instances to 80 or 128 and spills).
template <int N, int GH, bool DROP, int HD, typename OT = float>
__global__ void __launch_bounds__(THREADS, N == 16 ? 2 : 1)
    window_attn_bwd_tc_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v, int kvs,
                                   const __nv_bfloat16* __restrict__ dout, const float* __restrict__ bias,
                                   const float* __restrict__ mask, OT* __restrict__ dq, OT* __restrict__ dk,
                                   OT* __restrict__ dv, float* __restrict__ dbias_part, int H, int W, int D, int g,
                                   int ws, int sh, int wchunk, float scale, uint32_t seed, uint32_t thresh,
                                   float inv_keep) {
  using bf16 = __nv_bfloat16;
  constexpr int CH = HD * GH, LD = HD % 16 == 0 || CH % 16 == 0 ? CH + 8 : CH + 16, SN = N + 8, MT = N / 16;
  constexpr int NTN = N / 8, CT = HD / 8, WPW = GH * MT, WPS = (THREADS / 32) / WPW;
  constexpr int SLOT = 4 * N * LD + 2 * GH * N * SN, PIECES = CH / 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* const sm = reinterpret_cast<bf16*>(bwd_smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int lw = warp / WPW, hd = (warp % WPW) / MT, mi = (warp % WPW) % MT;
  const bf16* Qs = sm + lw * SLOT;
  const bf16* Ks = Qs + N * LD;
  const bf16* Vs = Ks + N * LD;
  const bf16* Os = Vs + N * LD;
  bf16* dSs = sm + lw * SLOT + 4 * N * LD + hd * N * SN;  // this warp's head
  bf16* PMs = dSs + GH * N * SN;
  const int L = H * W, nwc = W / ws, nw = (H / ws) * nwc, b = blockIdx.y;
  const int64_t base = (int64_t)b * L;
  const int w_begin = blockIdx.x * wchunk, w_end = min(nw, w_begin + wchunk);
  const float* bh = bias + hd * N * N;
  const float qscale = __bfloat162float(__float2bfloat16_rn(scale));
  const int i0 = 16 * mi + g8;  // this thread's rows i0 and i0 + 8 of the warp's m-tile
  float dbacc[NTN][4];
#pragma unroll
  for (int jn = 0; jn < NTN; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbacc[jn][e] = 0.f;
  for (int w0 = w_begin; w0 < w_end; w0 += WPS) {
    for (int e = threadIdx.x; e < WPS * N * PIECES; e += THREADS) {
      const int l = e / (N * PIECES), j = (e / PIECES) % N, c = (e % PIECES) * 8;
      const int widx = w0 + l;
      if (widx >= w_end) continue;
      bf16* sl = sm + l * SLOT + j * LD + c;
      const int64_t tok = base + window_token(widx, j, ws, nwc, sh, H, W);
      cp_async16_bytes(sl, q + tok * D + g * CH + c);
      cp_async16_bytes(sl + N * LD, k + tok * kvs + g * CH + c);
      cp_async16_bytes(sl + 2 * N * LD, v + tok * kvs + g * CH + c);
      cp_async16_bytes(sl + 3 * N * LD, dout + (base + (int64_t)widx * N + j) * D + g * CH + c);
    }
    cp_async_commit();
    cp_async_wait(0);
    // q times the bf16 scale, rounded, by the thread that staged the piece
    for (int e = threadIdx.x; e < WPS * N * PIECES; e += THREADS) {
      const int l = e / (N * PIECES), j = (e / PIECES) % N, c = (e % PIECES) * 8;
      if (w0 + l >= w_end) continue;
      uint4* p = reinterpret_cast<uint4*>(sm + l * SLOT + j * LD + c);
      uint4 x = *p;
      x.x = scale_bf16x2(x.x, qscale), x.y = scale_bf16x2(x.y, qscale);
      x.z = scale_bf16x2(x.z, qscale), x.w = scale_bf16x2(x.w, qscale);
      *p = x;
    }
    __syncthreads();
    const int widx = w0 + lw;
    const bool valid = widx < w_end;
    if (valid) {
      float s[NTN][4] = {}, dp[NTN][4] = {};
      qk_tile_bf16<NTN, false, HD>(s, Qs + 16 * mi * LD + hd * HD, LD, Ks + hd * HD, LD);
      qk_tile_bf16<NTN, false, HD>(dp, Os + 16 * mi * LD + hd * HD, LD, Vs + hd * HD, LD);
      const float* mw = sh > 0 ? mask + (int64_t)widx * N * N : nullptr;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jn = 0; jn < NTN; ++jn)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = (i0 + 8 * r) * N + 8 * jn + 2 * t4;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(bh + off));
          float s0 = s[jn][2 * r] + bb.x, s1 = s[jn][2 * r + 1] + bb.y;
          if (sh > 0) {
            const float2 mm = __ldg(reinterpret_cast<const float2*>(mw + off));
            s0 += mm.x;
            s1 += mm.y;
          }
          s[jn][2 * r] = s0;
          s[jn][2 * r + 1] = s1;
          mx[r] = fmaxf(mx[r], fmaxf(s0, s1));
        }
      float den[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
#pragma unroll
      for (int jn = 0; jn < NTN; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[jn][e] = expf(s[jn][e] - mx[e >> 1]);
          den[e >> 1] += s[jn][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) den[r] = quad_sum(den[r]);
      uint32_t rkey[2] = {0u, 0u};
      if (DROP) {
        rkey[0] = dropout_row_key(seed, b, g, hd, widx, i0);
        rkey[1] = dropout_row_key(seed, b, g, hd, widx, i0 + 8);
      }
#pragma unroll
      for (int jn = 0; jn < NTN; ++jn)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float pm[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * jn + 2 * t4 + e;
            const float p = s[jn][2 * r + e] / den[r];
            float d = dp[jn][2 * r + e];
            pm[e] = p;
            if (DROP) {
              const float m = (hash_step(rkey[r], j) & 0x7fffffffu) < thresh ? inv_keep : 0.f;
              d *= m;
              pm[e] = p * m;
            }
            s[jn][2 * r + e] = p;
            dp[jn][2 * r + e] = d;
            rs[r] = fmaf(d, p, rs[r]);
          }
          *reinterpret_cast<__nv_bfloat162*>(PMs + (i0 + 8 * r) * SN + 8 * jn + 2 * t4) =
              __floats2bfloat162_rn(pm[0], pm[1]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) rs[r] = quad_sum(rs[r]);
#pragma unroll
      for (int jn = 0; jn < NTN; ++jn)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float d0 = s[jn][2 * r] * (dp[jn][2 * r] - rs[r]);
          const float d1 = s[jn][2 * r + 1] * (dp[jn][2 * r + 1] - rs[r]);
          dbacc[jn][2 * r] += d0;
          dbacc[jn][2 * r + 1] += d1;
          s[jn][2 * r] = d0;  // s holds dS from here
          s[jn][2 * r + 1] = d1;
          *reinterpret_cast<__nv_bfloat162*>(dSs + (i0 + 8 * r) * SN + 8 * jn + 2 * t4) =
              __floats2bfloat162_rn(d0, d1);
        }
      float a[CT][4] = {};
      pv_tile_bf16<NTN, true, HD>(a, s, Ks + hd * HD, LD);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int64_t tok = base + window_token(widx, i0 + 8 * r, ws, nwc, sh, H, W);
#pragma unroll
        for (int c = 0; c < CT; ++c)
          st2(dq + tok * D + g * CH + hd * HD + 8 * c + 2 * t4, make_float2(a[c][2 * r] * scale, a[c][2 * r + 1] * scale));
      }
    }
    __syncthreads();  // dS and PM of every head complete
    if (valid) {
      float a[1][CT][4], c[1][CT][4];
      zero_acc(a);
      zero_acc(c);
      mma_tile_bf16<true, true, 1, CT>(a, dSs, SN, 16 * mi, Qs + hd * HD, LD, 0, N);
      mma_tile_bf16<true, true, 1, CT>(c, PMs, SN, 16 * mi, Os + hd * HD, LD, 0, N);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int64_t off = (base + window_token(widx, i0 + 8 * r, ws, nwc, sh, H, W)) * kvs + g * CH + hd * HD;
#pragma unroll
        for (int jn = 0; jn < CT; ++jn) {
          st2(dk + off + 8 * jn + 2 * t4, make_float2(a[0][jn][2 * r], a[0][jn][2 * r + 1]));
          st2(dv + off + 8 * jn + 2 * t4, make_float2(c[0][jn][2 * r], c[0][jn][2 * r + 1]));
        }
      }
    }
    __syncthreads();  // the slots are refilled next
  }
  // dbias: the slots' sums in order
  float* part = dbias_part + ((int64_t)b * gridDim.x + blockIdx.x) * GH * N * N;
  float* red = reinterpret_cast<float*>(bwd_smem);  // [WPS][GH][N][N]
#pragma unroll
  for (int jn = 0; jn < NTN; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[((lw * GH + hd) * N + i0 + 8 * (e >> 1)) * N + 8 * jn + 2 * t4 + (e & 1)] = dbacc[jn][e];
  __syncthreads();
  for (int e = threadIdx.x; e < GH * N * N; e += THREADS) {
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < WPS; ++l) acc += red[l * GH * N * N + e];
    part[e] = acc;
  }
}

// dx of one LN + projection pair, on persistent CTAs: dx_ln = dy W (W (O,
// C) in torch layout, staged transposed once per CTA) on the tensor cores
// (mma_tile, 3xTF32) per tile of TOK tokens (dy tiles by cp.async, two
// stages), into shared memory; then the LN backward per token, a warp per
// 8 tokens: dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)),
// dxhat = dx_ln * scale; and the tile's sums of dx_ln * xhat and dx_ln
// (lnpart [tile][2][C], fixed order: a warp's 8 tokens in turn, then the 8
// warps).  Shared: wt [C][O + 4], dys [2][TOK][O + 4], dxs [TOK][C + 4],
// red [8][2][C].  C a multiple of 16 up to 96 (C = 16, 48, 80: the
// warps' n-tiles cut at C, tiles_below, and lane channels past C idle).
template <int C, int O>
__global__ void __launch_bounds__(THREADS, 1)
    proj_ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ lns, const float* __restrict__ w,
                       const float* __restrict__ dy, float* __restrict__ dx, float* __restrict__ lnpart, int ntile) {
  constexpr int SO = O + 4, SC = C + 4, NT = col_tiles<C>(), NM = col_tiles<C>();
  constexpr bool FULL = C % 32 == 0;  // every lane's channels lane + 32 m, m < NM, are of the C
  extern __shared__ __align__(16) float sm[];
  float* wt = sm;
  float* dys = wt + C * SO;
  float* dxs = dys + 2 * TOK * SO;
  float* red = dxs + TOK * SC;
  const int ntok = ntile * TOK;
  if (blockIdx.x < ntile) {
    load_tile(dys, SO, dy, (int64_t)blockIdx.x * TOK, ntok, O, O);
    cp_async_commit();
  }
  for (int idx = threadIdx.x; idx < O * C; idx += blockDim.x) wt[(idx % C) * SO + idx / C] = __ldg(w + idx);
  const TileWarp tw = TileWarp::make<NT>();
  const int nt = tiles_below<C>(tw.n0, C);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sc[3];
#pragma unroll
  for (int m = 0; m < 3; ++m)
    sc[m] = (FULL ? m < NM : m < NM && lane + 32 * m < C) ? lns[lane + 32 * m] : 0.f;
  int stage = 0;
  for (int tile = blockIdx.x; tile < ntile; tile += gridDim.x, stage ^= 1) {
    const int next = tile + gridDim.x;
    if (next < ntile) {
      load_tile(dys + (stage ^ 1) * TOK * SO, SO, dy, (int64_t)next * TOK, ntok, O, O);
      cp_async_commit();
    }
    cp_async_wait(next < ntile ? 1 : 0);
    __syncthreads();
    float acc[2][NT][4];
    zero_acc(acc);
    mma_tile<false, false, 2, NT>(acc, dys + stage * TOK * SO, SO, tw.m0, wt, SO, tw.n0, O, 2, nt);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j < nt)
            *reinterpret_cast<float2*>(dxs + (tw.m0 + 16 * i + tw.g8 + 8 * h) * SC + tw.n0 + 8 * j + 2 * tw.t4) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    __syncthreads();
    // the LN backward of the warp's 8 tokens, 4 side by side (each token's
    // sums in the order of one token alone); the dscale / dbias sums over
    // the tokens in order
    float gsc[3] = {0.f, 0.f, 0.f}, gbi[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int a0 = 0; a0 < 8; a0 += 4) {
      float v[4][3], dxl[4][3], mean[4], rstd[4], s1[4], s2[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int lt = warp * 8 + a0 + a;
        mean[a] = rstd[a] = 0.f;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const bool on = FULL ? m < NM : m < NM && lane + 32 * m < C;
          v[a][m] = on ? x[((int64_t)tile * TOK + lt) * C + lane + 32 * m] : 0.f;
          dxl[a][m] = on ? dxs[lt * SC + lane + 32 * m] : 0.f;
          mean[a] += v[a][m];
          rstd[a] += v[a][m] * v[a][m];
        }
      }
      warp_sums(mean);
      warp_sums(rstd);
      float xh[4][3], dxh[4][3];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        mean[a] /= C;
        rstd[a] = 1.0f / sqrtf(fmaxf(rstd[a] / C - mean[a] * mean[a], 0.f) + 1e-6f);
        s1[a] = s2[a] = 0.f;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          xh[a][m] = dxh[a][m] = 0.f;
          if (FULL ? m < NM : m < NM && lane + 32 * m < C) {
            xh[a][m] = (v[a][m] - mean[a]) * rstd[a];
            dxh[a][m] = dxl[a][m] * sc[m];
            s1[a] += dxh[a][m];
            s2[a] += dxh[a][m] * xh[a][m];
          }
        }
      }
      warp_sums(s1);
      warp_sums(s2);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int64_t t = (int64_t)tile * TOK + warp * 8 + a0 + a;
        const float m1 = s1[a] / C, m2 = s2[a] / C;
#pragma unroll
        for (int m = 0; m < 3; ++m)
          if (FULL ? m < NM : m < NM && lane + 32 * m < C) {
            from_f(dx[t * C + lane + 32 * m], rstd[a] * (dxh[a][m] - m1 - xh[a][m] * m2));
            gsc[m] = fmaf(dxl[a][m], xh[a][m], gsc[m]);
            gbi[m] += dxl[a][m];
          }
      }
    }
#pragma unroll
    for (int m = 0; m < 3; ++m)
      if (FULL ? m < NM : m < NM && lane + 32 * m < C) {
        red[(warp * 2) * C + lane + 32 * m] = gsc[m];
        red[(warp * 2 + 1) * C + lane + 32 * m] = gbi[m];
      }
    __syncthreads();
    for (int e = threadIdx.x; e < 2 * C; e += blockDim.x) {
      float s = 0.f;
      for (int w8 = 0; w8 < 8; ++w8) s += red[(w8 * 2 + e / C) * C + e % C];
      lnpart[(int64_t)tile * 2 * C + e] = s;
    }
  }
}

// Weight gradients of one projection y = x_in W^T + b: block (chunk of TOKC
// tokens, R output rows o0 = blockIdx.y * R) writes part[chunk] = [dW (O, c)
// | db (O)] entries for its rows: dW[o][i] = sum_t dy[t][o] x_in[t][i],
// db[o] = sum_t dy[t][o].  x_in is LN(x) recomputed as the forward computes
// it when lns is given, else x itself.  Sub-tiles of TOK tokens land by
// cp.async (two stages); the product is the transposed form on the tensor
// cores (mma_tile, 3xTF32): warp w owns the m-tiles of rows [(w / 4) R/2,
// (w / 4 + 1) R/2) and n-tiles of columns [(w % 4) P, (w % 4 + 1) P) with P
// = 8 ceil(c / 32).  db[o] sums the sub-tiles' rows in order.  R in {32,
// 64, 96}, c a multiple of 16 up to 96.  Shared: dys [2][TOK][R + 8], xs
// [2][TOK][c + 8] (row strides 8 or 24 mod 32: conflict-free fragments).
// R16: R an odd multiple of 16 (16, 48, 80), its R / 16 m-tiles split ceil
// / floor between the two warp rows.
template <bool R16 = false>
__global__ void __launch_bounds__(THREADS, 2)
    wgrad_kernel(const float* __restrict__ x, const float* __restrict__ lns, const float* __restrict__ lnb,
                 const float* __restrict__ dy, float* __restrict__ part, int ntok, int c, int O, int R) {
  extern __shared__ __align__(16) float sm[];
  const int SR = R + 8, SX = c + 8;
  float* dys = sm;
  float* xs = dys + 2 * TOK * SR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int o0 = blockIdx.y * R;
  const int mt = R16 ? ((warp >> 2) ? R / 32 : R / 32 + 1) : R / 32, m0 = (warp >> 2) * (R16 ? R / 32 + 1 : mt) * 16;
  const int ct = c / 8, per = (ct + 3) / 4, n0 = (warp & 3) * per * 8;
  const int nt = min(per, max(0, ct - (warp & 3) * per));
  float lsc[3], lbi[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const bool on = lns != nullptr && lane + 32 * m < c;
    lsc[m] = on ? lns[lane + 32 * m] : 0.f;
    lbi[m] = on ? lnb[lane + 32 * m] : 0.f;
  }
  const int64_t tbeg = (int64_t)blockIdx.x * TOKC;
  const int64_t tend = tbeg + TOKC < ntok ? tbeg + TOKC : (int64_t)ntok;
  auto load = [&](int64_t t0, int stage) {
    load_tile(dys + stage * TOK * SR, SR, dy + o0, t0, (int)tend, R, O);
    load_tile(xs + stage * TOK * SX, SX, x, t0, (int)tend, c, c);
    cp_async_commit();
  };
  float acc[3][3][4];
  zero_acc(acc);
  float bacc = 0.f;
  load(tbeg, 0);
  int stage = 0;
  for (int64_t t0 = tbeg; t0 < tend; t0 += TOK, stage ^= 1) {
    const bool more = t0 + TOK < tend;
    if (more) load(t0 + TOK, stage ^ 1);
    cp_async_wait(more ? 1 : 0);
    __syncthreads();
    float* dyt = dys + stage * TOK * SR;
    float* xt = xs + stage * TOK * SX;
    if (lns != nullptr) {
      for (int r0 = warp; r0 < TOK; r0 += 4 * (THREADS / 32))  // 4 rows side by side
        ln_rows_inplace<4>(xt, SX, r0, THREADS / 32, TOK, c, lsc, lbi);
      __syncthreads();
    }
    if (threadIdx.x < R)
      for (int r = 0; r < TOK; ++r) bacc += dyt[r * SR + threadIdx.x];
    mma_tile<true, true, 3, 3>(acc, dyt, SR, m0, xt, SX, n0, TOK, mt, nt);
    __syncthreads();
  }
  float* p = part + (int64_t)blockIdx.x * (O * c + O);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (i < mt && j < nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = o0 + m0 + 16 * i + g8 + 8 * h, col = n0 + 8 * j + 2 * t4;
          *reinterpret_cast<float2*>(p + (int64_t)o * c + col) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
  if (threadIdx.x < R) p[O * c + o0 + threadIdx.x] = bacc;
}

// proj_ln_bwd_kernel for bf16 io (K3's and K5's bf16 backward): x, the LN
// scale and W bf16 as they are, dy float32 (dq or dkv, unrounded).  W (O, C)
// is staged once per CTA as it lies, [O][C + 8] bf16; each dy tile lands by
// cp.async (two stages), is rounded to bf16 into [TOK][O + 8] (the JAX
// kernel's cast before the product), and dx_ln = dy W runs on bf16
// m16n8k16 (mma_tile_bf16<false, true>) into shared memory; the LN
// backward, its sums and dx (rounded to bf16 once) as proj_ln_bwd_kernel,
// x widened as it is read.  Shared: wb [O][C + 8] bf16, dys [2][TOK][O + 4]
// float32, dyb [TOK][O + 8] bf16, dxs [TOK][C + 4], red [8][2][C] float32.
template <int C, int O>
__global__ void __launch_bounds__(THREADS, 1)
    proj_ln_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ lns,
                            const __nv_bfloat16* __restrict__ w, const float* __restrict__ dy,
                            __nv_bfloat16* __restrict__ dx, float* __restrict__ lnpart, int ntile) {
  using bf16 = __nv_bfloat16;
  constexpr int SW = C + 8, SO = O + 4, SB = O + 8, SC = C + 4, NT = col_tiles<C>(), NM = col_tiles<C>();
  constexpr bool FULL = C % 32 == 0;  // every lane's channels lane + 32 m, m < NM, are of the C
  extern __shared__ __align__(16) unsigned char pbwd_smem[];
  bf16* wb = reinterpret_cast<bf16*>(pbwd_smem);
  float* dys = reinterpret_cast<float*>(wb + O * SW);
  bf16* dyb = reinterpret_cast<bf16*>(dys + 2 * TOK * SO);
  float* dxs = reinterpret_cast<float*>(dyb + TOK * SB);
  float* red = dxs + TOK * SC;
  const int ntok = ntile * TOK;
  if (blockIdx.x < ntile) {
    load_tile(dys, SO, dy, (int64_t)blockIdx.x * TOK, ntok, O, O);
    cp_async_commit();
  }
  stage_rows(wb, w, O, C, SW);
  const TileWarp tw = TileWarp::make<NT>();
  const int nt = tiles_below<C>(tw.n0, C);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sc[3];
#pragma unroll
  for (int m = 0; m < 3; ++m)
    sc[m] = (FULL ? m < NM : m < NM && lane + 32 * m < C) ? to_f(lns[lane + 32 * m]) : 0.f;
  int stage = 0;
  for (int tile = blockIdx.x; tile < ntile; tile += gridDim.x, stage ^= 1) {
    const int next = tile + gridDim.x;
    if (next < ntile) {
      load_tile(dys + (stage ^ 1) * TOK * SO, SO, dy, (int64_t)next * TOK, ntok, O, O);
      cp_async_commit();
    }
    cp_async_wait(next < ntile ? 1 : 0);
    __syncthreads();
    const float* dyt = dys + stage * TOK * SO;
    for (int e = threadIdx.x; e < TOK * O / 2; e += blockDim.x) {
      const int r = e / (O / 2), c2 = 2 * (e % (O / 2));
      const float2 f = *reinterpret_cast<const float2*>(dyt + r * SO + c2);
      *reinterpret_cast<__nv_bfloat162*>(dyb + r * SB + c2) = __floats2bfloat162_rn(f.x, f.y);
    }
    __syncthreads();
    float acc[2][NT][4];
    zero_acc(acc);
    mma_tile_bf16<false, true, 2, NT>(acc, dyb, SB, tw.m0, wb, SW, tw.n0, O, 2, nt);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j < nt)
            *reinterpret_cast<float2*>(dxs + (tw.m0 + 16 * i + tw.g8 + 8 * h) * SC + tw.n0 + 8 * j + 2 * tw.t4) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    __syncthreads();
    // the LN backward of the warp's 8 tokens, as proj_ln_bwd_kernel
    float gsc[3] = {0.f, 0.f, 0.f}, gbi[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int a0 = 0; a0 < 8; a0 += 4) {
      float v[4][3], dxl[4][3], mean[4], rstd[4], s1[4], s2[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int lt = warp * 8 + a0 + a;
        mean[a] = rstd[a] = 0.f;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const bool on = FULL ? m < NM : m < NM && lane + 32 * m < C;
          v[a][m] = on ? to_f(x[((int64_t)tile * TOK + lt) * C + lane + 32 * m]) : 0.f;
          dxl[a][m] = on ? dxs[lt * SC + lane + 32 * m] : 0.f;
          mean[a] += v[a][m];
          rstd[a] += v[a][m] * v[a][m];
        }
      }
      warp_sums(mean);
      warp_sums(rstd);
      float xh[4][3], dxh[4][3];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        mean[a] /= C;
        rstd[a] = 1.0f / sqrtf(fmaxf(rstd[a] / C - mean[a] * mean[a], 0.f) + 1e-6f);
        s1[a] = s2[a] = 0.f;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          xh[a][m] = dxh[a][m] = 0.f;
          if (FULL ? m < NM : m < NM && lane + 32 * m < C) {
            xh[a][m] = (v[a][m] - mean[a]) * rstd[a];
            dxh[a][m] = dxl[a][m] * sc[m];
            s1[a] += dxh[a][m];
            s2[a] += dxh[a][m] * xh[a][m];
          }
        }
      }
      warp_sums(s1);
      warp_sums(s2);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int64_t t = (int64_t)tile * TOK + warp * 8 + a0 + a;
        const float m1 = s1[a] / C, m2 = s2[a] / C;
#pragma unroll
        for (int m = 0; m < 3; ++m)
          if (FULL ? m < NM : m < NM && lane + 32 * m < C) {
            dx[t * C + lane + 32 * m] = __float2bfloat16_rn(rstd[a] * (dxh[a][m] - m1 - xh[a][m] * m2));
            gsc[m] = fmaf(dxl[a][m], xh[a][m], gsc[m]);
            gbi[m] += dxl[a][m];
          }
      }
    }
#pragma unroll
    for (int m = 0; m < 3; ++m)
      if (FULL ? m < NM : m < NM && lane + 32 * m < C) {
        red[(warp * 2) * C + lane + 32 * m] = gsc[m];
        red[(warp * 2 + 1) * C + lane + 32 * m] = gbi[m];
      }
    __syncthreads();
    for (int e = threadIdx.x; e < 2 * C; e += blockDim.x) {
      float s = 0.f;
      for (int w8 = 0; w8 < 8; ++w8) s += red[(w8 * 2 + e / C) * C + e % C];
      lnpart[(int64_t)tile * 2 * C + e] = s;
    }
  }
}

// wgrad_kernel for bf16 io (K3's and K5's bf16 backward): x and the LN
// parameters bf16, dy float32 (unrounded).  x sub-tiles land as bf16 by
// cp.async and are normalized in place (ln_rows_inplace on the bf16 tile:
// float32 statistics, the result rounded to bf16, the JAX kernel's cast of
// the recomputed LN); db sums the unrounded dy sub-tile, which is then
// rounded to bf16 into [TOK][R + 8]; dW += dy^T x_ln on bf16 m16n8k16, both
// operands token-major and read transposed (mma_tile_bf16<true, true>).
// Blocks, chunks, warps and partial rows as wgrad_kernel.  Shared: dys
// [2][TOK][R + 4] float32, xs [2][TOK][c + 8] bf16, dyb [TOK][R + 8] bf16.
template <bool R16 = false>
__global__ void __launch_bounds__(THREADS, 2)
    wgrad_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ lns,
                      const __nv_bfloat16* __restrict__ lnb, const float* __restrict__ dy, float* __restrict__ part,
                      int ntok, int c, int O, int R) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const int SR = R + 4, SX = c + 8, SB = R + 8;
  float* dys = reinterpret_cast<float*>(wg_smem);
  bf16* xs = reinterpret_cast<bf16*>(dys + 2 * TOK * SR);
  bf16* dyb = xs + 2 * TOK * SX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int o0 = blockIdx.y * R;
  const int mt = R16 ? ((warp >> 2) ? R / 32 : R / 32 + 1) : R / 32, m0 = (warp >> 2) * (R16 ? R / 32 + 1 : mt) * 16;
  const int ct = c / 8, per = (ct + 3) / 4, n0 = (warp & 3) * per * 8;
  const int nt = min(per, max(0, ct - (warp & 3) * per));
  float lsc[3], lbi[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const bool on = lane + 32 * m < c;
    lsc[m] = on ? to_f(lns[lane + 32 * m]) : 0.f;
    lbi[m] = on ? to_f(lnb[lane + 32 * m]) : 0.f;
  }
  const int64_t tbeg = (int64_t)blockIdx.x * TOKC;
  const int64_t tend = tbeg + TOKC < ntok ? tbeg + TOKC : (int64_t)ntok;
  auto load = [&](int64_t t0, int stage) {
    load_tile(dys + stage * TOK * SR, SR, dy + o0, t0, (int)tend, R, O);
    load_tile(xs + stage * TOK * SX, SX, x, t0, (int)tend, c, c);
    cp_async_commit();
  };
  float acc[3][3][4];
  zero_acc(acc);
  float bacc = 0.f;
  load(tbeg, 0);
  int stage = 0;
  for (int64_t t0 = tbeg; t0 < tend; t0 += TOK, stage ^= 1) {
    const bool more = t0 + TOK < tend;
    if (more) load(t0 + TOK, stage ^ 1);
    cp_async_wait(more ? 1 : 0);
    __syncthreads();
    const float* dyt = dys + stage * TOK * SR;
    bf16* xt = xs + stage * TOK * SX;
    for (int r0 = warp; r0 < TOK; r0 += 4 * (THREADS / 32))  // 4 rows side by side
      ln_rows_inplace<4>(xt, SX, r0, THREADS / 32, TOK, c, lsc, lbi);
    if (threadIdx.x < R)
      for (int r = 0; r < TOK; ++r) bacc += dyt[r * SR + threadIdx.x];
    for (int e = threadIdx.x; e < TOK * R / 2; e += THREADS) {
      const int r = e / (R / 2), c2 = 2 * (e % (R / 2));
      const float2 f = *reinterpret_cast<const float2*>(dyt + r * SR + c2);
      *reinterpret_cast<__nv_bfloat162*>(dyb + r * SB + c2) = __floats2bfloat162_rn(f.x, f.y);
    }
    __syncthreads();
    mma_tile_bf16<true, true, 3, 3>(acc, dyb, SB, m0, xt, SX, n0, TOK, mt, nt);
    __syncthreads();
  }
  float* p = part + (int64_t)blockIdx.x * (O * c + O);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (i < mt && j < nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = o0 + m0 + 16 * i + g8 + 8 * h, col = n0 + 8 * j + 2 * t4;
          *reinterpret_cast<float2*>(p + (int64_t)o * c + col) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
  if (threadIdx.x < R) p[O * c + o0 + threadIdx.x] = bacc;
}

// out[e] = the sum over the rows r of part[r][e] in a fixed order: block
// (32 columns x SUM_GROUPS row groups), thread (column, g) adds rows g, g +
// SUM_GROUPS, ... in turn, then the group sums are added in order.  32 row
// groups keep a tall, narrow partial (the 2x2 windows' dbias: 1024 rows of
// 32 at B = 64) from resting on one block's few threads.  T: out's type
// (bf16: the sum rounded once as it is stored).
constexpr int SUM_GROUPS = 32;
template <typename T = float>
__global__ void sum_rows_kernel(const float* __restrict__ part, T* __restrict__ out, int rows, int cols) {
  __shared__ float red[SUM_GROUPS][33];
  const int e = blockIdx.x * 32 + threadIdx.x, g = threadIdx.y;
  float s = 0.f;
  if (e < cols)
    for (int r = g; r < rows; r += SUM_GROUPS) s += part[(int64_t)r * cols + e];
  red[g][threadIdx.x] = s;
  __syncthreads();
  if (g == 0 && e < cols) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < SUM_GROUPS; ++k) t += red[k][threadIdx.x];
    from_f(out[e], t);
  }
}

template <typename T>
cudaError_t launch_sum_rows(const float* part, T* out, int rows, int cols, cudaStream_t st) {
  ++kernel_launches;
  sum_rows_kernel<<<(cols + 31) / 32, dim3(32, SUM_GROUPS), 0, st>>>(part, out, rows, cols);
  return cudaGetLastError();
}

// Blocks per image of a group's attention backward: for windows of 4
// tokens bwd4_windows(gh) windows a block, else windows in batches of wpb,
// 4 batches a block.
inline int attn_bwd_chunks(int n, int gh, int nw) {
  if (n == 4) return (nw + bwd4_windows(gh) - 1) / bwd4_windows(gh);
  const int wpb = (n * gh >= 128) ? 1 : 128 / (n * gh);
  return (nw + 4 * wpb - 1) / (4 * wpb);
}

// OT: the type of dq, dk, dv, float32 or (with T bf16) bf16.
template <int N, bool DROP, int HD, typename T = float, typename OT = float>
cudaError_t launch_attn_bwd(const T* q, const T* k, const T* v, int kvs, const T* dout,
                            const float* bias, const float* mask, OT* dq, OT* dk, OT* dv, float* dbias_part,
                            float* dbias, int B, int H, int W, int D, int g, int gh, int ws, int sh, float scale,
                            uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t st) {
  const int wpb = (N * gh >= 128) ? 1 : 128 / (N * gh);
  const int nw = (H / ws) * (W / ws);
  const int nchunk = attn_bwd_chunks(N, gh, nw);
  if constexpr (N == 4) {
    const int vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(dq) &&
                    aligned16(dk) && aligned16(dv);
    const int wb = bwd4_windows(gh);
    const size_t smem4 = (size_t)4 * wb * 4 * (gh * HD + 4) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(window_attn_bwd4_kernel<DROP, HD, T, OT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem4);
    if (err != cudaSuccess) return err;
    ++kernel_launches;
    window_attn_bwd4_kernel<DROP, HD, T, OT><<<dim3(nchunk, B), wb * gh * 4, smem4, st>>>(
        q, k, v, kvs, dout, bias, mask, dq, dk, dv, dbias_part, H, W, D, g, gh, sh, scale, seed, thresh, inv_keep,
        vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    return launch_sum_rows(dbias_part, dbias, B * nchunk, gh * N * N, st);
  } else {
    // the tensor-core kernel (wpb windows a step, as below) where its
    // cp.async rows are 16-byte aligned
    if constexpr (sizeof(T) == 2) {
      if ((gh == 1 || gh == 2) && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)) {
        auto kern = gh == 1 ? window_attn_bwd_tc_bf16_kernel<N, 1, DROP, HD, OT>
                            : window_attn_bwd_tc_bf16_kernel<N, 2, DROP, HD, OT>;
        const size_t smem_tc =
            (size_t)wpb * (4 * N * fwd_ldq<HD>(gh * HD) + 2 * gh * N * (N + 8)) * sizeof(__nv_bfloat16);
        cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_tc);
        if (err != cudaSuccess) return err;
        ++kernel_launches;
        kern<<<dim3(nchunk, B), THREADS, smem_tc, st>>>(q, k, v, kvs, dout, bias, mask, dq, dk, dv, dbias_part, H,
                                                       W, D, g, ws, sh, 4 * wpb, scale, seed, thresh, inv_keep);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        return launch_sum_rows(dbias_part, dbias, B * nchunk, gh * N * N, st);
      }
    } else if ((gh == 1 || gh == 2) && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)) {
      auto kern = gh == 1 ? window_attn_bwd_tc_kernel<N, 1, DROP, HD> : window_attn_bwd_tc_kernel<N, 2, DROP, HD>;
      const size_t smem_tc = (size_t)wpb * (4 * N * (gh * HD + 4) + 2 * gh * N * (N + 4)) * sizeof(float);
      cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_tc);
      if (err != cudaSuccess) return err;
      ++kernel_launches;
      kern<<<dim3(nchunk, B), THREADS, smem_tc, st>>>(q, k, v, kvs, dout, bias, mask, dq, dk, dv, dbias_part, H, W,
                                                     D, g, ws, sh, 4 * wpb, scale, seed, thresh, inv_keep);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      return launch_sum_rows(dbias_part, dbias, B * nchunk, gh * N * N, st);
    }
    // more than 2 heads or unaligned rows: a thread per row
    const int threads = wpb * gh * N;
    const size_t smem =
        (size_t)(4 * wpb * N * gh * HD + 2 * wpb * gh * N * (N + 1) + gh * N * N) * sizeof(float);
    cudaFuncSetAttribute(window_attn_bwd_kernel<N, DROP, HD, T, OT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    ++kernel_launches;
    window_attn_bwd_kernel<N, DROP, HD, T, OT><<<dim3(nchunk, B), threads, smem, st>>>(
        q, k, v, kvs, dout, bias, mask, dq, dk, dv, dbias_part, H, W, D, g, gh, ws, sh, wpb, 4 * wpb, scale, seed,
        thresh, inv_keep);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_sum_rows(dbias_part, dbias, B * nchunk, gh * N * N, st);
  }
}

// The attention backward of every group.  dbias_part holds, per group, B *
// attn_bwd_chunks rows of gh * N^2 floats (attn_bwd_part_floats); dbias is
// laid out as the concatenated bias.
template <bool DROP, int HD, typename T, typename OT>
cudaError_t launch_attn_bwd_groups_hd(const T* q, const T* k, const T* v, int kvs, const T* dout,
                                      const float* bias, const float* mask, OT* dq, OT* dk, OT* dv,
                                      float* dbias_part, float* dbias, int B, int H, int W, int D, int n_group,
                                      const int* ws, const int* shifts, int gh, float scale, uint32_t seed,
                                      uint32_t thresh, float inv_keep, cudaStream_t st) {
  size_t boff = 0, moff = 0, poff = 0;
  for (int g = 0; g < n_group; ++g) {
    const int n = ws[g] * ws[g], sh = shifts[g];
    const float* mg = sh > 0 ? mask + moff : nullptr;
    cudaError_t err;
    switch (ws[g]) {
      case 2: err = launch_attn_bwd<4, DROP, HD, T, OT>(q, k, v, kvs, dout, bias + boff, mg, dq, dk, dv, dbias_part + poff, dbias + boff, B, H, W, D, g, gh, 2, sh, scale, seed, thresh, inv_keep, st); break;
      case 4: err = launch_attn_bwd<16, DROP, HD, T, OT>(q, k, v, kvs, dout, bias + boff, mg, dq, dk, dv, dbias_part + poff, dbias + boff, B, H, W, D, g, gh, 4, sh, scale, seed, thresh, inv_keep, st); break;
      case 8: err = launch_attn_bwd<64, DROP, HD, T, OT>(q, k, v, kvs, dout, bias + boff, mg, dq, dk, dv, dbias_part + poff, dbias + boff, B, H, W, D, g, gh, 8, sh, scale, seed, thresh, inv_keep, st); break;
      default: err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
    const int nw = (H / ws[g]) * (W / ws[g]);
    boff += (size_t)gh * n * n;
    poff += (size_t)B * attn_bwd_chunks(n, gh, nw) * gh * n * n;
    if (sh > 0) moff += (size_t)nw * n * n;
  }
  return cudaSuccess;
}

// The attention backward of every group, at the head dim D / n_group / gh
// (8, 16 or 32).
template <bool DROP, typename T, typename OT>
cudaError_t launch_attn_bwd_groups(const T* q, const T* k, const T* v, int kvs, const T* dout,
                                   const float* bias, const float* mask, OT* dq, OT* dk, OT* dv,
                                   float* dbias_part, float* dbias, int B, int H, int W, int D, int n_group,
                                   const int* ws, const int* shifts, int gh, float scale, uint32_t seed,
                                   uint32_t thresh, float inv_keep, cudaStream_t st) {
  switch (head_dim(D, n_group, gh)) {
    case 8: return launch_attn_bwd_groups_hd<DROP, 8, T, OT>(q, k, v, kvs, dout, bias, mask, dq, dk, dv, dbias_part, dbias, B, H, W, D, n_group, ws, shifts, gh, scale, seed, thresh, inv_keep, st);
    case 16: return launch_attn_bwd_groups_hd<DROP, 16, T, OT>(q, k, v, kvs, dout, bias, mask, dq, dk, dv, dbias_part, dbias, B, H, W, D, n_group, ws, shifts, gh, scale, seed, thresh, inv_keep, st);
    case 32: return launch_attn_bwd_groups_hd<DROP, 32, T, OT>(q, k, v, kvs, dout, bias, mask, dq, dk, dv, dbias_part, dbias, B, H, W, D, n_group, ws, shifts, gh, scale, seed, thresh, inv_keep, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename OT>
inline cudaError_t launch_attn_bwd_groups_any(const T* q, const T* k, const T* v, int kvs,
                                              const T* dout, const float* bias, const float* mask, OT* dq,
                                              OT* dk, OT* dv, float* dbias_part, float* dbias, int B, int H,
                                              int W, int D, int n_group, const int* ws, const int* shifts, int gh,
                                              float scale, uint32_t seed, uint32_t thresh, float inv_keep, int drop,
                                              cudaStream_t st) {
  return drop ? launch_attn_bwd_groups<true, T, OT>(q, k, v, kvs, dout, bias, mask, dq, dk, dv, dbias_part, dbias, B, H, W,
                                             D, n_group, ws, shifts, gh, scale, seed, thresh, inv_keep, st)
              : launch_attn_bwd_groups<false, T, OT>(q, k, v, kvs, dout, bias, mask, dq, dk, dv, dbias_part, dbias, B, H, W,
                                              D, n_group, ws, shifts, gh, scale, seed, thresh, inv_keep, st);
}

// The floats of dbias_part for launch_attn_bwd_groups.
inline size_t attn_bwd_part_floats(int B, int H, int W, int n_group, const int* ws, int gh) {
  size_t n_part = 0;
  for (int g = 0; g < n_group; ++g) {
    const int n = ws[g] * ws[g];
    n_part += (size_t)B * attn_bwd_chunks(n, gh, (H / ws[g]) * (W / ws[g])) * gh * n * n;
  }
  return n_part;
}

// Weight gradients of a projection, y = x_in W^T + b with W (O, c), summed
// over ntok tokens: a kernel per chunk of TOKC tokens into part (ceil(ntok /
// TOKC) rows of O*c + O), then the fixed-order sum into g = [dW | db].  X:
// the type of x, the LN parameters and g, float32 (wgrad_kernel) or bf16
// (wgrad_bf16_kernel; g rounded once), dy float32 either way.  O must be a
// multiple of D (the rows one block owns, D a multiple of 16 up to 96); c a
// multiple of 16 up to 96; x and dy 16-byte aligned.
template <typename X>
cudaError_t launch_wgrad(const X* x, const X* lns, const X* lnb, const float* dy, float* part, X* g, int ntok, int c,
                         int O, int D, cudaStream_t st) {
  if (!aligned16(x) || !aligned16(dy) || c % 16 != 0 || c > 96 || D % 16 != 0 || D > 96 || O % D != 0)
    return cudaErrorInvalidValue;
  const int nchunk = (ntok + TOKC - 1) / TOKC;
  cudaError_t err;
  if constexpr (sizeof(X) == 2) {
    const size_t smem = (size_t)2 * TOK * (D + 4) * sizeof(float) + (size_t)(2 * TOK * (c + 8) + TOK * (D + 8)) * 2;
    auto kern = D % 32 == 0 ? wgrad_bf16_kernel<false> : wgrad_bf16_kernel<true>;
    if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) != cudaSuccess)
      return err;
    ++kernel_launches;
    kern<<<dim3(nchunk, O / D), THREADS, smem, st>>>(x, lns, lnb, dy, part, ntok, c, O, D);
  } else {
    const size_t smem = (size_t)2 * TOK * (D + 8 + c + 8) * sizeof(float);
    auto kern = D % 32 == 0 ? wgrad_kernel<false> : wgrad_kernel<true>;
    if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) != cudaSuccess)
      return err;
    ++kernel_launches;
    kern<<<dim3(nchunk, O / D), THREADS, smem, st>>>(x, lns, lnb, dy, part, ntok, c, O, D);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_rows(part, g, nchunk, O * c + O, st);
}

// dx and the LN sums of one LN + projection pair (C channels, O outputs):
// proj_ln_bwd_kernel on float32, proj_ln_bwd_bf16_kernel on bf16 x, LN
// scale and W (dx in X either way, dy float32).
template <int C, int O, typename X>
cudaError_t launch_proj_ln_bwd(const X* x, const X* lns, const X* w, const float* dy, X* dx, float* lnpart, int ntok,
                               cudaStream_t st) {
  size_t smem;
  auto kern = [] {
    if constexpr (sizeof(X) == 2) return proj_ln_bwd_bf16_kernel<C, O>;
    else return proj_ln_bwd_kernel<C, O>;
  }();
  if constexpr (sizeof(X) == 2)
    smem = (size_t)O * (C + 8) * 2 + (size_t)2 * TOK * (O + 4) * sizeof(float) + (size_t)TOK * (O + 8) * 2 +
           (size_t)(TOK * (C + 4) + 16 * C) * sizeof(float);
  else
    smem = (size_t)(C * (O + 4) + 2 * TOK * (O + 4) + TOK * (C + 4) + 16 * C) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int grid = 0;
  if (err != cudaSuccess || (err = persistent_grid(ntok / TOK, &grid)) != cudaSuccess || grid == 0) return err;
  ++kernel_launches;
  kern<<<grid, THREADS, smem, st>>>(x, lns, w, dy, dx, lnpart, ntok / TOK);
  return cudaGetLastError();
}

// launch_proj_ln_bwd at O = k D (k = 1: q, 2: kv).  bf16 W 16-byte aligned
// (its rows are copied 16 bytes at a time).
template <typename X>
cudaError_t launch_proj_ln_bwd_any(const X* x, const X* lns, const X* w, const float* dy, X* dx, float* lnpart,
                                   int ntok, int D, int k, cudaStream_t st) {
  if (!aligned16(dy) || (sizeof(X) == 2 && !aligned16(w))) return cudaErrorMisalignedAddress;
  switch (D * 2 + k - 1) {
    case 32: return launch_proj_ln_bwd<16, 16>(x, lns, w, dy, dx, lnpart, ntok, st);
    case 33: return launch_proj_ln_bwd<16, 32>(x, lns, w, dy, dx, lnpart, ntok, st);
    case 64: return launch_proj_ln_bwd<32, 32>(x, lns, w, dy, dx, lnpart, ntok, st);
    case 65: return launch_proj_ln_bwd<32, 64>(x, lns, w, dy, dx, lnpart, ntok, st);
    case 96: return launch_proj_ln_bwd<48, 48>(x, lns, w, dy, dx, lnpart, ntok, st);
    case 97: return launch_proj_ln_bwd<48, 96>(x, lns, w, dy, dx, lnpart, ntok, st);
    case 128: return launch_proj_ln_bwd<64, 64>(x, lns, w, dy, dx, lnpart, ntok, st);
    case 129: return launch_proj_ln_bwd<64, 128>(x, lns, w, dy, dx, lnpart, ntok, st);
    case 160: return launch_proj_ln_bwd<80, 80>(x, lns, w, dy, dx, lnpart, ntok, st);
    case 161: return launch_proj_ln_bwd<80, 160>(x, lns, w, dy, dx, lnpart, ntok, st);
    case 192: return launch_proj_ln_bwd<96, 96>(x, lns, w, dy, dx, lnpart, ntok, st);
    case 193: return launch_proj_ln_bwd<96, 192>(x, lns, w, dy, dx, lnpart, ntok, st);
    default: return cudaErrorInvalidValue;
  }
}

// The backward of LN + the q and kv projections, from dq (B*L, D) and dkv
// (B*L, 2D), float32 and unrounded: dxq, dxkv; gq = [dWq | dbq], gkv = [dWkv
// | dbkv]; gln_q = [dqs | dqb], gln_kv = [dks | dkb].  X: the type of xq,
// xkv, the LN parameters, the weights, dx and the gradients — float32, or
// bf16 (K3's and K5's bf16 backward: the bias sums take dq / dkv unrounded,
// the products round them to bf16; each output written once, as bf16, by
// the kernel that finishes it).  Scratch: wpart_q (S, D*D + D), wpart_kv (S,
// 2D*D + 2D) with S = ceil(ntok / 512); lnpart_q, lnpart_kv (ntok / 64, 2D).
// ntok % 64 == 0.
template <typename X>
cudaError_t launch_ln_proj_bwd(const X* xq, const X* xkv, const X* qs, const X* qb, const X* ks, const X* kb,
                               const X* q_w, const X* kv_w, const float* dqbuf, const float* dkvbuf, float* wpart_q,
                               float* wpart_kv, float* lnpart_q, float* lnpart_kv, X* dxq, X* dxkv, X* gq, X* gkv,
                               X* gln_q, X* gln_kv, int ntok, int D, cudaStream_t st) {
  const X* xs[2] = {xq, xkv};
  const X* lns[2] = {qs, ks};
  const X* lnb[2] = {qb, kb};
  const X* wts[2] = {q_w, kv_w};
  const float* dys[2] = {dqbuf, dkvbuf};
  X* dxs[2] = {dxq, dxkv};
  float* lnparts[2] = {lnpart_q, lnpart_kv};
  X* glns[2] = {gln_q, gln_kv};
  float* wparts[2] = {wpart_q, wpart_kv};
  X* gws[2] = {gq, gkv};
  cudaError_t err;
  for (int k = 0; k < 2; ++k) {
    if ((err = launch_proj_ln_bwd_any(xs[k], lns[k], wts[k], dys[k], dxs[k], lnparts[k], ntok, D, k + 1, st)) !=
            cudaSuccess ||
        (err = launch_sum_rows(lnparts[k], glns[k], ntok / TOK, 2 * D, st)) != cudaSuccess ||
        (err = launch_wgrad(xs[k], lns[k], lnb[k], dys[k], wparts[k], gws[k], ntok, D, (k + 1) * D, D, st)) !=
            cudaSuccess)
      return err;
  }
  return cudaSuccess;
}
}  // namespace
