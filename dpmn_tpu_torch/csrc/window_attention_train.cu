// The training forward and backward of a PGRM window-attention block core,
// for sm_90a.
//
// Replaces the TPU kernel pair dpmn_tpu/ops/pallas_window_train.py::
// window_attention_block_core: the forward _block_fwd (pallas_call at :399)
// and the recomputing backward _block_bwd_impl (pallas_call at :525).  For
// pre-norm tokens xq, xkv of shape (B, L = H*W, D):
//   forward  LN (float32 statistics, var = E[x^2] - mean^2 clamped at 0,
//            eps 1e-6) of both streams, q = ln(xq) Wq^T + bq and
//            kv = ln(xkv) Wkv^T + bkv; per channel group (window ws, shift
//            sh, N = ws*ws) and head: the -sh roll, the window partition,
//            P = softmax(scale q k^T + rel_bias [+ shift mask]), the dropout
//            mask M on P (kept entries scaled by 1/keep), (P*M) v written in
//            the faithful raw layout (row window*N + i of each group slice).
//   backward from the primal inputs and dout only: recompute LN and the
//            projections; per (image, group, window, head) regenerate P and
//            M and form dV = (P*M)^T dO, dP = (dO V^T)*M,
//            dS = P*(dP - rowsum(dP*P)), dQ = scale dS K, dK = dS^T (scale Q);
//            un-partition and un-roll them to token order; dbias = sum of dS
//            over images and windows; the projection backward
//            (dx_ln = dq Wq, dWq = dq^T x_ln, dbq = sum dq; the same for kv)
//            and the LN backward (dscale = sum dx_ln*xhat, dbias = sum dx_ln).
// Every cross-block sum goes through per-block partials and a second,
// fixed-order pass (sum_rows_kernel): no float atomics, so reruns agree bit
// for bit.  The dropout mask is the counter-based hash of window_common.cuh,
// which the plain PyTorch version evaluates exactly.
//
// What bounds it on an H100 at B = 64 and the flagship geometry (L = 1024,
// D = 96, windows 2/4/8, 2 heads of 16 per group), each input read once and
// each output written once: forward 75.5 MB (xq, xkv, out) and 4.3 GFLOP
// (projections 3.62, attention 0.70) = 65 us at 67 TFLOP/s float32;
// backward 126 MB (xq, xkv, dout, dxq, dxkv) and 12.6 GFLOP (recomputed
// projections 3.62, attention backward with the recomputed scores 1.76,
// projection backward 7.25) = 188 us.  Both are bound by operations.  This
// first design runs everything on CUDA cores and round-trips q, kv, dq and
// dkv through device memory; wgmma for the projection products and keeping
// q/kv on chip are later work.

#include "window_common.cuh"

namespace {

constexpr int TOKC = 512;  // tokens per block of the weight-gradient kernel

// Attention backward of one channel group.  Block (chunk, image) walks
// `wchunk` windows, `wpb` at a time; thread (window, head, row).  Shared:
// scaled q, k, v and dout of the wpb windows [wpb][N][ch] each; dS and P*M
// [wpb][gh][N][N + 1] (padded rows); the block's dbias sum [gh][N][N].
template <int N, bool DROP>
__global__ void window_attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                                       const float* __restrict__ dout, const float* __restrict__ bias,
                                       const float* __restrict__ mask, float* __restrict__ dq,
                                       float* __restrict__ dkv, float* __restrict__ dbias_part, int H, int W,
                                       int D, int g, int gh, int ws, int sh, int wpb, int wchunk, float scale,
                                       uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ float sm[];
  constexpr int NP = N + 1;
  const int ch = gh * GCH, L = H * W;
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
        qv = q[tok * D + g * ch + c] * scale;
        kval = kv[tok * 2 * D + g * ch + c];
        vval = kv[tok * 2 * D + D + g * ch + c];
        dov = dout[(base + (int64_t)widx * N + j) * D + g * ch + c];
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
      const float* kw = ks_ + lw * N * ch + hd * GCH;
      const float* vw = vs_ + lw * N * ch + hd * GCH;
      float qv[GCH], dov[GCH];
#pragma unroll
      for (int d = 0; d < GCH; ++d) {
        qv[d] = qs_[(lw * N + r) * ch + hd * GCH + d];
        dov[d] = dos_[(lw * N + r) * ch + hd * GCH + d];
      }
      const float* brow = bias + (hd * N + r) * N;
      const float* mrow = sh > 0 ? mask + ((int64_t)widx * N + r) * N : nullptr;
      float s[N];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < GCH; ++d) acc = fmaf(qv[d], kw[j * ch + d], acc);
        acc += __ldg(brow + j);
        if (mrow) acc += __ldg(mrow + j);
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
        for (int d = 0; d < GCH; ++d) dp = fmaf(dov[d], vw[j * ch + d], dp);
        float pm = p;
        if (DROP) {
          const float m = (hash_step(rkey, j) & 0x7fffffffu) < thresh ? inv_keep : 0.f;
          dp *= m;
          pm = p * m;
        }
        pdrow[j] = pm;
        dsrow[j] = dp;
        rowsum = fmaf(dp, p, rowsum);
      }
      float dqv[GCH];
#pragma unroll
      for (int d = 0; d < GCH; ++d) dqv[d] = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float dsv = s[j] * (dsrow[j] - rowsum);
        dsrow[j] = dsv;
#pragma unroll
        for (int d = 0; d < GCH; ++d) dqv[d] = fmaf(dsv, kw[j * ch + d], dqv[d]);
      }
      float* dqrow = dq + (base + window_token(widx, r, ws, nwc, sh, H, W)) * D + g * ch + hd * GCH;
#pragma unroll
      for (int d = 0; d < GCH; ++d) dqrow[d] = dqv[d] * scale;
    } else {
      for (int j = 0; j < N; ++j) dsrow[j] = pdrow[j] = 0.f;
    }
    __syncthreads();
    // column pass: thread row r is key j
    if (valid) {
      const float* qw = qs_ + lw * N * ch + hd * GCH;
      const float* dow = dos_ + lw * N * ch + hd * GCH;
      const float* dsb = ds_ + (lw * gh + hd) * N * NP;
      const float* pdb = pd_ + (lw * gh + hd) * N * NP;
      float dk[GCH], dv[GCH];
#pragma unroll
      for (int d = 0; d < GCH; ++d) dk[d] = dv[d] = 0.f;
      for (int i = 0; i < N; ++i) {
        const float a = dsb[i * NP + r], pm = pdb[i * NP + r];
#pragma unroll
        for (int d = 0; d < GCH; ++d) {
          dk[d] = fmaf(a, qw[i * ch + d], dk[d]);
          dv[d] = fmaf(pm, dow[i * ch + d], dv[d]);
        }
      }
      float* dkrow = dkv + (base + window_token(widx, r, ws, nwc, sh, H, W)) * 2 * D + g * ch + hd * GCH;
#pragma unroll
      for (int d = 0; d < GCH; ++d) {
        dkrow[d] = dk[d];
        dkrow[D + d] = dv[d];
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

// The LN statistics of one token of c <= 96 values, lane-strided: the
// warp's lanes hold v[m] = x[lane + 32 m] (0 past c).  Returns (mean, rstd) as in the
// forward's ln_proj_kernel.
__device__ __forceinline__ float2 ln_stats(const float (&v)[3], int c) {
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int m = 0; m < 3; ++m) {  // lanes past c hold 0
    sum += v[m];
    sq += v[m] * v[m];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float mean = sum / c;
  const float var = fmaxf(sq / c - mean * mean, 0.f);
  return make_float2(mean, 1.0f / sqrtf(var + 1e-6f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dx of one LN + projection pair, 64 tokens per block: dx_ln = dy W (W in
// torch layout (O, c)), then the LN backward
// dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), dxhat = dx_ln*scale;
// and this block's sums of dx_ln*xhat and dx_ln (lnpart [block][2][c]).
// Shared: w [O][c], dy [TOK][O], red [8][2][c].
__global__ void proj_ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ lns,
                                   const float* __restrict__ w, const float* __restrict__ dy,
                                   float* __restrict__ dx, float* __restrict__ lnpart, int c, int O) {
  extern __shared__ float sm[];
  float* ws_ = sm;
  float* dys = ws_ + O * c;
  float* red = dys + TOK * O;
  const int64_t t0 = (int64_t)blockIdx.x * TOK;
  for (int idx = threadIdx.x; idx < O * c; idx += blockDim.x) ws_[idx] = w[idx];
  for (int idx = threadIdx.x; idx < TOK * O; idx += blockDim.x) dys[idx] = dy[t0 * O + idx];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nm = c / 32;
  float acc[8][3];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int m = 0; m < 3; ++m) acc[a][m] = 0.f;
  for (int o = 0; o < O; ++o) {
    float wv[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) wv[m] = m < nm ? ws_[o * c + lane + 32 * m] : 0.f;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float d = dys[(warp * 8 + a) * O + o];
#pragma unroll
      for (int m = 0; m < 3; ++m) acc[a][m] = fmaf(d, wv[m], acc[a][m]);
    }
  }
  float gsc[3] = {0.f, 0.f, 0.f}, gbi[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int64_t t = t0 + warp * 8 + a;
    float v[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) v[m] = m < nm ? x[t * c + lane + 32 * m] : 0.f;
    const float2 st = ln_stats(v, c);
    float xh[3], dxh[3], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      xh[m] = dxh[m] = 0.f;
      if (m < nm) {
        xh[m] = (v[m] - st.x) * st.y;
        dxh[m] = acc[a][m] * lns[lane + 32 * m];
        s1 += dxh[m];
        s2 += dxh[m] * xh[m];
        gsc[m] = fmaf(acc[a][m], xh[m], gsc[m]);
        gbi[m] += acc[a][m];
      }
    }
    const float m1 = warp_sum(s1) / c, m2 = warp_sum(s2) / c;
#pragma unroll
    for (int m = 0; m < 3; ++m)
      if (m < nm) dx[t * c + lane + 32 * m] = st.y * (dxh[m] - m1 - xh[m] * m2);
  }
#pragma unroll
  for (int m = 0; m < 3; ++m)
    if (m < nm) {
      red[(warp * 2) * c + lane + 32 * m] = gsc[m];
      red[(warp * 2 + 1) * c + lane + 32 * m] = gbi[m];
    }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * c; e += blockDim.x) {
    float s = 0.f;
    for (int w8 = 0; w8 < 8; ++w8) s += red[(w8 * 2 + e / c) * c + e % c];
    lnpart[(int64_t)blockIdx.x * 2 * c + e] = s;
  }
}

// Weight gradients of one LN + projection pair: block (chunk of TOKC tokens,
// D output rows o0 = blockIdx.y * D) writes part[chunk] = [dW (O, c) | db (O)]
// entries for its rows: dW[o][i] = sum_t dy[t][o] x_ln[t][i], db[o] =
// sum_t dy[t][o], x_ln recomputed from x as the forward computes it.  Warp w
// owns rows o0 + w*R .. + R (R = D/8), lane the columns lane + 32 m.
// Shared: xs [TOK][c], dys [TOK][D].
__global__ void wgrad_kernel(const float* __restrict__ x, const float* __restrict__ lns,
                             const float* __restrict__ lnb, const float* __restrict__ dy,
                             float* __restrict__ part, int ntok, int c, int O, int D) {
  extern __shared__ float sm[];
  float* xs = sm;
  float* dys = xs + TOK * c;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nm = c / 32, R = D / 8;
  const int o0 = blockIdx.y * D;
  float acc[12][3];
#pragma unroll
  for (int r = 0; r < 12; ++r)
#pragma unroll
    for (int m = 0; m < 3; ++m) acc[r][m] = 0.f;
  float bacc = 0.f;
  const int64_t tbeg = (int64_t)blockIdx.x * TOKC;
  const int64_t tend = tbeg + TOKC < ntok ? tbeg + TOKC : (int64_t)ntok;
  for (int64_t t0 = tbeg; t0 < tend; t0 += TOK) {
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int lt = warp * 8 + a;
      float v[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) v[m] = m < nm ? x[(t0 + lt) * c + lane + 32 * m] : 0.f;
      const float2 st = ln_stats(v, c);
#pragma unroll
      for (int m = 0; m < 3; ++m)
        if (m < nm) {
          const int i = lane + 32 * m;
          xs[lt * c + i] = (v[m] - st.x) * st.y * lns[i] + lnb[i];
        }
    }
    for (int idx = threadIdx.x; idx < TOK * D; idx += blockDim.x)
      dys[idx] = dy[(t0 + idx / D) * O + o0 + idx % D];
    __syncthreads();
    for (int tt = 0; tt < TOK; ++tt) {
      float xv[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) xv[m] = m < nm ? xs[tt * c + lane + 32 * m] : 0.f;
#pragma unroll
      for (int r = 0; r < 12; ++r) {
        if (r < R) {
          const float d = dys[tt * D + warp * R + r];
#pragma unroll
          for (int m = 0; m < 3; ++m) acc[r][m] = fmaf(d, xv[m], acc[r][m]);
        }
      }
    }
    if (threadIdx.x < D)
      for (int tt = 0; tt < TOK; ++tt) bacc += dys[tt * D + threadIdx.x];
    __syncthreads();
  }
  float* p = part + (int64_t)blockIdx.x * (O * c + O);
#pragma unroll
  for (int r = 0; r < 12; ++r)
#pragma unroll
    for (int m = 0; m < 3; ++m)
      if (r < R && m < nm) p[(o0 + warp * R + r) * c + lane + 32 * m] = acc[r][m];
  if (threadIdx.x < D) p[O * c + o0 + threadIdx.x] = bacc;
}

// out[e] = sum over rows r = 0, 1, ... of part[r][e], in that order.
__global__ void sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out, int rows, int cols) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= cols) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(int64_t)r * cols + e];
  out[e] = s;
}

cudaError_t launch_sum_rows(const float* part, float* out, int rows, int cols, cudaStream_t st) {
  sum_rows_kernel<<<(cols + 255) / 256, 256, 0, st>>>(part, out, rows, cols);
  return cudaGetLastError();
}

// Windows a backward block walks: 4 batches of wpb (ops/window_attention_train.py
// sizes dbias_part from the same rule).
template <int N, bool DROP>
cudaError_t launch_attn_bwd(const float* q, const float* kv, const float* dout, const float* bias,
                            const float* mask, float* dq, float* dkv, float* dbias_part, float* dbias, int B,
                            int H, int W, int D, int g, int gh, int ws, int sh, float scale, uint32_t seed,
                            uint32_t thresh, float inv_keep, cudaStream_t st) {
  const int wpb = (N * gh >= 128) ? 1 : 128 / (N * gh);
  const int nw = (H / ws) * (W / ws);
  const int wchunk = 4 * wpb;
  const int nchunk = (nw + wchunk - 1) / wchunk;
  const int threads = wpb * gh * N;
  const size_t smem = (size_t)(4 * wpb * N * gh * GCH + 2 * wpb * gh * N * (N + 1) + gh * N * N) * sizeof(float);
  cudaFuncSetAttribute(window_attn_bwd_kernel<N, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  window_attn_bwd_kernel<N, DROP><<<dim3(nchunk, B), threads, smem, st>>>(
      q, kv, dout, bias, mask, dq, dkv, dbias_part, H, W, D, g, gh, ws, sh, wpb, wchunk, scale, seed, thresh,
      inv_keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_rows(dbias_part, dbias, B * nchunk, gh * N * N, st);
}

template <bool DROP>
cudaError_t launch_attn_bwd_groups(const float* q, const float* kv, const float* dout, const float* bias,
                                   const float* mask, float* dq, float* dkv, float* dbias_part, float* dbias,
                                   int B, int H, int W, int D, int n_group, const int* ws, const int* shifts,
                                   int gh, float scale, uint32_t seed, uint32_t thresh, float inv_keep,
                                   cudaStream_t st) {
  size_t boff = 0, moff = 0, poff = 0;
  for (int g = 0; g < n_group; ++g) {
    const int n = ws[g] * ws[g], sh = shifts[g];
    const float* mg = sh > 0 ? mask + moff : nullptr;
    cudaError_t err;
    switch (ws[g]) {
      case 2: err = launch_attn_bwd<4, DROP>(q, kv, dout, bias + boff, mg, dq, dkv, dbias_part + poff, dbias + boff, B, H, W, D, g, gh, 2, sh, scale, seed, thresh, inv_keep, st); break;
      case 4: err = launch_attn_bwd<16, DROP>(q, kv, dout, bias + boff, mg, dq, dkv, dbias_part + poff, dbias + boff, B, H, W, D, g, gh, 4, sh, scale, seed, thresh, inv_keep, st); break;
      case 8: err = launch_attn_bwd<64, DROP>(q, kv, dout, bias + boff, mg, dq, dkv, dbias_part + poff, dbias + boff, B, H, W, D, g, gh, 8, sh, scale, seed, thresh, inv_keep, st); break;
      default: err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
    const int nw = (H / ws[g]) * (W / ws[g]);
    const int wpb = (n * gh >= 128) ? 1 : 128 / (n * gh);
    const int nchunk = (nw + 4 * wpb - 1) / (4 * wpb);
    boff += (size_t)gh * n * n;
    poff += (size_t)B * nchunk * gh * n * n;
    if (sh > 0) moff += (size_t)nw * n * n;
  }
  return cudaSuccess;
}

}  // namespace

// Shapes: xq, xkv, out (B, L, D) with L = H*W; q_w (D, D), kv_w (2D, D) in
// torch Linear layout; LN scales and biases (D,).  bias: per group
// (gh, N_g, N_g), concatenated; mask: per shifted group (nW_g, N_g, N_g),
// concatenated.  Scratch: qbuf (B, L, D), kvbuf (B, L, 2D).  ws and shifts
// are host arrays of n_group ints.  With drop, entries whose hash clears
// thresh are kept and scaled by inv_keep.  Needs L % 64 == 0, D % 32 == 0
// with D <= 96, windows of 2, 4 or 8 dividing H and W, and a head dim of
// GCH = 16; the Python wrapper checks these.  Returns cudaGetLastError()
// after the last launch (or the first failing one).
extern "C" int window_attention_train_forward(
    const float* xq, const float* xkv, const float* qs, const float* qb, const float* ks, const float* kb,
    const float* q_w, const float* q_b, const float* kv_w, const float* kv_b, const float* bias,
    const float* mask, float* qbuf, float* kvbuf, float* out, int B, int H, int W, int D, int n_group,
    const int* ws, const int* shifts, int gh, float scale, uint32_t seed, uint32_t thresh, float inv_keep,
    int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D / n_group != gh * GCH) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_ln_proj(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, B * H * W, D, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = drop ? launch_attn_groups<true>(qbuf, kvbuf, bias, mask, out, B, H, W, D, n_group, ws, shifts, gh, scale, 0,
                                        seed, thresh, inv_keep, st)
             : launch_attn_groups<false>(qbuf, kvbuf, bias, mask, out, B, H, W, D, n_group, ws, shifts, gh, scale,
                                         0, seed, thresh, inv_keep, st);
  return static_cast<int>(err);
}

// The backward, from the forward's inputs and dout (B, L, D).  Scratch the
// caller allocates: qbuf (B, L, D), kvbuf (B, L, 2D), dqbuf (B, L, D), dkvbuf
// (B, L, 2D), dbias_part (sum over groups of B * nchunk_g * gh * N_g^2; see
// launch_attn_bwd), wpart_q (S, D*D + D) and wpart_kv (S, 2D*D + 2D) with
// S = ceil(B*L / 512), lnpart_q and lnpart_kv (B*L / 64, 2D).  Outputs: dxq,
// dxkv (B, L, D); gq = [dWq (D, D) | dbq (D)], gkv = [dWkv (2D, D) | dbkv
// (2D)]; gln_q = [dqs | dqb], gln_kv = [dks | dkb] (2D each); dbias laid out
// as bias.
extern "C" int window_attention_train_backward(
    const float* xq, const float* xkv, const float* qs, const float* qb, const float* ks, const float* kb,
    const float* q_w, const float* q_b, const float* kv_w, const float* kv_b, const float* bias,
    const float* mask, const float* dout, float* qbuf, float* kvbuf, float* dqbuf, float* dkvbuf,
    float* dbias_part, float* wpart_q, float* wpart_kv, float* lnpart_q, float* lnpart_kv, float* dxq,
    float* dxkv, float* gq, float* gkv, float* gln_q, float* gln_kv, float* dbias, int B, int H, int W, int D,
    int n_group, const int* ws, const int* shifts, int gh, float scale, uint32_t seed, uint32_t thresh,
    float inv_keep, int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntok = B * H * W;
  if (D / n_group != gh * GCH) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_ln_proj(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, D, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = drop ? launch_attn_bwd_groups<true>(qbuf, kvbuf, dout, bias, mask, dqbuf, dkvbuf, dbias_part, dbias, B, H,
                                            W, D, n_group, ws, shifts, gh, scale, seed, thresh, inv_keep, st)
             : launch_attn_bwd_groups<false>(qbuf, kvbuf, dout, bias, mask, dqbuf, dkvbuf, dbias_part, dbias, B, H,
                                             W, D, n_group, ws, shifts, gh, scale, seed, thresh, inv_keep, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* xs[2] = {xq, xkv};
  const float* lns[2] = {qs, ks};
  const float* lnb[2] = {qb, kb};
  const float* wts[2] = {q_w, kv_w};
  const float* dys[2] = {dqbuf, dkvbuf};
  float* dxs[2] = {dxq, dxkv};
  float* lnparts[2] = {lnpart_q, lnpart_kv};
  float* glns[2] = {gln_q, gln_kv};
  float* wparts[2] = {wpart_q, wpart_kv};
  float* gws[2] = {gq, gkv};
  const int nchunk = (ntok + TOKC - 1) / TOKC;
  for (int k = 0; k < 2; ++k) {
    const int O = (k + 1) * D;
    const size_t smem_p = (size_t)(O * D + TOK * O + 16 * D) * sizeof(float);
    cudaFuncSetAttribute(proj_ln_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_p);
    proj_ln_bwd_kernel<<<ntok / TOK, THREADS, smem_p, st>>>(xs[k], lns[k], wts[k], dys[k], dxs[k], lnparts[k], D, O);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if ((err = launch_sum_rows(lnparts[k], glns[k], ntok / TOK, 2 * D, st)) != cudaSuccess)
      return static_cast<int>(err);
    const size_t smem_w = (size_t)(2 * TOK * D) * sizeof(float);
    wgrad_kernel<<<dim3(nchunk, k + 1), THREADS, smem_w, st>>>(xs[k], lns[k], lnb[k], dys[k], wparts[k], ntok, D, O,
                                                              D);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if ((err = launch_sum_rows(wparts[k], gws[k], nchunk, O * D + O, st)) != cudaSuccess)
      return static_cast<int>(err);
  }
  return cudaSuccess;
}
