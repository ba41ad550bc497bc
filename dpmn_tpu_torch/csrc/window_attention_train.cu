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
// projection backward 7.25) = 188 us.  The design: the projections, their
// backward (dx_ln = dy W and dW = dy^T x_ln) and the attention backward of
// the 4x4 and 8x8 windows run on the tensor cores (mma.sync with the 3xTF32
// split, tc_common.cuh); the LN + projection and the projection backward
// are persistent CTAs that stage their weight once; the forward attention
// is window_common.cuh window_attn_fwd_kernel (4x4 and 8x8 windows on the
// tensor cores), the 2x2 windows' backward window_attn_bwd4_kernel.
// Measured on an H100 SXM at 700 W (PERF.md): forward about 0.22 ms a call
// (ln_proj 0.13, the attention 0.07), backward about 0.72 ms (the
// projection backward and dW 0.35, ln_proj 0.13, the attention backward
// 0.18, of it 0.03 the 2x2 windows', the fixed-order sums 0.03).  q, kv, dq
// and dkv still round-trip through device memory.
//
// bf16 io (the bf16 AMP train step; the JAX kernel on bf16 inputs takes
// dt = xq.dtype, :361 and :421): xq, xkv, the LN parameters, the weights and
// their biases, out, dout, dxq, dxkv and the parameter gradients are bf16;
// the relative-position bias (as the JAX package passes it,
// dpmn_tpu/models/pgrm.py:405-407), the mask and dbias float32.  The JAX
// kernel's rounding points: the LN in float32 rounded to bf16; each
// projection summed in float32 with its bias and rounded to bf16; q times
// the scale rounded to bf16, the product rounded to bf16 (:301; dq takes the
// float32 scale, :114); the scores, the
// softmax and the dropout in float32, P rounded to bf16 once before P v, out
// rounded once.  Backward: P*M and dS rounded to bf16 before their products
// (dbias sums the unrounded dS), dq / dkv in float32 rounded to bf16 before
// the projection backward (db sums them unrounded), weight, bias and LN
// gradients summed in float32 and rounded once, dx through the float32 LN
// backward rounded once.  The forward is one launch
// (window_common.cuh window_block_fwd_bf16_kernel): per step of 64 tokens of
// one group, the xq and xkv rows by cp.async, the LN and the group's q, k, v
// projections on bf16 m16n8k16 into shared memory, then the attention step
// there, so q and kv never reach device memory (the JAX kernel's reason for
// its fusion, pallas_window_train.py:331-332): a call moves xq, xkv and out,
// 37.7 MB at the flagship geometry, where the two launches it replaces
// (ln_proj_bf16_kernel writing bf16 q / kv, then the attention forward)
// moved 113 MB.  The backward reads every
// bf16 tensor as it is and runs its products on bf16 m16n8k16 with float32
// accumulation (a product of two bf16 values is exact in float32, so one
// pass computes what 3xTF32 computed on widened copies, up to the order of
// the sums); it makes no float32 copy of xq, xkv, dout, q or kv and no
// widening or narrowing pass.  Its launches at three window groups (15):
//   ln_proj_bf16_kernel: q, kv recomputed in bf16                     1
//   per group: window_attn_bwd_tc_bf16_kernel (4x4, 8x8 windows;
//     window_attn_bwd4_kernel for 2x2, widening its rows as staged)
//     writing float32 dq, dkv, then sum_rows_kernel for dbias         2 x 3
//   per projection (q, kv): proj_ln_bwd_bf16_kernel (dx in bf16, the LN
//     partials), sum_rows_kernel<bf16> (dscale, dbias),
//     wgrad_bf16_kernel, sum_rows_kernel<bf16> (dW, db)               4 x 2
// Bound at B = 64, flagship geometry: 62.9 MB of bf16 (xq, xkv, dout, dxq,
// dxkv) = 18.8 us at 3.35 TB/s, against 12.63 GFLOP on bf16 operands =
// 12.8 us at 989 TFLOP/s: 0.019 ms a call, bound by bytes.  dq and dkv
// (float32, 75.5 MB, written once and read twice) and the recomputed q / kv
// still round-trip through device memory.

#include "window_train_common.cuh"

using bf16 = __nv_bfloat16;

namespace {

// The scratch of the bf16 backward, carved from one float buffer, every
// piece a multiple of 4 floats (16-byte aligned): q and kv recomputed in
// bf16, the attention backward's dq and dkv in float32 (unrounded, for the
// bias sums), the dbias, weight-gradient and LN partial rows.
struct Bf16BwdWork {
  bf16 *qh, *kvh;
  float *dq, *dkv, *dbias_part, *wpart_q, *wpart_kv, *lnpart_q, *lnpart_kv;
  size_t floats;

  Bf16BwdWork(float* base, int B, int H, int W, int D, int n_group, const int* ws, int gh) {
    const size_t ntok = (size_t)B * H * W, nd = ntok * D, nchunk = (ntok + TOKC - 1) / TOKC;
    size_t off = 0;
    auto take = [&](size_t n) {
      float* p = base ? base + off : nullptr;
      off += (n + 3) / 4 * 4;
      return p;
    };
    qh = reinterpret_cast<bf16*>(take((nd + 1) / 2));
    kvh = reinterpret_cast<bf16*>(take(nd));
    dq = take(nd), dkv = take(2 * nd);
    dbias_part = take(attn_bwd_part_floats(B, H, W, n_group, ws, gh));
    wpart_q = take(nchunk * (D * D + D)), wpart_kv = take(nchunk * (2 * D * D + 2 * D));
    lnpart_q = take(ntok / TOK * 2 * D), lnpart_kv = take(ntok / TOK * 2 * D);
    floats = off;
  }
};

}  // namespace

// Shapes: xq, xkv, out (B, L, D) with L = H*W; q_w (D, D), kv_w (2D, D) in
// torch Linear layout; LN scales and biases (D,).  bias: per group
// (gh, N_g, N_g), concatenated; mask: per shifted group (nW_g, N_g, N_g),
// concatenated.  Scratch: qbuf (B, L, D), kvbuf (B, L, 2D).  ws and shifts
// are host arrays of n_group ints.  With drop, entries whose hash clears
// thresh are kept and scaled by inv_keep.  Needs L % 64 == 0, D a multiple
// of 16 up to 96, windows of 2, 4 or 8 dividing H and W, and a head dim of
// 8, 16 or 32; the Python wrapper checks these.  Returns cudaGetLastError()
// after the last launch (or the first failing one).
extern "C" int window_attention_train_forward(
    const float* xq, const float* xkv, const float* qs, const float* qb, const float* ks, const float* kb,
    const float* q_w, const float* q_b, const float* kv_w, const float* kv_b, const float* bias,
    const float* mask, float* qbuf, float* kvbuf, float* out, int B, int H, int W, int D, int n_group,
    const int* ws, const int* shifts, int gh, float scale, uint32_t seed, uint32_t thresh, float inv_keep,
    int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!head_dim(D, n_group, gh)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_ln_proj(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, B * H * W, D, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_attn_groups_any(qbuf, kvbuf, kvbuf + D, 2 * D, bias, mask, out, B, H, W, D, n_group, ws, shifts, gh,
                               scale, 0, seed, thresh, inv_keep, drop, st);
  return static_cast<int>(err);
}

// The floats of the backward's dbias_part scratch.
extern "C" size_t window_attention_train_backward_scratch(int B, int H, int W, int n_group, const int* ws, int gh) {
  return attn_bwd_part_floats(B, H, W, n_group, ws, gh);
}

// The backward, from the forward's inputs and dout (B, L, D).  Scratch the
// caller allocates: qbuf (B, L, D), kvbuf (B, L, 2D), dqbuf (B, L, D), dkvbuf
// (B, L, 2D), dbias_part (window_attention_train_backward_scratch floats),
// wpart_q (S, D*D + D) and wpart_kv (S, 2D*D + 2D) with
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
  if (!head_dim(D, n_group, gh)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_ln_proj(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, D, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_attn_bwd_groups_any(qbuf, kvbuf, kvbuf + D, 2 * D, dout, bias, mask, dqbuf, dkvbuf, dkvbuf + D,
                                   dbias_part, dbias, B, H, W, D, n_group, ws, shifts, gh, scale, seed, thresh,
                                   inv_keep, drop, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ln_proj_bwd(xq, xkv, qs, qb, ks, kb, q_w, kv_w, dqbuf, dkvbuf, wpart_q, wpart_kv,
                                             lnpart_q, lnpart_kv, dxq, dxkv, gq, gkv, gln_q, gln_kv, ntok, D, st));
}

// The bf16 forward in one launch (window_block_fwd_bf16_kernel): the
// arguments of window_attention_train_forward with xq ... kv_b and out in
// bf16, no q / kv scratch, and the tables as per-group pointers: biases[g]
// (gh, N_g, N_g) and masks[g] (nW_g, N_g, N_g; read only where shifts[g] >
// 0), float32.
extern "C" int window_attention_train_forward_bf16(
    const bf16* xq, const bf16* xkv, const bf16* qs, const bf16* qb, const bf16* ks, const bf16* kb, const bf16* q_w,
    const bf16* q_b, const bf16* kv_w, const bf16* kv_b, const float* const* biases, const float* const* masks,
    bf16* out, int B, int H, int W, int D, int n_group, const int* ws, const int* shifts, int gh, float scale,
    uint32_t seed, uint32_t thresh, float inv_keep, int drop, void* stream) {
  if (!head_dim(D, n_group, gh)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_block_fwd_bf16(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, biases, masks, out, B,
                                                H, W, D, n_group, ws, shifts, gh, scale, seed, thresh, inv_keep, drop,
                                                static_cast<cudaStream_t>(stream)));
}

// The LN + projection of the bf16 forward alone, q (ntok, D) and kv (ntok,
// 2D) in bf16 (ln_proj_bf16_kernel, as the bf16 backward recomputes them):
// with window_attention_core_forward_bf16 on them, the two-launch
// composition that the one-launch forward equals bit for bit.
extern "C" int window_attention_train_ln_proj_bf16(const bf16* xq, const bf16* xkv, const bf16* qs, const bf16* qb,
                                                   const bf16* ks, const bf16* kb, const bf16* q_w, const bf16* q_b,
                                                   const bf16* kv_w, const bf16* kv_b, bf16* qbuf, bf16* kvbuf,
                                                   int ntok, int D, void* stream) {
  return static_cast<int>(launch_ln_proj(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, qbuf, kvbuf, ntok, D, 1,
                                         static_cast<cudaStream_t>(stream)));
}

// The floats of the bf16 backward's work buffer.
extern "C" size_t window_attention_train_backward_bf16_work(int B, int H, int W, int D, int n_group, const int* ws,
                                                            int gh) {
  return Bf16BwdWork(nullptr, B, H, W, D, n_group, ws, gh).floats;
}

// The kernels this library has launched since it was loaded
// (kernel_launches, window_common.cuh).
extern "C" unsigned long long window_attention_train_kernel_launches() { return kernel_launches; }

// The bf16 backward: the forward's inputs, dout (B, L, D) bf16 and `work`
// (window_attention_train_backward_bf16_work floats); outputs dxq, dxkv
// (B, L, D), gq = [dWq | dbq], gkv = [dWkv | dbkv], gln_q = [dqs | dqb],
// gln_kv = [dks | dkb] in bf16, dbias float32 laid out as bias.
extern "C" int window_attention_train_backward_bf16(
    const bf16* xq, const bf16* xkv, const bf16* qs, const bf16* qb, const bf16* ks, const bf16* kb, const bf16* q_w,
    const bf16* q_b, const bf16* kv_w, const bf16* kv_b, const float* bias, const float* mask, const bf16* dout,
    float* work, bf16* dxq, bf16* dxkv, bf16* gq, bf16* gkv, bf16* gln_q, bf16* gln_kv, float* dbias, int B, int H,
    int W, int D, int n_group, const int* ws, const int* shifts, int gh, float scale, uint32_t seed, uint32_t thresh,
    float inv_keep, int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntok = B * H * W;
  if (!head_dim(D, n_group, gh)) return static_cast<int>(cudaErrorInvalidValue);
  const Bf16BwdWork r(work, B, H, W, D, n_group, ws, gh);
  // q and kv recomputed as the forward rounds them; the attention backward
  // scales q as the forward does
  cudaError_t err = launch_ln_proj(xq, xkv, qs, qb, ks, kb, q_w, q_b, kv_w, kv_b, r.qh, r.kvh, ntok, D, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_attn_bwd_groups_any(static_cast<const bf16*>(r.qh), static_cast<const bf16*>(r.kvh),
                                   static_cast<const bf16*>(r.kvh + D), 2 * D, dout, bias, mask, r.dq, r.dkv,
                                   r.dkv + D, r.dbias_part, dbias, B, H, W, D, n_group, ws, shifts, gh, scale,
                                   seed, thresh, inv_keep, drop, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ln_proj_bwd(xq, xkv, qs, qb, ks, kb, q_w, kv_w, r.dq, r.dkv, r.wpart_q,
                                                  r.wpart_kv, r.lnpart_q, r.lnpart_kv, dxq, dxkv, gq, gkv, gln_q,
                                                  gln_kv, ntok, D, st));
}
