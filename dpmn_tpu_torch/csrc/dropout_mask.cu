// The attention-dropout masks of the training cores, dumped, for sm_90a.
//
// Replaces the TPU kernel of tools/debug_train_dropout.py::dump_masks
// (pallas_call at :39), which reseeds the TPU's PRNG per image and group and
// draws, per head, the keep mask of dpmn_tpu/ops/pallas_window_train.py::
// _dropout_mask as one (HW/128, 128, 128) packed tile stack.  The port's
// training cores (K3, K4, K5) draw their mask in-kernel from the counter
// hash of window_common.cuh instead, per window and never packed; this
// kernel writes exactly those draws: for group g (window ws, N = ws*ws) and
// every image b, head hd, window w, query i and key j,
//     out_g[b, hd, w, i, j] = 1/keep  if (hash(seed, b, g, hd, w, i, j) & 0x7fffffff) < thresh
//                             0       otherwise,
// with the hash chain dropout_row_key / hash_step and the threshold rule the
// cores use, so a mask dumped here is the mask a core applied for that seed.
//
// What bounds it on an H100: the output alone, B x heads x sum_g nW_g N_g^2
// floats (44 MB at B = 64 and the flagship geometry: 16x64 grid, windows
// 2/4/8, 2 heads) = 13 us at 3.35 TB/s.  The hash is integer work the
// published peaks give no rate for, so the design keeps it near one fmix32
// an element: one launch for every group; a warp takes a task of 16 KB of
// output (the windows of one (b, hd) plane that make 4096 floats), computes
// the chain's prefix through the head once a task, through the window once
// a window and through the query once a row, then one hash_step an element;
// rows are decoded from the lane and a counter, never by a runtime division
// an element, and written as coalesced float4s (N = 4: a lane a row; N =
// 16: four lanes a row; N = 64: sixteen lanes a row, a warp two rows a
// store).  Other window sizes take a lane an element.  Its times stand in
// PERF.md.

#include "window_common.cuh"

namespace {

constexpr int MASK_GROUPS = 8;      // groups one launch takes
constexpr int TASK_FLOATS = 4096;   // a warp's task: the windows of a plane that make 16 KB (one at N = 64)
constexpr int MASK_THREADS = 256;

struct MaskGroup {
  float* out;                    // (B, gh, nW, N, N)
  int ws, nw, wpt, chunks, task0;  // window, windows; windows a task, tasks a plane, first task
};

struct MaskArgs {
  uint32_t seed, thresh;
  float inv_keep;
  int gh, n_group, n_tasks;
  MaskGroup grp[MASK_GROUPS];
};

__device__ __forceinline__ float keep_value(uint32_t row_key, int j, uint32_t thresh, float inv_keep) {
  return (hash_step(row_key, j) & 0x7fffffffu) < thresh ? inv_keep : 0.f;
}

__device__ __forceinline__ float4 keep4(uint32_t row_key, int j, uint32_t thresh, float inv_keep) {
  return make_float4(keep_value(row_key, j, thresh, inv_keep), keep_value(row_key, j + 1, thresh, inv_keep),
                     keep_value(row_key, j + 2, thresh, inv_keep), keep_value(row_key, j + 3, thresh, inv_keep));
}

// Windows [w0, w0 + cnt) of one (b, hd) plane (plane: its (nW, N, N) floats;
// pkey: the chain through the head), by one warp.
template <int N>
__device__ __forceinline__ void mask_windows(float* __restrict__ plane, uint32_t pkey, int w0, int cnt,
                                             uint32_t thresh, float inv_keep) {
  const int lane = threadIdx.x & 31;
  float4* out = reinterpret_cast<float4*>(plane);
  if constexpr (N == 4) {  // a lane a row (one float4), 8 windows a store
    for (int r = lane; r < 4 * cnt; r += 32) {
      const int w = w0 + (r >> 2), i = r & 3;
      out[(int64_t)w * 4 + i] = keep4(hash_step(hash_step(pkey, w), i), 0, thresh, inv_keep);
    }
  } else {  // N / 4 lanes a row (a float4 each), 128 / N rows a store
    constexpr int LANES = N / 4, ROWS = 32 / LANES;
    const int c = lane % LANES, r0 = lane / LANES;
    for (int w = w0; w < w0 + cnt; ++w) {
      const uint32_t wkey = hash_step(pkey, w);
#pragma unroll 4
      for (int i = r0; i < N; i += ROWS)
        out[((int64_t)w * N + i) * LANES + c] = keep4(hash_step(wkey, i), 4 * c, thresh, inv_keep);
    }
  }
}

// The same for a window of any size: a lane an element.
__device__ __forceinline__ void mask_windows_any(float* __restrict__ plane, uint32_t pkey, int w0, int cnt, int n,
                                                 uint32_t thresh, float inv_keep) {
  const int lane = threadIdx.x & 31, nn = n * n;
  for (int w = w0; w < w0 + cnt; ++w) {
    const uint32_t wkey = hash_step(pkey, w);
    for (int e = lane; e < nn; e += 32) {
      const int i = e / n, j = e - i * n;
      plane[(int64_t)w * nn + e] = keep_value(hash_step(wkey, i), j, thresh, inv_keep);
    }
  }
}

// A warp a task: task t of group g is (plane t / chunks, window chunk t %
// chunks), a plane being (b, hd) = (plane / gh, plane % gh).
__global__ void __launch_bounds__(MASK_THREADS) dropout_mask_kernel(const __grid_constant__ MaskArgs a) {
  const int task = blockIdx.x * (MASK_THREADS / 32) + (threadIdx.x >> 5);
  if (task >= a.n_tasks) return;
  int g = 0;
  while (g + 1 < a.n_group && task >= a.grp[g + 1].task0) ++g;
  const MaskGroup& gr = a.grp[g];
  const int t = task - gr.task0, plane = t / gr.chunks, chunk = t - plane * gr.chunks;
  const int b = plane / a.gh, hd = plane - b * a.gh;
  const int w0 = chunk * gr.wpt, cnt = min(gr.wpt, gr.nw - w0), n = gr.ws * gr.ws;
  const uint32_t pkey = hash_step(hash_step(hash_step(a.seed, b), g), hd);
  float* out = gr.out + (int64_t)plane * gr.nw * n * n;
  switch (gr.ws) {
    case 2: mask_windows<4>(out, pkey, w0, cnt, a.thresh, a.inv_keep); break;
    case 4: mask_windows<16>(out, pkey, w0, cnt, a.thresh, a.inv_keep); break;
    case 8: mask_windows<64>(out, pkey, w0, cnt, a.thresh, a.inv_keep); break;
    default: mask_windows_any(out, pkey, w0, cnt, n, a.thresh, a.inv_keep);
  }
}

}  // namespace

// outs: a host array of n_group device pointers, group g's float32 mask
// (B, gh, nW_g, N_g, N_g), 16-byte aligned.  ws: a host array of n_group
// window sizes, each dividing H and W; at most MASK_GROUPS groups.  One
// launch.  Returns cudaGetLastError() after it.
extern "C" int dropout_mask_forward(float* const* outs, int B, int H, int W, int n_group, const int* ws, int gh,
                                    uint32_t seed, uint32_t thresh, float inv_keep, void* stream) {
  if (n_group < 1 || n_group > MASK_GROUPS || B < 0 || gh < 1) return static_cast<int>(cudaErrorInvalidValue);
  MaskArgs a;
  a.seed = seed, a.thresh = thresh, a.inv_keep = inv_keep, a.gh = gh, a.n_group = n_group;
  int64_t tasks = 0;
  for (int g = 0; g < n_group; ++g) {
    if (ws[g] < 1 || H % ws[g] || W % ws[g] || !aligned16(outs[g])) return static_cast<int>(cudaErrorInvalidValue);
    const int n = ws[g] * ws[g], nw = (H / ws[g]) * (W / ws[g]);
    const int wpt = n * n >= TASK_FLOATS ? 1 : TASK_FLOATS / (n * n);
    const int chunks = (nw + wpt - 1) / wpt;
    a.grp[g] = MaskGroup{outs[g], ws[g], nw, wpt, chunks, (int)tasks};
    tasks += (int64_t)B * gh * chunks;
    if (tasks >= ((int64_t)1 << 31) - MASK_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  }
  a.n_tasks = (int)tasks;
  if (tasks == 0) return static_cast<int>(cudaSuccess);
  constexpr int per_block = MASK_THREADS / 32;
  dropout_mask_kernel<<<(unsigned)((tasks + per_block - 1) / per_block), MASK_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
