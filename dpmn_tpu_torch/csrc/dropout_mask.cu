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
// One thread per element, one launch per group.  What bounds it on an H100:
// the output alone, B x heads x sum_g nW_g N_g^2 floats (44 MB at B = 64 and
// the flagship geometry: 16x64 grid, windows 2/4/8, 2 heads) = 13 us at
// 3.35 TB/s; the six-step integer hash chain per element is not counted (the
// published peaks give no int32 CUDA-core rate).  Its time stands in PERF.md.

#include "window_common.cuh"

namespace {

// 32-bit index arithmetic: the entry point refuses a group of 2^31 entries or more.
__global__ void dropout_mask_kernel(float* __restrict__ out, int gh, int nw, int N, int g, uint32_t seed,
                                    uint32_t thresh, float inv_keep, int total) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = idx % N, i = (idx / N) % N, rest = idx / (N * N);
  const int widx = rest % nw, hd = (rest / nw) % gh, b = rest / (nw * gh);
  const uint32_t key = dropout_row_key(seed, b, g, hd, widx, i);
  out[idx] = (hash_step(key, j) & 0x7fffffffu) < thresh ? inv_keep : 0.f;
}

}  // namespace

// out: the per-group masks (B, gh, nW_g, N_g, N_g), concatenated, float32.
// ws: a host array of n_group window sizes, each dividing H and W.  Returns
// cudaGetLastError() after the last launch (or the first failing one).
extern "C" int dropout_mask_forward(float* out, int B, int H, int W, int n_group, const int* ws, int gh,
                                    uint32_t seed, uint32_t thresh, float inv_keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t off = 0;
  for (int g = 0; g < n_group; ++g) {
    if (ws[g] < 1 || H % ws[g] || W % ws[g]) return static_cast<int>(cudaErrorInvalidValue);
    const int n = ws[g] * ws[g], nw = (H / ws[g]) * (W / ws[g]);
    const int64_t total = (int64_t)B * gh * nw * n * n;
    if (total >= ((int64_t)1 << 31)) return static_cast<int>(cudaErrorInvalidValue);
    dropout_mask_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(out + off, gh, nw, n, g, seed, thresh,
                                                                          inv_keep, (int)total);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    off += (size_t)total;
  }
  return static_cast<int>(cudaSuccess);
}
