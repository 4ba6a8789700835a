// Training split bits (B4): train_feature_bits_cuda.
//
// Replaces the two Pallas TPU kernels of
// beats3d_tpu/ops/train_features_pallas.py:train_feature_bits: the fast pass
// (its first pallas_call), which serves every probe from a static window of
// the depth tile and flags tiles whose probes left it, and the exact pass
// (the second pallas_call), which recomputes the flagged tiles.  Both exist
// because Mosaic has no per-lane gather.  Hopper gathers per thread, so
// there is no window to overflow and one kernel computes every bit exactly.
//
// Contract: for N depth images and P proposals (ux, uy, vx, vy, thresh),
// bit p % 32 of word p / 32 at pixel (n, y, x) of the (N, ceil(P/32), H, W)
// int32 output is f < thresh, f the depth feature of forest_walk.cuh at
// scale 1 (the trainer's floor(u / d) offsets; a probe out of bounds reads
// 65535; a centre depth of 0 gives f = 0).  Inactive pixels (active[pixel]
// == 0) skip their probes and get 0 words; their bits are don't-care in the
// trainer's histogram.
//
// What bounds it on the H100: latency and instructions, not bytes (the
// 4-image training block, 6.5 MB of int32 depth, stays in L2).  A feature
// is four probe quotients and two depth gathers; the trainer's mask (its
// pixels not yet at a leaf) holds ~170 k of a 4-image block's 1.6 M pixels
// on the flagship-width training frames.
//
// Design: lanes over proposals.  A warp owns a 32-pixel row segment and
// one 32-proposal word, lane k proposal 32 * word + k in registers; it
// ballots the segment's active pixels and walks only the set bits: for
// each, every lane computes its proposal's feature and __ballot_sync(f <
// thresh) is that pixel's word.  Lane j keeps the word of pixel j and
// stores it, one coalesced 128-byte store per segment and word; a segment
// with no active pixel stores zeros after one load of its mask.  So the
// work follows the active pixels: ~170 k active pixels become ~11 M lane
// tasks that fill the card, and at a 1 % mask a warp spends one step per
// active pixel instead of a thread's 64-step loop.  Each lane
// takes the reciprocal of its own pixel's depth once and hands it round
// with the depth, so a quotient is three instructions (forest_walk.cuh).

#include <cstdint>

#include <cuda_runtime.h>

#include "forest_walk.cuh"

namespace {

constexpr int kMaxProposals = 2048;
constexpr int kWarps = 8;

// Block: 8 warps, one image row each; blockIdx.y = word * ceil(h / 8) +
// row tile, blockIdx.x the 32-pixel segment, blockIdx.z the image.
__global__ void __launch_bounds__(32 * kWarps)
train_feature_bits_kernel(const int32_t* __restrict__ depth,
                          const float* __restrict__ props, int num_props,
                          const uint8_t* __restrict__ active,
                          int32_t* __restrict__ out, int h, int w) {
  const int lane = threadIdx.x & 31;
  const int rows = (h + kWarps - 1) / kWarps;
  const int wd = blockIdx.y / rows;
  const int y = (blockIdx.y % rows) * kWarps + (threadIdx.x >> 5);
  if (y >= h) return;                                 // the whole warp
  const int x0 = blockIdx.x * 32;
  const bool inside = x0 + lane < w;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t pix = static_cast<size_t>(y) * w + x0 + lane;
  const int num_words = (num_props + 31) / 32;
  const bool act = inside && (active == nullptr ||
                              active[blockIdx.z * plane + pix] != 0);
  uint32_t todo = __ballot_sync(0xffffffffu, act);
  uint32_t mine = 0;
  if (todo) {
    const int32_t* img = depth + blockIdx.z * plane;
    const int p = 32 * wd + lane;
    const bool valid = p < num_props;
    const float* pr = props + 5 * (valid ? p : 0);
    const float ux = __ldg(pr), uy = __ldg(pr + 1), vx = __ldg(pr + 2),
                vy = __ldg(pr + 3), th = __ldg(pr + 4);
    const bool tiny = b3d::has_tiny(ux, uy, vx, vy);
    const float d_own = act ? static_cast<float>(__ldg(img + pix)) : 0.0f;
    const float rd_own = __frcp_rn(d_own);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const float d = __shfl_sync(0xffffffffu, d_own, j);
      const float rd = __shfl_sync(0xffffffffu, rd_own, j);
      const float f = b3d::depth_feature(img, h, w, y, x0 + j, d, rd, ux, uy,
                                         vx, vy, tiny);
      const uint32_t bits = __ballot_sync(0xffffffffu, valid && f < th);
      if (lane == j) mine = bits;
    }
  }
  if (inside) {
    out[(static_cast<size_t>(blockIdx.z) * num_words + wd) * plane + pix] =
        static_cast<int32_t>(mine);
  }
}

}  // namespace

// depth: (n, h, w) int32; props: (num_props, 5) float32; active: (n, h, w)
// bool or null; out: (n, ceil(num_props / 32), h, w) int32; all device
// pointers.  Returns cudaGetLastError() after the launch.
extern "C" int b3d_train_feature_bits(const int32_t* depth, const float* props,
                                      int num_props, const uint8_t* active,
                                      int32_t* out, int n, int h, int w,
                                      void* stream) {
  const int words = (num_props + 31) / 32;
  const dim3 grid((w + 31) / 32, ((h + kWarps - 1) / kWarps) * words, n);
  if (num_props < 1 || num_props > kMaxProposals || n > 65535 ||
      grid.y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  train_feature_bits_kernel<<<grid, 32 * kWarps, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      depth, props, num_props, active, out, h, w);
  return static_cast<int>(cudaGetLastError());
}
