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
// Design: one thread per pixel, blocks of 32 x 8 pixels.  The proposal table
// (P x 5 floats) is staged once per block in shared memory; every thread
// reads the same proposal in the same step, so the reads broadcast.  A
// thread loops over the words and, within a word, over its 32 proposals,
// ORs the bits into one register and stores the word, so the stores of a
// warp are coalesced along x.
//
// What bounds it on the H100: the two dependent depth gathers per
// (pixel, proposal).  One proposal's offsets are the same for the whole
// image up to the 1/d scaling, so neighbouring threads probe neighbouring
// pixels and the gathers mostly hit L1/L2; the 4-image training block
// (6.5 MB of int32 depth) stays in L2.  Background pixels exit after one
// load of the active mask.

#include <cstdint>

#include <cuda_runtime.h>

#include "forest_walk.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxProposals = 2048;  // 40 KB of shared memory

}  // namespace

__global__ void __launch_bounds__(kBlockX * kBlockY)
train_feature_bits_kernel(const int32_t* __restrict__ depth,
                          const float* __restrict__ props, int num_props,
                          const uint8_t* __restrict__ active,
                          int32_t* __restrict__ out, int h, int w) {
  extern __shared__ float s_props[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 5 * num_props; i += blockDim.x * blockDim.y) {
    s_props[i] = props[i];
  }
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t pix = static_cast<size_t>(y) * w + x;
  const int num_words = (num_props + 31) / 32;
  int32_t* o = out + static_cast<size_t>(blockIdx.z) * num_words * plane + pix;
  const bool act =
      active == nullptr || active[static_cast<size_t>(blockIdx.z) * plane + pix] != 0;
  if (!act) {
    for (int wd = 0; wd < num_words; ++wd) o[wd * plane] = 0;
    return;
  }
  const int32_t* img = depth + static_cast<size_t>(blockIdx.z) * plane;
  const float d = static_cast<float>(__ldg(img + pix));
  for (int wd = 0; wd < num_words; ++wd) {
    const int in_word = min(32, num_props - 32 * wd);
    uint32_t word = 0;
    for (int k = 0; k < in_word; ++k) {
      const float* p = s_props + 5 * (32 * wd + k);
      const float f =
          b3d::depth_feature_uv(img, h, w, y, x, d, 1.0f, p[0], p[1], p[2], p[3]);
      if (f < p[4]) word |= 1u << k;
    }
    o[wd * plane] = static_cast<int32_t>(word);
  }
}

// depth: (n, h, w) int32; props: (num_props, 5) float32; active: (n, h, w)
// bool or null; out: (n, ceil(num_props / 32), h, w) int32; all device
// pointers.  Returns cudaGetLastError() after the launch.
extern "C" int b3d_train_feature_bits(const int32_t* depth, const float* props,
                                      int num_props, const uint8_t* active,
                                      int32_t* out, int n, int h, int w,
                                      void* stream) {
  if (num_props < 1 || num_props > kMaxProposals || n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, n);
  const size_t smem = 5 * sizeof(float) * static_cast<size_t>(num_props);
  train_feature_bits_kernel<<<grid, block, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      depth, props, num_props, active, out, h, w);
  return static_cast<int>(cudaGetLastError());
}
