// Per-pixel depth feature, shared by the forest kernels (the layered and
// single-forest kernels in forest_eval.cu) and the training split-bit kernel
// (train_features.cu), so train-time and eval-time features stay
// bit-identical; and the single-forest kernel's tree walk over the dense
// reference forest layout.
//
// Forest layout: float32 (T, 2^D - 1, 7 + 2C), node g of level j at row
// (1 << j) - 1 + g, fields (ux, uy, vx, vy, thresh, l_next, r_next,
// l_pdf[C], r_pdf[C]).  A child flag whose floor is -1 descends to child
// 2g + side of the next level; any other flag ends the walk with that side's
// pdf.
//
// Numerics follow beats3d_tpu/ops/forest_eval.py exactly: every product,
// quotient and difference is rounded to float32 on its own (__fmul_rn,
// __fdiv_rn, __fsub_rn: no FMA contraction, IEEE division), because probe
// offsets floor((scale * u) / d) sit on integer boundaries.
#pragma once

#include <cstdint>

namespace b3d {

constexpr int kMissing = 65535;

// Depth at (y, x) of an (h, w) image; a probe out of bounds reads 65535.
__device__ __forceinline__ float probe_depth(const int32_t* __restrict__ img,
                                             int h, int w, int y, int x) {
  return (y >= 0 && y < h && x >= 0 && x < w)
             ? static_cast<float>(__ldg(img + static_cast<size_t>(y) * w + x))
             : static_cast<float>(kMissing);
}

// floor((scale * u) / d), each step rounded to float32.
__device__ __forceinline__ int probe_offset(float scale, float u, float d) {
  return static_cast<int>(floorf(__fdiv_rn(__fmul_rn(scale, u), d)));
}

// Shotton depth-difference feature f = D(p + u/d) - D(p + v/d) at centre
// pixel (y, x) of centre depth d, probe offsets u = (ux, uy), v = (vx, vy);
// f = 0 when d == 0.
__device__ __forceinline__ float depth_feature_uv(
    const int32_t* __restrict__ img, int h, int w, int y, int x, float d,
    float scale, float ux, float uy, float vx, float vy) {
  if (d == 0.0f) return 0.0f;
  const float du = probe_depth(img, h, w, y + probe_offset(scale, uy, d),
                               x + probe_offset(scale, ux, d));
  const float dv = probe_depth(img, h, w, y + probe_offset(scale, vy, d),
                               x + probe_offset(scale, vx, d));
  return __fsub_rn(du, dv);
}

// The same feature with the offsets read from a forest node row.
__device__ __forceinline__ float depth_feature(
    const int32_t* __restrict__ img, int h, int w, int y, int x, float d,
    float scale, const float* __restrict__ node) {
  if (d == 0.0f) return 0.0f;
  return depth_feature_uv(img, h, w, y, x, d, scale, __ldg(node + 0),
                          __ldg(node + 1), __ldg(node + 2), __ldg(node + 3));
}

// Walks one tree from its root for the pixel (y, x) of centre depth d.
// Returns the C-class pdf of the leaf side reached and sets *stop_level to
// the level of that node; returns nullptr, with *stop_level = levels, when
// the walk still descends after the last level (such a tree adds nothing).
__device__ __forceinline__ const float* walk_tree_level(
    const float* __restrict__ tree, int levels, int num_classes,
    const int32_t* __restrict__ img, int h, int w, int y, int x, float d,
    float scale, int* stop_level) {
  const int node_els = 7 + 2 * num_classes;
  int g = 0;
  for (int j = 0; j < levels; ++j) {
    const float* node = tree + static_cast<size_t>((1 << j) - 1 + g) * node_els;
    const float f = depth_feature(img, h, w, y, x, d, scale, node);
    const int side = (f < __ldg(node + 4)) ? 0 : 1;
    if (floorf(__ldg(node + 5 + side)) == -1.0f) {
      g = 2 * g + side;
      continue;
    }
    *stop_level = j;
    return node + 7 + side * num_classes;
  }
  *stop_level = levels;
  return nullptr;
}

}  // namespace b3d
