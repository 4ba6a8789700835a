// Per-pixel depth feature, shared by the forest kernels (the layered and
// single-forest kernels in forest_eval.cu) and the training split-bit kernel
// (train_features.cu), so train-time and eval-time features stay
// bit-identical.
//
// Numerics follow beats3d_tpu/ops/forest_eval.py exactly: every product,
// quotient and difference is rounded to float32 on its own (no contracted
// multiply-add, the IEEE quotient), because probe offsets
// floor((scale * u) / d) sit on integer boundaries.
//
// The quotient.  An IEEE division is a sequence of about ten instructions
// with a slow-path check, and a feature needs four, all by the same centre
// depth d.  quot takes the reciprocal y = RN(1/d) once per pixel and then,
// per offset, q = RN(a y), r = a - q d (one fused multiply-add, exact), and
// RN(q + r y) (one more): Markstein's theorem (Muller et al., Handbook of
// Floating-Point Arithmetic, the division by Newton-Raphson iteration
// chapter) says that with y correctly rounded and q within an ulp of a/d,
// this is RN(a/d), the IEEE quotient, as long as r stays a normal number;
// a feature with an offset below 2^-90 divides.
// tests/test_torch_train_features.py runs it, with every rounding emulated
// exactly, for every d in 1..65535.
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

// RN(a / d), given rd = RN(1 / d) and |a| >= 2^-90.
__device__ __forceinline__ float quot(float a, float d, float rd) {
  const float q = __fmul_rn(a, rd);
  return __fmaf_rn(__fmaf_rn(-q, d, a), rd, q);
}

// Depth read by the probe at offset (a_x, a_y) / d from (y, x): floor of
// each quotient, divided exactly where `tiny`.
__device__ __forceinline__ float probe_at(const int32_t* __restrict__ img,
                                          int h, int w, int y, int x,
                                          float ax, float ay, float d,
                                          float rd, bool tiny) {
  const float qy = tiny ? __fdiv_rn(ay, d) : quot(ay, d, rd);
  const float qx = tiny ? __fdiv_rn(ax, d) : quot(ax, d, rd);
  return probe_depth(img, h, w, y + static_cast<int>(floorf(qy)),
                     x + static_cast<int>(floorf(qx)));
}

// Whether a feature's offsets must be divided exactly (one below 2^-90).
__device__ __forceinline__ bool has_tiny(float ax, float ay, float bx,
                                         float by) {
  return fminf(fminf(fabsf(ax), fabsf(ay)), fminf(fabsf(bx), fabsf(by))) <
         0x1p-90f;
}

// Shotton depth-difference feature f = D(p + a/d) - D(p + b/d) at centre
// pixel (y, x) of centre depth d, probe offsets a = (ax, ay), b = (bx, by)
// already scaled; rd = RN(1 / d) (__frcp_rn, once per pixel); tiny =
// has_tiny(a, b); f = 0 when d == 0.
__device__ __forceinline__ float depth_feature(
    const int32_t* __restrict__ img, int h, int w, int y, int x, float d,
    float rd, float ax, float ay, float bx, float by, bool tiny) {
  if (d == 0.0f) return 0.0f;
  return __fsub_rn(probe_at(img, h, w, y, x, ax, ay, d, rd, tiny),
                   probe_at(img, h, w, y, x, bx, by, d, rd, tiny));
}

// The feature at probe scale `scale`: offsets scale * u and scale * v, each
// product rounded to float32.
__device__ __forceinline__ float depth_feature_uv(
    const int32_t* __restrict__ img, int h, int w, int y, int x, float d,
    float rd, float scale, float ux, float uy, float vx, float vy) {
  const float ax = __fmul_rn(scale, ux), ay = __fmul_rn(scale, uy);
  const float bx = __fmul_rn(scale, vx), by = __fmul_rn(scale, vy);
  return depth_feature(img, h, w, y, x, d, rd, ax, ay, bx, by,
                       has_tiny(ax, ay, bx, by));
}

}  // namespace b3d
