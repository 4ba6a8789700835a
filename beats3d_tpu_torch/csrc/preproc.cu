// Fused plane-band filter + missing-aware 5x5 gaussian: plane_band_gauss_cuda.
//
// Replaces the Pallas TPU kernel
// beats3d_tpu/ops/preproc_pallas.py:plane_band_gauss (_run, body
// _make_kernel).  Semantics are those of the plain chain
// points.plane_band_depth -> points.gaussian_depth_filter:
//
//   px = (d * (x - pp0)) / f, py = (d * (y - pp1)) / f,
//   z  = ((m20 * px + m21 * py) + m22 * d) + m23   (row 2 of the plane matrix)
//   kept depth = (d > 0 && !(z > -thr)) ? d : 0
//
// then, over the 25 taps in row-major order with the normalised weights of
// gaussian_kernel(5, 2.0): taps outside the image are skipped, kept taps add
// their weight to wn and weight * depth to sn, zero taps add their weight to
// w0; the output is (w0 > wn) ? 0 : floor(sn / wn).  Every operation is
// rounded to float32 on its own (no FMA, IEEE division) and the taps are
// summed in the plain version's order, so kernel and plain version agree
// bit for bit; the band test sits on a threshold, where a contracted
// multiply-add would move pixels.
//
// What bounds it on the H100: memory bandwidth.  Per pixel it reads 4 bytes
// and writes 4 and does ~100 flops, far below the card's flop-per-byte
// balance.  The design reads each input pixel from device memory once: a
// block stages a 32x8 tile plus a 2-pixel halo of band-filtered depth in
// shared memory (the deprojection and plane test run once per staged
// pixel), and each thread computes one output pixel from shared memory.
// Consecutive threads touch consecutive addresses on both load and store.
// The batch (B, H, W) is the grid's z dimension, one launch per batch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kHalo = 2;
constexpr int kTaps = 2 * kHalo + 1;

struct GaussTaps {
  float k[kTaps * kTaps];  // row-major normalised weights
};

__global__ void __launch_bounds__(kTileX * kTileY)
plane_band_gauss_kernel(const int32_t* __restrict__ depth,
                        int32_t* __restrict__ out, int h, int w,
                        const float* __restrict__ plane, float pp0, float pp1,
                        float focal, float thr, GaussTaps taps) {
  // band-filtered depth: > 0 kept, 0 missing or cut by the band,
  // -1 outside the image (a skipped tap)
  __shared__ float tile[kTileY + 2 * kHalo][kTileX + 2 * kHalo];
  const int32_t* img = depth + static_cast<size_t>(blockIdx.z) * h * w;
  const float m20 = __ldg(plane + 8);
  const float m21 = __ldg(plane + 9);
  const float m22 = __ldg(plane + 10);
  const float m23 = __ldg(plane + 11);
  const int x0 = blockIdx.x * kTileX - kHalo;
  const int y0 = blockIdx.y * kTileY - kHalo;
  constexpr int kTw = kTileX + 2 * kHalo;
  constexpr int kTn = (kTileY + 2 * kHalo) * kTw;
  for (int i = threadIdx.y * kTileX + threadIdx.x; i < kTn;
       i += kTileX * kTileY) {
    const int ty = i / kTw;
    const int tx = i - ty * kTw;
    const int y = y0 + ty;
    const int x = x0 + tx;
    float v = -1.0f;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const float d = static_cast<float>(__ldg(img + static_cast<size_t>(y) * w + x));
      const float px = __fdiv_rn(__fmul_rn(d, __fsub_rn(static_cast<float>(x), pp0)), focal);
      const float py = __fdiv_rn(__fmul_rn(d, __fsub_rn(static_cast<float>(y), pp1)), focal);
      const float z = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(m20, px), __fmul_rn(m21, py)),
                    __fmul_rn(m22, d)),
          m23);
      v = (d > 0.0f && !(z > -thr)) ? d : 0.0f;
    }
    tile[ty][tx] = v;
  }
  __syncthreads();

  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= w || y >= h) return;
  float sn = 0.0f;
  float wn = 0.0f;
  float w0 = 0.0f;
#pragma unroll
  for (int dy = 0; dy < kTaps; ++dy) {
#pragma unroll
    for (int dx = 0; dx < kTaps; ++dx) {
      const float v = tile[threadIdx.y + dy][threadIdx.x + dx];
      const float kv = taps.k[dy * kTaps + dx];
      if (v > 0.0f) {
        sn = __fadd_rn(sn, __fmul_rn(kv, v));
        wn = __fadd_rn(wn, kv);
      } else if (v == 0.0f) {
        w0 = __fadd_rn(w0, kv);
      }
    }
  }
  const float mean = floorf(__fdiv_rn(sn, wn == 0.0f ? 1.0f : wn));
  out[static_cast<size_t>(blockIdx.z) * h * w + static_cast<size_t>(y) * w + x] =
      (w0 > wn) ? 0 : static_cast<int32_t>(mean);
}

}  // namespace

// depth, out: (b, h, w) int32 device; plane: (4, 4) float32 device,
// row-major; taps: host array of 25 float32 weights.  Returns
// cudaGetLastError() after the launch.
extern "C" int b3d_plane_band_gauss(const int32_t* depth, int32_t* out, int b,
                                    int h, int w, const float* plane,
                                    float pp0, float pp1, float focal,
                                    float thr, const float* taps,
                                    void* stream) {
  if (b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  GaussTaps t;
  for (int i = 0; i < kTaps * kTaps; ++i) t.k[i] = taps[i];
  const dim3 block(kTileX, kTileY);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, b);
  plane_band_gauss_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      depth, out, h, w, plane, pp0, pp1, focal, thr, t);
  return static_cast<int>(cudaGetLastError());
}
