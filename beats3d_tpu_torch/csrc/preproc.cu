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
// What bounds it on the H100.  Per output it must move 8 bytes (read 4,
// write 4): 52 MB for 16 frames, 15.5 us at 3.35 TB/s.  The arithmetic is
// about 114 float32 operations per output (the deprojection's two IEEE
// divisions, 4 per tap), which the card issues in about two thirds of that
// time, so instruction issue, not the bytes, is what a plain one-thread-
// per-output kernel runs into: 25 shared-memory loads, 25 data-dependent
// branches and up to 75 rounded operations per output, on a 32x8 tile whose
// halo stages 1.69 pixels per output.  On the bench frames a fifth of the
// pixels survive the band, scattered over the table as well as on the
// hands: more than half of the 64x16 tiles hold both kinds, a quarter of
// the 4x2 output blocks.
//
// Design.
// * A block of 128 threads stages a 64x16 output tile plus its 2-pixel halo
//   (68x20, 1.33 staged pixels per output) of band-filtered depth in shared
//   memory: one deprojection and plane test per staged pixel.  Rows are
//   read as 16-byte loads where W is a multiple of 4, all of a thread's
//   loads issued before the first is used.
// * Each thread computes a 4x2 block of outputs from registers.  It walks
//   the 6 staged rows its block needs once, two 16-byte shared loads per
//   row (cols x-2 .. x+5), and adds each row's taps to the outputs that use
//   it: 1.5 shared loads per output instead of 25.
// * Taps accumulate without branches: sn += w * max(v, 0), and
//   wn = fma(w, kept, wn), w0 = fma(w, zero, w0) with kept and zero 0.0 or
//   1.0, whose products are exact, so each equals the separately rounded
//   add (and a tap that does not count adds +0.0, exact for these
//   non-negative sums).
// * A 4x2 output block whose 8x6 staged pixels hold no kept one (the table:
//   missing or cut by the band) is 0 and is written at once.  The others are
//   compacted into a list that the block's first threads compute, so that
//   the table's scattered kept pixels idle whole warps, not lanes in every
//   warp.  A block whose staged pixels are all kept (inside a hand) needs
//   only sn, since wn is then the host's row-major sum of all 25 weights
//   and w0 = 0.
// * Outputs are written as 16-byte stores where W is a multiple of 4.
// The batch (B, H, W) is the grid's z dimension, one launch per batch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 64;
constexpr int kTileY = 16;
constexpr int kHalo = 2;
constexpr int kTaps = 2 * kHalo + 1;
constexpr int kBx = 4;                        // outputs per thread along x
constexpr int kBy = 2;                        // and along y
constexpr int kThreads = (kTileX / kBx) * (kTileY / kBy);
constexpr int kSw = kTileX + 2 * kHalo;       // staged columns: x0-2 .. x0+65
constexpr int kSh = kTileY + 2 * kHalo;       // staged rows
constexpr int kChunks = kTileX / 4 + 2;       // 16-byte row chunks x0-4 .. x0+67

struct GaussTaps {
  float k[kTaps * kTaps];  // row-major normalised weights
  float wn_all;            // their row-major float32 sum (all taps kept)
};

struct BandParams {
  float m20, m21, m22, m23, pp0, pp1, focal, thr;
};

// Band-filtered depth of pixel (y, x): > 0 kept, 0 missing or cut.
__device__ __forceinline__ float band(int32_t raw, int x, int y,
                                      const BandParams& p) {
  const float d = static_cast<float>(raw);
  const float px =
      __fdiv_rn(__fmul_rn(d, __fsub_rn(static_cast<float>(x), p.pp0)), p.focal);
  const float py =
      __fdiv_rn(__fmul_rn(d, __fsub_rn(static_cast<float>(y), p.pp1)), p.focal);
  const float z = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(p.m20, px), __fmul_rn(p.m21, py)),
                __fmul_rn(p.m22, d)),
      p.m23);
  return (d > 0.0f && !(z > -p.thr)) ? d : 0.0f;
}

// The taps of this thread's 4x2 outputs.  base: staged row 2ty, column
// 4tx.  Staged row i feeds output row q with tap row dy = i - q; the rows
// come in increasing i, so every output sums its taps in row-major order.
// kFull = false accumulates sn only (every staged pixel kept).
template <bool kFull>
__device__ __forceinline__ void accumulate(const float* base,
                                           const GaussTaps& taps,
                                           float (&sn)[kBy][kBx],
                                           float (&wn)[kBy][kBx],
                                           float (&w0)[kBy][kBx]) {
#pragma unroll
  for (int q = 0; q < kBy; ++q) {
#pragma unroll
    for (int j = 0; j < kBx; ++j) {
      sn[q][j] = 0.0f;
      wn[q][j] = 0.0f;
      w0[q][j] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < kBy + 2 * kHalo; ++i) {
    const float4 a = *reinterpret_cast<const float4*>(base + i * kSw);
    const float4 b = *reinterpret_cast<const float4*>(base + i * kSw + 4);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float val[8], kept[8], zero[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      val[c] = fmaxf(v[c], 0.0f);
      kept[c] = v[c] > 0.0f ? 1.0f : 0.0f;
      zero[c] = v[c] == 0.0f ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBy; ++q) {
      const int dy = i - q;
      if (dy < 0 || dy >= kTaps) continue;
#pragma unroll
      for (int j = 0; j < kBx; ++j) {
#pragma unroll
        for (int dx = 0; dx < kTaps; ++dx) {
          const float kv = taps.k[dy * kTaps + dx];
          sn[q][j] = __fadd_rn(sn[q][j], __fmul_rn(kv, val[j + dx]));
          if (kFull) {
            wn[q][j] = __fmaf_rn(kv, kept[j + dx], wn[q][j]);
            w0[q][j] = __fmaf_rn(kv, zero[j + dx], w0[q][j]);
          }
        }
      }
    }
  }
}

constexpr int kAllKept = 1 << 16;             // list flag: sn is all it takes

// Writes a row of 4 outputs at (y, ox): one 16-byte store (kVec), or per
// pixel inside the image.
template <bool kVec>
__device__ __forceinline__ void store_row(int32_t* o, int w, int ox, int y,
                                          int4 v) {
  int32_t* row = o + static_cast<size_t>(y) * w + ox;
  if (kVec) {
    *reinterpret_cast<int4*>(row) = v;
  } else {
    const int r[kBx] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < kBx; ++j) {
      if (ox + j < w) row[j] = r[j];
    }
  }
}

// kVec: W % 4 == 0 and 16-byte aligned rows (16-byte loads and stores).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
plane_band_gauss_kernel(const int32_t* __restrict__ depth,
                        int32_t* __restrict__ out, int h, int w,
                        const float* __restrict__ plane, BandParams p,
                        const __grid_constant__ GaussTaps taps) {
  // band-filtered depth: > 0 kept, 0 missing or cut, -1 outside the image
  // (a skipped tap); staged column c is image column x0 - 2 + c
  __shared__ __align__(16) float tile[kSh][kSw];
  __shared__ int s_list[kThreads];            // output blocks to compute
  __shared__ int s_count;
  const size_t img_off = static_cast<size_t>(blockIdx.z) * h * w;
  const int32_t* img = depth + img_off;
  p.m20 = __ldg(plane + 8);
  p.m21 = __ldg(plane + 9);
  p.m22 = __ldg(plane + 10);
  p.m23 = __ldg(plane + 11);
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int tid = threadIdx.x;
  if (tid == 0) s_count = 0;

  if (kVec) {
    // the 16-byte chunks x0-4 .. x0+67 of the staged rows; a chunk is inside
    // the image or wholly outside it (x0 and w are multiples of 4).  Every
    // load is issued before the first is used.
    constexpr int kLoads = (kSh * kChunks + kThreads - 1) / kThreads;
    int4 q[kLoads];
    bool inside[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      const int sy = i / kChunks;
      const int y = y0 - kHalo + sy;
      const int xc = x0 - 4 + 4 * (i - sy * kChunks);
      inside[u] = i < kSh * kChunks && y >= 0 && y < h && xc >= 0 && xc < w;
      q[u] = make_int4(0, 0, 0, 0);
      if (inside[u]) {
        q[u] = __ldg(reinterpret_cast<const int4*>(
            img + static_cast<size_t>(y) * w + xc));
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      if (i >= kSh * kChunks) break;
      const int sy = i / kChunks;
      const int k = i - sy * kChunks;
      const int y = y0 - kHalo + sy;
      const int xc = x0 - 4 + 4 * k;
      const int raw[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * k - 2 + j;
        if (c >= 0 && c < kSw) {
          tile[sy][c] = inside[u] ? band(raw[j], xc + j, y, p) : -1.0f;
        }
      }
    }
  } else {
    for (int i = tid; i < kSh * kSw; i += kThreads) {
      const int sy = i / kSw;
      const int c = i - sy * kSw;
      const int y = y0 - kHalo + sy;
      const int x = x0 - kHalo + c;
      float v = -1.0f;
      if (y >= 0 && y < h && x >= 0 && x < w) {
        v = band(__ldg(img + static_cast<size_t>(y) * w + x), x, y, p);
      }
      tile[sy][c] = v;
    }
  }
  __syncthreads();

  // Each thread classifies its own 4x2 outputs by the 8x6 staged pixels
  // they read: with no kept pixel they are 0 (the centre is in the image,
  // so w0 > 0 = wn) and are written at once; the others are listed, and
  // the first threads of the block compute the listed blocks, so that
  // whole warps, not scattered lanes, fall idle on the table.
  int32_t* o = out + img_off;
  {
    const int tx = tid % (kTileX / kBx);
    const int ty = tid / (kTileX / kBx);
    const int ox = x0 + kBx * tx;
    const int oy = y0 + kBy * ty;
    if (ox < w && oy < h) {
      const float* base = &tile[kBy * ty][kBx * tx];
      float vmin = base[0];
      float vmax = base[0];
#pragma unroll
      for (int i = 0; i < kBy + 2 * kHalo; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(base + i * kSw);
        const float4 b = *reinterpret_cast<const float4*>(base + i * kSw + 4);
        vmin = fminf(vmin, fminf(fminf(fminf(a.x, a.y), fminf(a.z, a.w)),
                                 fminf(fminf(b.x, b.y), fminf(b.z, b.w))));
        vmax = fmaxf(vmax, fmaxf(fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)),
                                 fmaxf(fmaxf(b.x, b.y), fmaxf(b.z, b.w))));
      }
      if (vmax <= 0.0f) {
#pragma unroll
        for (int r = 0; r < kBy; ++r) {
          if (oy + r < h) store_row<kVec>(o, w, ox, oy + r, make_int4(0, 0, 0, 0));
        }
      } else {
        s_list[atomicAdd(&s_count, 1)] = tid | (vmin > 0.0f ? kAllKept : 0);
      }
    }
  }
  __syncthreads();
  if (tid >= s_count) return;
  const int item = s_list[tid];
  const int sub = item & (kThreads - 1);
  const int tx = sub % (kTileX / kBx);
  const int ty = sub / (kTileX / kBx);
  const int ox = x0 + kBx * tx;
  const int oy = y0 + kBy * ty;
  const float* base = &tile[kBy * ty][kBx * tx];
  float sn[kBy][kBx], wn[kBy][kBx], w0[kBy][kBx];
  if (item & kAllKept) {
    accumulate<false>(base, taps, sn, wn, w0);
#pragma unroll
    for (int r = 0; r < kBy; ++r) {
#pragma unroll
      for (int j = 0; j < kBx; ++j) wn[r][j] = taps.wn_all;
    }
  } else {
    accumulate<true>(base, taps, sn, wn, w0);
  }
#pragma unroll
  for (int r = 0; r < kBy; ++r) {
    if (oy + r >= h) break;
    int res[kBx];
#pragma unroll
    for (int j = 0; j < kBx; ++j) {
      const float mean =
          floorf(__fdiv_rn(sn[r][j], wn[r][j] == 0.0f ? 1.0f : wn[r][j]));
      res[j] = (w0[r][j] > wn[r][j]) ? 0 : static_cast<int32_t>(mean);
    }
    store_row<kVec>(o, w, ox, oy + r, make_int4(res[0], res[1], res[2], res[3]));
  }
}

template <bool kVec>
int launch(const int32_t* depth, int32_t* out, int b, int h, int w,
           const float* plane, const BandParams& p, const GaussTaps& t,
           cudaStream_t stream) {
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, b);
  plane_band_gauss_kernel<kVec><<<grid, kThreads, 0, stream>>>(
      depth, out, h, w, plane, p, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// depth, out: (b, h, w) int32 device; plane: (4, 4) float32 device,
// row-major; taps: host array of 25 float32 weights followed by their
// row-major float32 sum.  Returns cudaGetLastError() after the launch.
extern "C" int b3d_plane_band_gauss(const int32_t* depth, int32_t* out, int b,
                                    int h, int w, const float* plane,
                                    float pp0, float pp1, float focal,
                                    float thr, const float* taps,
                                    void* stream) {
  if (b > 65535 || h > 65535 * kTileY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  GaussTaps t;
  for (int i = 0; i < kTaps * kTaps; ++i) t.k[i] = taps[i];
  t.wn_all = taps[kTaps * kTaps];
  const BandParams p{0.0f, 0.0f, 0.0f, 0.0f, pp0, pp1, focal, thr};
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(depth) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(depth, out, b, h, w, plane, p, t, s)
             : launch<false>(depth, out, b, h, w, plane, p, t, s);
}
