// K1's input and output moved in place of the ATen chain around it: the
// hand images that the layered forest (K1) reads, and the screen-frame
// labels made of its output.  hand_images and place_labels
// (ops/hand_images_cuda.py).
//
// Not a port of a pallas_call: JAX builds both sides with XLA operations
// (beats3d_tpu/runtime/pipeline.py: _stencil_crops, _full_stencils, the
// guard's _spread_tiles and _incoherent_images, scatter_mm and the
// unmirroring), and the port's plain versions are the same composition in
// ATen.  Semantics are the plain versions' (hand_images_plain,
// place_labels_plain), bit for bit:
//
//   image 2i + k (k = 0 the right hand, 1 the left) of pair i reads frame
//   f = frames ? frames[i] : i.  Its column j maps to the unmirrored column
//   jj = k ? cw - 1 - j : j of a window at (oy, ox) (the left hand's origin
//   given in mirrored space, ox = w - cw - oxs), or of the whole frame:
//     pixel  = depth[f, oy + row, ox + jj] (0 outside the frame)
//              where grown[f, oy // 2^L + (row >> L), ox // 2^L + (jj >> L)]
//              == k + 1, else 0;  0 becomes 65535;
//     a pair whose zero flag says so is 0 throughout;
//   under the guard, a label tile (8 x 128 samples of the labels_reduce r
//   grid, zero-padded) is occupied if it holds a depth in (0, 65535) and
//   over-spread if that depth's range exceeds `spread`; an image with
//   float(spread tiles) / float(max(occupied, 1)) > frac (float32, IEEE
//   division) is muted: 0 throughout.
//   labels: out[i, k, Y, X] = lab[2i + k, Y - oy / r, Xm - ox / r] (floor
//   divisions; Xm = k ? wl - 1 - X : X), 65535 outside the crop; the whole
//   frame (no origins) only unmirrors.
//
// What bounds it on the H100.  Bytes: each hand image is written once
// (29.4 MB for the batched call's 32 crops of 448 x 512) and each of its
// stencilled pixels read once from depth (the grown groups are 1/64 of
// that and stay in L1); the labels read 7.3 MB and write 13.0 MB.  About
// 50-65 MB in all, 15-20 us at 3.35 TB/s; the arithmetic is a few integer
// operations a pixel.  The ATen chain it replaces built an int64 index per
// output pixel (58.7 MB for the crops) and passed over the crops some eight
// times.
//
// Design.
// * stencil_hand_images_kernel: one CTA of 256 threads per (image, label
//   tile), the tile being 8r x 128r full-resolution pixels (16 x 256 at
//   r = 2): 1,792 CTAs for 32 crops, 112 for a live frame's 2.  A thread
//   takes 4 neighbouring pixels of a row a step, their loads in flight
//   together and one 16-byte store; neighbouring threads take neighbouring
//   quads, and read neighbouring pixels of depth (backwards for the left
//   hand), so both are coalesced; a pixel outside its hand's group reads
//   no depth.  (One pixel a thread and step took 0.043 ms on the H100 for
//   32 crops: latency-bound.)  Under the guard each thread keeps the min
//   and max of its valid samples, the CTA reduces them (warp shuffles, then
//   shared memory) and writes the tile's code (bit 0 occupied, bit 1
//   over-spread) to a scratch byte: no atomics, so a replay equals an eager
//   call.  Unguarded, it writes the muted flags (false).
// * stencil_guard_kernel (guarded only): the same grid.  Each CTA counts
//   its image's codes with __syncthreads_count, decides the image's flag,
//   writes it (the image's first tile), and returns at once unless the
//   image is muted, when it zeroes its own tile.  The decision waits for
//   every tile of an image, so it is a second launch.
// * place_crop_labels_kernel: one CTA of 128 threads per output row of one
//   hand, each thread a strided run of the row's pixels: coalesced writes,
//   and reads that run forwards (right) or backwards (left) inside the
//   crop's row.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLabelThreads = 128;
constexpr int32_t kMissing = 65535;
constexpr int kTileRows = 8;      // label rows of a guard tile
constexpr int kTileCols = 128;    // label columns of a guard tile

struct ImageParams {
  const int32_t* depth;   // (frames, h, w)
  const int32_t* grown;   // (frames, hs, ws): hand groups at level `level`
  const int64_t* frames;  // (pairs,) frame of each pair, or null: pair i
  const int32_t* oys;     // (pairs, 2) window origins, or null: the frame
  const int32_t* oxs;     //   (the left hand's in mirrored space)
  const uint8_t* zero;    // (pairs,) or null
  int zero_when;          // a pair whose zero flag equals this is zeroed
  int32_t* out;           // (2 pairs, ch, cw)
  uint8_t* codes;         // (2 pairs, tiles) guard codes, or null: unguarded
  uint8_t* muted;         // (2 pairs,)
  int h, w, hs, ws, ch, cw, level, r;
  int tiles_x, tiles;     // label tiles a row of tiles, an image
  int spread;
  float frac;
};

struct LabelParams {
  const int32_t* labels;  // (2 pairs, lh, lw): K1's, the left hand mirrored
  const int32_t* oys;     // (pairs, 2) full-resolution origins, or null
  const int32_t* oxs;
  int32_t* out;           // (pairs, 2, hl, wl)
  int lh, lw, hl, wl, r;
};

// Python's floor division (the plain versions' `//` on integer tensors).
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

template <bool kGuard>
__global__ void __launch_bounds__(kThreads)
stencil_hand_images_kernel(const ImageParams p) {
  const int n = blockIdx.x / p.tiles;               // image
  const int t = blockIdx.x - n * p.tiles;           // its label tile
  const int ty = t / p.tiles_x;
  const int pair = n >> 1, hand = n & 1;
  const int tile_h = kTileRows * p.r, tile_w = kTileCols * p.r;
  const int y0 = ty * tile_h, x0 = (t - ty * p.tiles_x) * tile_w;
  const int rows = min(tile_h, p.ch - y0), cols = min(tile_w, p.cw - x0);
  if (!kGuard && t == 0 && threadIdx.x == 0) p.muted[n] = 0;

  const bool zeroed =
      p.zero != nullptr && (p.zero[pair] != 0) == (p.zero_when != 0);
  int oy = 0, ox = 0;
  if (p.oys != nullptr) {
    oy = p.oys[n];
    ox = hand ? p.w - p.cw - p.oxs[n] : p.oxs[n];
  }
  const long long frame = p.frames != nullptr ? p.frames[pair] : pair;
  const int32_t* depth = p.depth + frame * p.h * p.w;
  const int32_t* grown = p.grown + frame * p.hs * p.ws;
  const int gy0 = floordiv(oy, 1 << p.level), gx0 = floordiv(ox, 1 << p.level);
  const int32_t group = hand + 1;
  int32_t* out = p.out + static_cast<long long>(n) * p.ch * p.cw;

  // 16-byte stores where a row is a multiple of 4 pixels (x0 is)
  const int quads = (cols + 3) / 4;
  const bool vec = (p.cw & 3) == 0;
  int vmin = 1 << 20, vmax = -1;
  for (int q = threadIdx.x; q < rows * quads; q += kThreads) {
    const int i = y0 + q / quads, j0 = x0 + 4 * (q % quads);
    const int y = oy + i, gy = gy0 + (i >> p.level);
    const bool row_in =
        !zeroed && y >= 0 && y < p.h && gy >= 0 && gy < p.hs;
    const int32_t* drow = depth + (row_in ? y : 0) * p.w;
    const int32_t* grow = grown + (row_in ? gy : 0) * p.ws;
    int32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + k;
      const int jj = hand ? p.cw - 1 - j : j;
      const int x = ox + jj, gx = gx0 + (jj >> p.level);
      int32_t d = 0;
      if (row_in && j < x0 + cols && x >= 0 && x < p.w && gx >= 0 &&
          gx < p.ws && grow[gx] == group) {
        d = drow[x];
      }
      v[k] = zeroed ? 0 : (d == 0 ? kMissing : d);
    }
    int32_t* o = out + static_cast<long long>(i) * p.cw + j0;
    if (vec) {
      *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (j0 + k < x0 + cols) o[k] = v[k];
    }
    if (kGuard && i % p.r == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((j0 + k) % p.r == 0 && j0 + k < x0 + cols && v[k] > 0 &&
            v[k] < kMissing) {
          vmin = min(vmin, v[k]);
          vmax = max(vmax, v[k]);
        }
      }
    }
  }
  if (!kGuard) return;

  __shared__ int smin[kWarps], smax[kWarps];
  for (int o = 16; o > 0; o >>= 1) {
    vmin = min(vmin, __shfl_xor_sync(0xffffffffu, vmin, o));
    vmax = max(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    smin[warp] = vmin;
    smax[warp] = vmax;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kWarps; ++k) {
      vmin = min(vmin, smin[k]);
      vmax = max(vmax, smax[k]);
    }
    const bool occupied = vmax >= 0;
    const bool spread = occupied && vmax - vmin > p.spread;
    p.codes[static_cast<long long>(n) * p.tiles + t] =
        static_cast<uint8_t>(occupied | (spread << 1));
  }
}

__global__ void __launch_bounds__(kThreads)
stencil_guard_kernel(const ImageParams p) {
  const int n = blockIdx.x / p.tiles;
  const int t = blockIdx.x - n * p.tiles;
  const uint8_t* codes = p.codes + static_cast<long long>(n) * p.tiles;
  int occupied = 0, spread = 0;
  for (int base = 0; base < p.tiles; base += kThreads) {
    const int k = base + threadIdx.x;
    const uint8_t c = k < p.tiles ? codes[k] : 0;
    occupied += __syncthreads_count(c & 1);
    spread += __syncthreads_count(c & 2);
  }
  const float share = __fdiv_rn(__int2float_rn(spread),
                                __int2float_rn(max(occupied, 1)));
  const bool muted = share > p.frac;
  if (t == 0 && threadIdx.x == 0) p.muted[n] = muted;
  if (!muted) return;
  const int ty = t / p.tiles_x;
  const int tile_h = kTileRows * p.r, tile_w = kTileCols * p.r;
  const int y0 = ty * tile_h, x0 = (t - ty * p.tiles_x) * tile_w;
  const int rows = min(tile_h, p.ch - y0), cols = min(tile_w, p.cw - x0);
  int32_t* out = p.out + static_cast<long long>(n) * p.ch * p.cw;
  for (int q = threadIdx.x; q < rows * cols; q += kThreads)
    out[(y0 + q / cols) * p.cw + x0 + q % cols] = 0;
}

__global__ void __launch_bounds__(kLabelThreads)
place_crop_labels_kernel(const LabelParams p) {
  const long long row = blockIdx.x;                 // (image, Y)
  const int n = static_cast<int>(row / p.hl);
  const int y = static_cast<int>(row - static_cast<long long>(n) * p.hl);
  const int hand = n & 1;
  int oy = 0, ox = 0;
  if (p.oys != nullptr) {
    oy = floordiv(p.oys[n], p.r);
    ox = floordiv(p.oxs[n], p.r);
  }
  const int cy = y - oy;
  const bool inside = cy >= 0 && cy < p.lh;
  const int32_t* src =
      p.labels + (static_cast<long long>(n) * p.lh + (inside ? cy : 0)) * p.lw;
  int32_t* out = p.out + row * p.wl;
  for (int x = threadIdx.x; x < p.wl; x += kLabelThreads) {
    const int cx = (hand ? p.wl - 1 - x : x) - ox;
    out[x] = inside && cx >= 0 && cx < p.lw ? src[cx] : kMissing;
  }
}

}  // namespace

// depth (frames, h, w) and grown (frames, hs, ws) int32; frames (pairs,)
// int64 or null; oys, oxs (pairs, 2) int32 or null (the whole frame, then
// ch = h, cw = w); zero (pairs,) bool or null, a pair zeroed where it
// equals zero_when; out (2 pairs, ch, cw) int32; tiles (2 pairs,
// tiles_of(ch, cw, r)) uint8 scratch, or null: no guard; muted (2 pairs,)
// bool.  One launch, two under the guard.  Returns cudaGetLastError().
extern "C" int b3d_hand_images(const int32_t* depth, const int32_t* grown,
                               const int64_t* frames, const int32_t* oys,
                               const int32_t* oxs, const uint8_t* zero,
                               int zero_when, int32_t* out, uint8_t* tiles,
                               uint8_t* muted, int pairs, int h, int w,
                               int hs, int ws, int ch, int cw, int level,
                               int r, int spread, float frac, void* stream) {
  if (pairs < 0 || h < 1 || w < 1 || hs < 1 || ws < 1 || ch < 1 || cw < 1 ||
      level < 0 || level > 16 || r < 1 || r > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_y = ((ch + r - 1) / r + kTileRows - 1) / kTileRows;
  const int tiles_x = ((cw + r - 1) / r + kTileCols - 1) / kTileCols;
  const long long grid = 2LL * pairs * tiles_y * tiles_x;
  if (grid > 0x7fffffffLL ||
      static_cast<long long>(h) * w > 0x7fffffffLL ||
      static_cast<long long>(ch) * cw > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (grid == 0) return static_cast<int>(cudaSuccess);
  const ImageParams p{depth, grown, frames, oys, oxs, zero, zero_when, out,
                      tiles, muted, h, w, hs, ws, ch, cw, level, r,
                      tiles_x, tiles_y * tiles_x, spread, frac};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles == nullptr) {
    stencil_hand_images_kernel<false>
        <<<static_cast<unsigned>(grid), kThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  stencil_hand_images_kernel<true>
      <<<static_cast<unsigned>(grid), kThreads, 0, s>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stencil_guard_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// labels (2 pairs, lh, lw) int32; oys, oxs (pairs, 2) int32 full-resolution
// origins, or null (the whole frame: lh = hl, lw = wl); out (pairs, 2, hl,
// wl) int32.  Returns cudaGetLastError() after the launch.
extern "C" int b3d_place_labels(const int32_t* labels, const int32_t* oys,
                                const int32_t* oxs, int32_t* out, int pairs,
                                int lh, int lw, int hl, int wl, int r,
                                void* stream) {
  if (pairs < 0 || lh < 0 || lw < 0 || hl < 0 || wl < 0 || r < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long grid = 2LL * pairs * hl;
  if (grid > 0x7fffffffLL ||
      static_cast<long long>(lh) * lw > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (grid == 0 || wl == 0) return static_cast<int>(cudaSuccess);
  const LabelParams p{labels, oys, oxs, out, lh, lw, hl, wl, r};
  place_crop_labels_kernel<<<static_cast<unsigned>(grid), kLabelThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
