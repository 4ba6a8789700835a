// Decision-forest evaluation kernels:
//
// * K1, evaluate_layered_kernel (evaluate_layered_cuda): every layer of a
//   layered forest plus the conditions composite;
// * B1, evaluate_forest_kernel (evaluate_forest_cuda): one forest, at the
//   end of this file, on K1's design.
//
// K1 replaces the Pallas TPU kernel
// beats3d_tpu/ops/forest_eval_pallas.py:evaluate_layered_pallas
// (_run_layered_pallas, body _make_layered_kernel).  It keeps that kernel's
// contract, the plain ops/forest_eval.run_layered, not its TPU design: the
// packed row pairs, needed-set probe sweeps and lane shuffles exist because
// Mosaic has no per-lane gather; Hopper gathers per thread.
//
// Contract: up to 4 layers of up to 16 trees and 16 classes; a filtered
// layer runs only where the pixel's label of the filter layer equals the
// filter class; per tree the walk from the root with floor((scale*u)/d)
// offsets (forest_walk.cuh, as B1 and B4 compute them); leaf pdfs summed
// level by level, in tree order within a level (the plain evaluator's
// order, so the float32 sums are its own bit for bit); the strictly-greater
// argmax from (0.0, class 0); then the conditions composite (65535 =
// unlabelled).
//
// What bounds it on the H100.  The bytes it must move are small: the depth
// (1.8 MB for the live frame's two 448x512 crops), the labels and the node
// rows the pixels visit (0.35 MB of the flagship's headers on the live
// crops), about 1 us at 3.35 TB/s.  What a pixel costs is latency: each tree level is a
// node read whose address depends on the previous branch, then four probe
// quotients (forest_walk.cuh: one reciprocal per pixel, two multiply-adds
// per quotient), then two depth gathers whose addresses depend on the node.
// One thread per pixel walking the 4 coarse and then the 4 fine trees is a
// chain of up to 96 dependent levels, and the live frame fills less than
// one wave of such threads, so the longest chain sets the time.  The
// batched call (32 crops) fills the card many times over, and there the
// lanes kept busy set it.
//
// Design.
// * A group of G lanes per pixel, lane k walking trees k, k + G, ...  With
//   one lane per tree (G = 4 for the flagship, 8 pixels per warp) the chain
//   per pixel drops to the deepest walk of each layer, 8 + 16 levels.
//   Where the lanes would fill the card more than 8 times over, G is
//   halved and each lane walks two trees (the batched call): measured on
//   the H100, G = 2 is faster there and G = 4 on the live crops.  Each lane
//   writes its trees' (stop level, leaf row) to a per-warp scratch in
//   shared memory; lane k then sums classes k, k + G, ... over all trees in
//   the plain order, and the group takes the argmax with warp shuffles, so
//   every lane holds the label that the next layer's filter and the
//   composite read.  A warp with no eligible pixel skips a layer's sums.
// * A block covers a (32 / G) x 8 tile of label pixels (one row per warp),
//   so neighbouring pixels, whose probes and node paths overlap, share L1.
// * The forest is repacked once, at model load (models/forest.py:
//   kernel_tables): a 32-byte header per node (ux, uy, vx, vy, thresh,
//   l_next, r_next, 0), read as two 16-byte loads through the read-only
//   cache, and a leaf-pdf table (T, nodes, 2, C) read only at the leaf.
//   The flagship's fine headers (8.4 MB) stay in the 50 MB L2.  Staging the
//   top tree levels in shared memory (a bulk asynchronous copy per tree
//   into persistent blocks) was measured slower than these L1/L2 reads at
//   every staged depth and grouping, and was left out.

#include <cstdint>

#include <cuda_runtime.h>

#include "forest_walk.cuh"

namespace {

constexpr int kMaxLayers = 4;
constexpr int kMaxClasses = 16;
constexpr int kMaxConditions = 128;
constexpr int kMaxTrees = 16;
constexpr int kLayeredThreads = 256;          // K1's and B1's block: 8
                                              // warps, one label row each
constexpr int kWarps = kLayeredThreads / 32;

}  // namespace

// One layer, as the Python wrapper passes it (ctypes mirrors this layout):
// the repacked tables of models/forest.py:kernel_tables.
struct B3dLayerDesc {
  const float4* header;  // (trees, 2^levels - 1, 2) float4: (ux, uy, vx, vy),
                         // (thresh, l_next, r_next, 0)
  const float* pdf;      // (trees, 2^levels - 1, 2, classes) float32
  int trees;
  int levels;
  int classes;
  int filter_model;      // earlier layer index, or -1
  int filter_class;
};

struct LayeredParams {
  B3dLayerDesc layer[kMaxLayers];
  int num_layers;
  int max_trees;                  // scratch entries per pixel
};

namespace {

// Walks tree t of layer l for the pixel (y, x) of centre depth d.  Returns
// (stop level, leaf pdf row (t * nodes + row) * 2 + side), or (levels, -1)
// when the walk still descends after the last level.
__device__ __forceinline__ int2 walk(const B3dLayerDesc& l, int t,
                                     const int32_t* __restrict__ img, int h,
                                     int w, int y, int x, float d, float rd,
                                     float scale) {
  const int nodes = (1 << l.levels) - 1;
  const float4* tree = l.header + 2 * static_cast<size_t>(t) * nodes;
  int g = 0;
  for (int j = 0; j < l.levels; ++j) {
    const int row = (1 << j) - 1 + g;
    const float4 a = __ldg(tree + 2 * row);
    const float4 b = __ldg(tree + 2 * row + 1);
    const float f =
        b3d::depth_feature_uv(img, h, w, y, x, d, rd, scale, a.x, a.y, a.z,
                              a.w);
    const int side = (f < b.x) ? 0 : 1;
    if (floorf(side ? b.z : b.y) == -1.0f) {
      g = 2 * g + side;
      continue;
    }
    return make_int2(j, 2 * (t * nodes + row) + side);
  }
  return make_int2(l.levels, -1);
}

// G lanes per pixel.  A block covers a tile of (32 / G) x 8 label pixels,
// warp w the 32 / G pixels of the tile's row w; blockIdx.z is the image.
// Dynamic shared memory: per warp (32 / G) x max_trees int2 (stop level,
// leaf row) entries.
template <int G, int kMinBlocks, int kMaxC>
__global__ void __launch_bounds__(kLayeredThreads, kMinBlocks)
evaluate_layered_kernel(const int32_t* __restrict__ depth,
                        int32_t* __restrict__ out, int h, int w, int r,
                        float scale, const __grid_constant__ LayeredParams p,
                        const int32_t* __restrict__ conditions,
                        int num_cond) {
  constexpr int kPix = 32 / G;                         // pixels per warp task
  constexpr int kCls = (kMaxC + G - 1) / G;            // classes per lane
  extern __shared__ int2 scratch[];
  __shared__ int s_cond[2 * kMaxConditions];
  for (int i = threadIdx.x; i < 2 * num_cond; i += kLayeredThreads) {
    s_cond[i] = conditions[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pix = lane / G;
  const int k = lane % G;
  int2* ent = scratch + (warp * kPix + pix) * p.max_trees;
  const int hl = h / r;
  const int wl = w / r;
  const int yl = blockIdx.y * kWarps + warp;
  if (yl >= hl) return;                                // the whole warp

  const int xl = blockIdx.x * kPix + pix;
  const int img_i = blockIdx.z;
  const int32_t* img = depth + static_cast<size_t>(img_i) * h * w;
  const int y = yl * r;
  const int x = xl * r;
  const bool inside = xl < wl;
  const int dc = inside ? __ldg(img + static_cast<size_t>(y) * w + x) : 0;
  const bool base_eligible = dc != 0 && dc != b3d::kMissing;
  const float d = static_cast<float>(dc);
  const float rd = __frcp_rn(d);

  int labels[kMaxLayers];
#pragma unroll
  for (int li = 0; li < kMaxLayers; ++li) {
    labels[li] = b3d::kMissing;
    if (li >= p.num_layers) continue;
    const B3dLayerDesc& layer = p.layer[li];
    bool eligible = base_eligible;
    if (layer.filter_model >= 0) {
      int filter_label = labels[0];
#pragma unroll
      for (int q = 1; q < li; ++q) {
        if (q == layer.filter_model) filter_label = labels[q];
      }
      eligible = eligible && filter_label == layer.filter_class;
    }
    if (eligible) {
      for (int t = k; t < layer.trees; t += G) {
        ent[t] = walk(layer, t, img, h, w, y, x, d, rd, scale);
      }
    }
    __syncwarp();
    // classes k, k + G, ... summed level by level, in tree order within a
    // level; then the local strictly-greater argmax
    float best_v = 0.0f;
    int best_c = kMaxClasses;                         // none above 0.0
    if (!__any_sync(0xffffffffu, eligible)) continue; // labels[li] stays
    if (eligible) {
      float acc[kCls];
#pragma unroll
      for (int i = 0; i < kCls; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (;;) {
        int cur = 1 << 30;
        for (int t = 0; t < layer.trees; ++t) {
          const int2 e = ent[t];
          if (e.y >= 0 && e.x > prev && e.x < cur) cur = e.x;
        }
        if (cur == 1 << 30) break;
        float level_sum[kCls];
        bool first = true;
        for (int t = 0; t < layer.trees; ++t) {
          const int2 e = ent[t];
          if (e.y < 0 || e.x != cur) continue;
          const float* pdf = layer.pdf + static_cast<size_t>(e.y) * layer.classes;
#pragma unroll
          for (int i = 0; i < kCls; ++i) {
            const int c = k + i * G;
            if (c < layer.classes) {
              const float v = __ldg(pdf + c);
              level_sum[i] = first ? v : __fadd_rn(level_sum[i], v);
            }
          }
          first = false;
        }
#pragma unroll
        for (int i = 0; i < kCls; ++i) {
          if (k + i * G < layer.classes) acc[i] = __fadd_rn(acc[i], level_sum[i]);
        }
        prev = cur;
      }
#pragma unroll
      for (int i = 0; i < kCls; ++i) {
        if (k + i * G < layer.classes && acc[i] > best_v) {
          best_v = acc[i];
          best_c = k + i * G;
        }
      }
    }
    // the group's argmax: the larger sum, the smaller class on a tie
#pragma unroll
    for (int m = 1; m < G; m <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best_v, m);
      const int oc = __shfl_xor_sync(0xffffffffu, best_c, m);
      if (ov > best_v || (ov == best_v && oc < best_c)) {
        best_v = ov;
        best_c = oc;
      }
    }
    if (eligible) labels[li] = best_c == kMaxClasses ? 0 : best_c;
    __syncwarp();
  }

  // Conditions walk: row conditions[offset + label - 1] = (0, CLASS) emits
  // CLASS, (1, NEXT) moves on to the next layer at offset NEXT; a label of
  // 0 or 65535 leaves the pixel unlabelled.
  int result = b3d::kMissing;
  int offset = 0;
#pragma unroll
  for (int li = 0; li < kMaxLayers; ++li) {
    if (li >= p.num_layers) break;
    const int l = labels[li];
    if (l == 0 || l == b3d::kMissing) break;
    const int row = min(max(offset + l - 1, 0), num_cond - 1);
    const int flag = s_cond[2 * row];
    const int val = s_cond[2 * row + 1];
    if (flag == 0) {
      result = val;
      break;
    }
    if (flag == 1) offset = val;
  }
  if (inside && k == 0) {
    out[(static_cast<size_t>(img_i) * hl + yl) * wl + xl] = result;
  }
}

template <int G, int kMaxC>
int launch_layered(const int32_t* depth, int32_t* out, int n, int h, int w,
                   int r, float scale, const LayeredParams& p,
                   const int32_t* conditions, int num_cond,
                   cudaStream_t stream) {
  const dim3 grid((w / r + 32 / G - 1) / (32 / G), (h / r + kWarps - 1) / kWarps, n);
  const int smem = kWarps * (32 / G) * p.max_trees * static_cast<int>(sizeof(int2));
  // two lanes per pixel run best with 6 blocks of 256 threads per SM (40
  // registers a thread), the other groupings with what they need
  evaluate_layered_kernel<G, G == 2 ? 6 : 1, kMaxC>
      <<<grid, kLayeredThreads, smem, stream>>>(
      depth, out, h, w, r, scale, p, conditions, num_cond);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// depth: (n, h, w) int32; out: (n, h / r, w / r) int32; conditions:
// (num_cond, 2) int32; all device pointers.  layers: host array of
// num_layers descriptors.  lanes: lanes per pixel (1, 2, 4, 8 or 16; 0 =
// the smallest power of two >= the most trees of a layer).  Returns
// cudaGetLastError() after the launch.
extern "C" int b3d_evaluate_layered(const int32_t* depth, int32_t* out, int n,
                                    int h, int w, int r, float scale,
                                    const B3dLayerDesc* layers, int num_layers,
                                    const int32_t* conditions, int num_cond,
                                    int lanes, void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || num_cond < 1 ||
      num_cond > kMaxConditions || r < 1 || n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LayeredParams p{};
  p.num_layers = num_layers;
  for (int i = 0; i < num_layers; ++i) {
    const B3dLayerDesc& l = layers[i];
    if (l.classes < 1 || l.classes > kMaxClasses || l.trees < 1 ||
        l.trees > kMaxTrees || l.levels < 1 || l.levels > 24 ||
        l.filter_model >= i) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.layer[i] = l;
    p.max_trees = l.trees > p.max_trees ? l.trees : p.max_trees;
  }
  for (int i = num_layers; i < kMaxLayers; ++i) {
    p.layer[i] = B3dLayerDesc{nullptr, nullptr, 0, 0, 0, -1, 0};
  }
  const long long pixels = static_cast<long long>(n) * (h / r) * (w / r);
  if (pixels == 0) return static_cast<int>(cudaSuccess);
  if (lanes == 0) {
    // one lane per tree; where the lanes would fill the card more than 8
    // times over (the batched call's 32 crops), half as many, each lane
    // walking two trees: lanes kept busy then matter more than the chain
    lanes = 1;
    while (lanes < p.max_trees) lanes *= 2;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (lanes > 1 && pixels * lanes > 8LL * sms * 2048) lanes /= 2;
  }
  int max_classes = 0;
  for (int i = 0; i < num_layers; ++i) {
    max_classes = layers[i].classes > max_classes ? layers[i].classes : max_classes;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define B3D_LAUNCH(G)                                                          \
  case G:                                                                      \
    return max_classes <= 8                                                    \
               ? launch_layered<G, 8>(depth, out, n, h, w, r, scale, p,        \
                                      conditions, num_cond, s)                 \
               : launch_layered<G, 16>(depth, out, n, h, w, r, scale, p,       \
                                       conditions, num_cond, s);
  switch (lanes) {
    B3D_LAUNCH(1)
    B3D_LAUNCH(2)
    B3D_LAUNCH(4)
    B3D_LAUNCH(8)
    B3D_LAUNCH(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef B3D_LAUNCH
}

// ---------------------------------------------------------------------------
// B1: one forest (evaluate_forest_cuda).
//
// Replaces the Pallas TPU kernel
// beats3d_tpu/ops/forest_eval_pallas.py:evaluate_forest_pallas (_run_pallas,
// body _make_kernel) and keeps the contract of the plain evaluator
// beats3d_tpu/ops/forest_eval.py:evaluate_forest: labels of one forest on
// the stride-r grid, with an optional filter image (evaluate only where it
// equals filter_class), a probe scale, and single-tree semantics
// (write_all_eligible = 0: write only where every tree reached a leaf);
// the argmax takes the strictly greater class from (0.0, class 0), the
// first maximum; 65535 marks pixels not written.
//
// Bound, as K1, by latency: per level a node read, four probe offsets and
// two depth gathers whose addresses depend on the node; on the golden
// frames only ~10 % of the pixels are eligible, so the chains run in less
// than one wave.  The trainer calls it mostly on one new tree (T = 1),
// read in place in the dense layout (its rows are new at every call; a
// repack would cost a pass of its own).
//
// Design: K1's, on the dense layout.  G lanes per pixel, lane k walking
// trees k, k + G, ... (one lane per tree, halved while the lanes would
// fill the card more than 4 times over: on 848x480 frames at r = 1 most
// pixels are ineligible, and idle lanes cost more than the chain); a block
// covers (32 / G) x 8 label pixels, one row per warp; each lane writes its
// trees' (stop level, leaf side) to a per-warp scratch in shared memory and
// then sums its classes k, k + G, ... level by level, in tree order within
// a level (the plain order, so the float32 sums and an argmax near a tie
// are the plain evaluator's bit for bit); the group's argmax is a shuffle
// butterfly that takes the smaller class on a tie.  No per-thread array is
// indexed at run time (a pdf pointer and a stop level per tree would take
// 192 bytes of local memory), and the class sums are sized to the forest
// (8 or 16).

namespace {

// Walks one dense tree (rows of els floats) for the pixel (y, x) of centre
// depth d.  Returns (stop level, 2 * row + side), or (levels, -1) when the
// walk still descends after the last level.
__device__ __forceinline__ int2 walk_dense(const float* __restrict__ tree,
                                           int levels, int els,
                                           const int32_t* __restrict__ img,
                                           int h, int w, int y, int x,
                                           float d, float rd, float scale) {
  int row = 0;
  for (int j = 0; j < levels; ++j) {
    const float* node = tree + static_cast<size_t>(row) * els;
    const float f = b3d::depth_feature_uv(img, h, w, y, x, d, rd, scale,
                                          __ldg(node), __ldg(node + 1),
                                          __ldg(node + 2), __ldg(node + 3));
    const int side = (f < __ldg(node + 4)) ? 0 : 1;
    if (floorf(__ldg(node + 5 + side)) != -1.0f) {
      return make_int2(j, 2 * row + side);
    }
    row = 2 * row + 1 + side;
  }
  return make_int2(levels, -1);
}

template <int G, int kMaxC>
__global__ void __launch_bounds__(kLayeredThreads, 1)
evaluate_forest_kernel(const int32_t* __restrict__ depth,
                       int32_t* __restrict__ out, int h, int w, int r,
                       float scale, const float* __restrict__ forest,
                       int trees, int levels, int classes,
                       const int32_t* __restrict__ filter, int filter_class,
                       int write_all_eligible) {
  constexpr int kPix = 32 / G;
  constexpr int kCls = (kMaxC + G - 1) / G;
  extern __shared__ int2 scratch[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pix = lane / G;
  const int k = lane % G;
  int2* ent = scratch + (warp * kPix + pix) * trees;
  const int hl = h / r;
  const int wl = w / r;
  const int yl = blockIdx.y * kWarps + warp;
  if (yl >= hl) return;                                // the whole warp

  const int xl = blockIdx.x * kPix + pix;
  const bool inside = xl < wl;
  const int32_t* img = depth + static_cast<size_t>(blockIdx.z) * h * w;
  const int y = yl * r;
  const int x = xl * r;
  const size_t oi = (static_cast<size_t>(blockIdx.z) * hl + yl) * wl + xl;
  const int dc = inside ? __ldg(img + static_cast<size_t>(y) * w + x) : 0;
  bool eligible = dc != 0 && dc != b3d::kMissing;
  if (eligible && filter != nullptr) eligible = __ldg(filter + oi) == filter_class;
  const float d = static_cast<float>(dc);
  const float rd = __frcp_rn(d);
  const int els = 7 + 2 * classes;
  const size_t nodes = (size_t{1} << levels) - 1;

  bool done = true;                  // every tree of the lane reached a leaf
  if (eligible) {
    for (int t = k; t < trees; t += G) {
      const int2 e = walk_dense(forest + t * nodes * els, levels, els, img, h,
                                w, y, x, d, rd, scale);
      ent[t] = e;
      done = done && e.y >= 0;
    }
  }
#pragma unroll
  for (int m = 1; m < G; m <<= 1) {
    done = __shfl_xor_sync(0xffffffffu, static_cast<int>(done), m) && done;
  }
  const bool write = eligible && (write_all_eligible || done);
  __syncwarp();
  float best_v = 0.0f;
  int best_c = kMaxClasses;                           // none above 0.0
  if (__any_sync(0xffffffffu, write)) {
    if (write) {
      float acc[kCls];
#pragma unroll
      for (int q = 0; q < kCls; ++q) acc[q] = 0.0f;
      int prev = -1;
      for (;;) {
        int cur = 1 << 30;
        for (int t = 0; t < trees; ++t) {
          const int2 e = ent[t];
          if (e.y >= 0 && e.x > prev && e.x < cur) cur = e.x;
        }
        if (cur == 1 << 30) break;
        float level_sum[kCls];
        bool first = true;
        for (int t = 0; t < trees; ++t) {
          const int2 e = ent[t];
          if (e.y < 0 || e.x != cur) continue;
          const float* pdf = forest + (t * nodes + (e.y >> 1)) * els + 7 +
                             (e.y & 1) * classes;
#pragma unroll
          for (int q = 0; q < kCls; ++q) {
            const int c = k + q * G;
            if (c < classes) {
              const float v = __ldg(pdf + c);
              level_sum[q] = first ? v : __fadd_rn(level_sum[q], v);
            }
          }
          first = false;
        }
#pragma unroll
        for (int q = 0; q < kCls; ++q) {
          if (k + q * G < classes) acc[q] = __fadd_rn(acc[q], level_sum[q]);
        }
        prev = cur;
      }
#pragma unroll
      for (int q = 0; q < kCls; ++q) {
        if (k + q * G < classes && acc[q] > best_v) {
          best_v = acc[q];
          best_c = k + q * G;
        }
      }
    }
    // the group's argmax: the larger sum, the smaller class on a tie
#pragma unroll
    for (int m = 1; m < G; m <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best_v, m);
      const int oc = __shfl_xor_sync(0xffffffffu, best_c, m);
      if (ov > best_v || (ov == best_v && oc < best_c)) {
        best_v = ov;
        best_c = oc;
      }
    }
  }
  if (inside && k == 0) {
    out[oi] = !write ? b3d::kMissing : (best_c == kMaxClasses ? 0 : best_c);
  }
}

template <int G, int kMaxC>
int launch_forest(const int32_t* depth, int32_t* out, int n, int h, int w,
                  int r, float scale, const float* forest, int trees,
                  int levels, int classes, const int32_t* filter,
                  int filter_class, int write_all_eligible,
                  cudaStream_t stream) {
  const dim3 grid((w / r + 32 / G - 1) / (32 / G), (h / r + kWarps - 1) / kWarps, n);
  const int smem = kWarps * (32 / G) * trees * static_cast<int>(sizeof(int2));
  evaluate_forest_kernel<G, kMaxC><<<grid, kLayeredThreads, smem, stream>>>(
      depth, out, h, w, r, scale, forest, trees, levels, classes, filter,
      filter_class, write_all_eligible);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// depth: (n, h, w) int32; out: (n, h / r, w / r) int32; forest: (trees,
// 2^levels - 1, 7 + 2 * classes) float32; filter: (n, h / r, w / r) int32 or
// null; all device pointers.  lanes: lanes per pixel (1, 2, 4, 8 or 16; 0 =
// one per tree, halved while the lanes would fill the card more than 4
// times over).  Returns cudaGetLastError() after the launch.
extern "C" int b3d_evaluate_forest(const int32_t* depth, int32_t* out, int n,
                                   int h, int w, int r, float scale,
                                   const float* forest, int trees, int levels,
                                   int classes, const int32_t* filter,
                                   int filter_class, int write_all_eligible,
                                   int lanes, void* stream) {
  if (trees < 1 || trees > kMaxTrees || classes < 1 || classes > kMaxClasses ||
      levels < 1 || levels > 30 || r < 1 || n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pixels = static_cast<long long>(n) * (h / r) * (w / r);
  if (pixels == 0) return static_cast<int>(cudaSuccess);
  if (lanes == 0) {
    lanes = 1;
    while (lanes < trees) lanes *= 2;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    while (lanes > 1 && pixels * lanes > 4LL * sms * 2048) lanes /= 2;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define B3D_FOREST(G)                                                          \
  case G:                                                                      \
    return (classes <= 8 ? launch_forest<G, 8> : launch_forest<G, 16>)(        \
        depth, out, n, h, w, r, scale, forest, trees, levels, classes, filter, \
        filter_class, write_all_eligible, s);
  switch (lanes) {
    B3D_FOREST(1)
    B3D_FOREST(2)
    B3D_FOREST(4)
    B3D_FOREST(8)
    B3D_FOREST(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef B3D_FOREST
}

// Message of a cudaError_t returned by the entries above.
extern "C" const char* b3d_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
