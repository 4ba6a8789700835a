// Decision-forest evaluation kernels:
//
// * K1 (evaluate_layered_cuda): every layer of a layered forest plus the
//   conditions composite, in evaluate_layered_wide_kernel for any model and
//   evaluate_layered_kernel for one of at most 4 layers, 16 classes and 128
//   condition rows (the flagship's kind, faster there); a routed model
//   (rows that name the layer the composite continues at) in the general
//   kernel's routed instantiation, which also counts its routing;
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
// Contract: any number of layers of any number of trees and classes; a
// filtered layer runs only where the pixel's label of the filter layer
// equals the filter class; per tree the walk from the root with
// floor((scale*u)/d) offsets (forest_walk.cuh, as B1 and B4 compute them);
// leaf pdfs summed level by level, in tree order within a level (the plain
// evaluator's order, so the float32 sums are its own bit for bit); the
// strictly-greater argmax from (0.0, class 0); then the conditions composite
// over a table of any length (65535 = unlabelled).
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
// * A group of G lanes per pixel (G <= 16), lane k walking trees k, k + G,
//   ...  With one lane per tree (G = 4 for the flagship, 8 pixels per warp)
//   the chain per pixel drops to the deepest walk of each layer, 8 + 16
//   levels.  Where the lanes would fill the card more than 8 times over, G
//   is halved and each lane walks two trees (the batched call): measured on
//   the H100, G = 2 is faster there and G = 4 on the live crops.  Each lane
//   writes its trees' (stop level, leaf side) to a per-pixel scratch in
//   shared memory; lane k then sums classes k, k + G, ... over all trees in
//   the plain order, and the group takes the argmax with warp shuffles, so
//   every lane holds the label.  More than 16 classes are summed in passes
//   of 16 over the same scratch (each class's sum is its own), the argmax
//   carried from pass to pass.  A warp with no eligible pixel skips a
//   layer's sums.
// * Scratch size.  A block holds kWarps x (32 / G) pixels' scratch.  Where
//   it would pass the 48 KB a block gets by default, G is doubled (up to
//   16); past that the block asks for up to 227 KB; past that (thousands of
//   trees) every pixel's scratch goes to a buffer in device memory that the
//   wrapper allocates (plan_scratch).  That instantiation also indexes the
//   leaf pdfs in 64 bits, which K1 needs for a layer whose pdf table holds
//   2^31 floats or more (8 GB); the others index them in 32 (registers:
//   G = 2 runs at 40 a thread).
// * The general kernel reads the layer descriptors from device memory, one
//   layer per pass of a runtime loop; each pixel's label of every layer
//   stays in its scratch for the later layers' filters and the composite,
//   walked after the last layer.  (Keeping the first layers' descriptors
//   in the parameter bank, the loop unrolled over them, in the same kernel,
//   and walking the composite as the labels became final, took more
//   registers: at G = 2, 40 a thread, ptxas spilled 286 bytes where this
//   spills 16.)  A model of at most 4 layers, 16 classes and 128 condition
//   rows runs the smaller kernel after it, which keeps them in the
//   parameter bank.
// * A routed model (Keskin et al.'s local expert network: a router layer
//   and sibling expert layers, each filtered on one of the router's
//   classes) runs the general kernel's kRouted instantiation: its
//   condition rows (flag, value, layer) move the composite to the layer a
//   row names, so a pixel routed to expert k reads layer k's label.  The
//   filter already keeps every other expert from walking the pixel, so a
//   warp walks each expert that one of its pixels is routed to, its other
//   lanes idle.  That instantiation counts, per layer, the pixels that walk
//   it, the warp tasks that do and their pixel slots (lanes 0-2 of the
//   warp, one atomic instruction a warp and layer), from which the share
//   of lanes a straddled expert keeps busy follows.  A warp that walked
//   anything counts after its last layer, from the labels in its scratch
//   (65535 where a layer did not walk the pixel).  Counting inside the
//   walk's loop cost 1.4-1.5 % of the routed launch on the H100 (spread
//   over 32 copies of the counters or not), and after it in every warp,
//   the four fifths of the batched call's warps that hold no hand among
//   them, 2.7 %.
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
// * A batch of more than 65,535 images (the grid's z limit) is launched in
//   slices of 65,535.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "forest_walk.cuh"

namespace {

constexpr int kLayeredThreads = 256;          // K1's and B1's block: 8
                                              // warps, one label row each
constexpr int kWarps = kLayeredThreads / 32;
constexpr int kMaxLanes = 16;                 // lanes per pixel
constexpr int kMaxLevels = 30;                // 2^levels rows fit an int
constexpr int kMaxImages = 65535;             // images per launch (grid z)
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;              // a block's shared memory
constexpr unsigned kFull = 0xffffffffu;

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

namespace {

// Sums the leaf pdfs of a pixel's walks for the classes c0 + k + q G
// (q < kCls) below `classes`: level by level, the trees of one level in
// tree order (the plain evaluator's order).  ent[t] = (stop level, leaf side
// y) of tree t, y < 0 for a walk that still descends after the last level;
// row(t, y) is the pdf row of that leaf side.
template <int G, int kCls, class Row>
__device__ __forceinline__ void level_sums(float (&acc)[kCls],
                                           const int2* ent, int trees,
                                           int classes, int c0, int k,
                                           Row row) {
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
      const float* pdf = row(t, e.y);
#pragma unroll
      for (int q = 0; q < kCls; ++q) {
        const int c = c0 + k + q * G;
        if (c < classes) {
          const float v = __ldg(pdf + c);
          level_sum[q] = first ? v : __fadd_rn(level_sum[q], v);
        }
      }
      first = false;
    }
#pragma unroll
    for (int q = 0; q < kCls; ++q) {
      if (c0 + k + q * G < classes) acc[q] = __fadd_rn(acc[q], level_sum[q]);
    }
    prev = cur;
  }
}

// Classes per pass: a forest of at most 8 classes sums them in one pass of
// 8 (kMaxC = 8), of at most 16 in one of 16, of more in passes of 16
// (kChunks, the number of passes known only at run time).
template <int kMaxC, bool kChunks>
__device__ __forceinline__ int class_passes(int classes) {
  return kChunks ? (classes + kMaxC - 1) / kMaxC : 1;
}

// The strictly-greater argmax of a pixel's class sums, over all its classes
// in passes of kMaxC: each lane keeps its first maximum (best_c = -1 while
// no sum is above 0.0), then the group's butterfly takes the larger sum,
// the smaller class on a tie.  Every lane of the group gets the class, 0
// when no sum is above 0.0.  Call with the whole warp; `eligible` lanes sum.
template <int G, int kMaxC, bool kChunks, class Row>
__device__ __forceinline__ int argmax_class(bool eligible, const int2* ent,
                                            int trees, int classes, int k,
                                            Row row) {
  constexpr int kCls = (kMaxC + G - 1) / G;
  float best_v = 0.0f;
  int best_c = -1;
  if (eligible) {
    const int passes = class_passes<kMaxC, kChunks>(classes);
    for (int pass = 0; pass < passes; ++pass) {
      const int c0 = pass * kMaxC;
      float acc[kCls];
      level_sums<G, kCls>(acc, ent, trees, classes, c0, k, row);
#pragma unroll
      for (int q = 0; q < kCls; ++q) {
        const int c = c0 + k + q * G;
        if (c < classes && acc[q] > best_v) {
          best_v = acc[q];
          best_c = c;
        }
      }
    }
  }
#pragma unroll
  for (int m = 1; m < G; m <<= 1) {
    const float ov = __shfl_xor_sync(kFull, best_v, m);
    const int oc = __shfl_xor_sync(kFull, best_c, m);
    if (ov > best_v || (ov == best_v && oc < best_c)) {
      best_v = ov;
      best_c = oc;
    }
  }
  return best_c < 0 ? 0 : best_c;
}

// Walks tree t of layer l for the pixel (y, x) of centre depth d.  Returns
// (stop level, leaf side 2 * row + side within the tree), or (levels, -1)
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
    return make_int2(j, 2 * row + side);
  }
  return make_int2(l.levels, -1);
}

// One pixel's scratch: its label of every layer, then its trees' (stop
// level, leaf side).
struct PixelScratch {
  int* lab;
  int2* ent;
};

// Layer li of the layered evaluation for the group's pixel: the walks of
// its trees, then the label, which lane 0 of the group keeps in the
// pixel's scratch.  kWide: the leaf pdfs indexed in 64 bits (a pdf table
// of 2^31 floats or more).  Call with the whole warp.
template <int G, int kMaxC, bool kChunks, bool kWide>
__device__ __forceinline__ void layer_step(
    const B3dLayerDesc& layer, int li, PixelScratch px, bool base_eligible,
    bool inside, int k, const int32_t* __restrict__ img, int h, int w, int y,
    int x, float d, float rd, float scale) {
  bool eligible = base_eligible;
  if (layer.filter_model >= 0) {
    eligible = eligible && px.lab[layer.filter_model] == layer.filter_class;
  }
  if (eligible) {
    for (int t = k; t < layer.trees; t += G) {
      px.ent[t] = walk(layer, t, img, h, w, y, x, d, rd, scale);
    }
  }
  __syncwarp();
  int label = b3d::kMissing;
  if (__any_sync(kFull, eligible)) {
    const int cls = layer.classes;
    using Index = typename std::conditional<kWide, size_t, int>::type;
    const Index tree_rows = 2 * ((Index{1} << layer.levels) - 1);
    const float* pdf = layer.pdf;
    const int c = argmax_class<G, kMaxC, kChunks>(
        eligible, px.ent, layer.trees, cls, k, [&](int t, int s) {
          return pdf + (t * tree_rows + s) * cls;
        });
    if (eligible) label = c;
  }
  if (k == 0 && inside) px.lab[li] = label;
  __syncwarp();
}

// G lanes per pixel.  A block covers a tile of (32 / G) x 8 label pixels,
// warp w the 32 / G pixels of the tile's row w; blockIdx.z is the image.
// Scratch per pixel: `slots` int2, the first (num_layers + 1) / 2 of them
// the pixel's layer labels (as ints), then max_trees (stop level, leaf
// side) entries; in dynamic shared memory, or (kSpill) at pixel oi of
// `spill` (that instantiation also indexes the leaf pdfs in 64 bits).  The
// layer descriptors are read from device memory.  kRouted: a routed model,
// whose condition rows (flag, value, layer) name the layer the composite
// continues at, and whose routing counters (3 per layer) it adds to.
template <int G, int kMinBlocks, int kMaxC, bool kChunks, bool kSpill,
          bool kRouted>
__global__ void __launch_bounds__(kLayeredThreads, kMinBlocks)
evaluate_layered_wide_kernel(const int32_t* __restrict__ depth,
                             int32_t* __restrict__ out, int h, int w, int r,
                             float scale,
                             const B3dLayerDesc* __restrict__ layers,
                             int num_layers, int slots,
                             const int32_t* __restrict__ conditions,
                             int num_cond, int2* __restrict__ spill,
                             unsigned long long* __restrict__ counts) {
  constexpr int kPix = 32 / G;                         // pixels per warp task
  extern __shared__ __align__(16) int2 scratch[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pix = lane / G;
  const int k = lane % G;
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
  const size_t oi = (static_cast<size_t>(img_i) * hl + yl) * wl + xl;
  int2* base = kSpill ? spill + oi * slots
                      : scratch + (warp * kPix + pix) * slots;
  const PixelScratch px{reinterpret_cast<int*>(base),
                        base + (num_layers + 1) / 2};
  const int dc = inside ? __ldg(img + static_cast<size_t>(y) * w + x) : 0;
  const bool base_eligible = dc != 0 && dc != b3d::kMissing;
  const float d = static_cast<float>(dc);
  const float rd = __frcp_rn(d);
  for (int li = 0; li < num_layers; ++li) {
    layer_step<G, kMaxC, kChunks, kSpill>(layers[li], li, px, base_eligible,
                                          inside, k, img, h, w, y, x, d, rd,
                                          scale);
  }
  if (kRouted && __any_sync(kFull, base_eligible)) {
    // the routing counters, from the labels the layers left (a warp with
    // no pixel to walk walked no layer): per layer walked, lanes 0, 1 and
    // 2 add the warp task's pixels that walked it, the task and its pixel
    // slots (one atomic instruction a warp and layer)
    const int lane_c = threadIdx.x & 31;
    for (int li = 0; li < num_layers; ++li) {
      const unsigned walked = __ballot_sync(
          kFull, k == 0 && inside && px.lab[li] != b3d::kMissing);
      if (walked != 0u && lane_c < 3) {
        atomicAdd(counts + 3 * li + lane_c,
                  lane_c == 0 ? static_cast<unsigned long long>(__popc(walked))
                  : lane_c == 1 ? 1ull
                                : static_cast<unsigned long long>(kPix));
      }
    }
  }

  // Conditions walk: row conditions[offset + label - 1] = (0, CLASS) emits
  // CLASS, (1, NEXT) moves on to the next layer at offset NEXT, (1, NEXT,
  // LAYER) (kRouted) to layer LAYER (-1: the next); a label of 0 or 65535,
  // or a row that names no later layer, leaves the pixel unlabelled.
  if (!inside || k != 0) return;
  int result = b3d::kMissing;
  int offset = 0;
  if (kRouted) {
    int li = 0;
    while (li < num_layers) {
      const int l = px.lab[li];
      if (l == 0 || l == b3d::kMissing) break;
      const int row = min(max(offset + l - 1, 0), num_cond - 1);
      const int flag = __ldg(conditions + 3 * row);
      const int val = __ldg(conditions + 3 * row + 1);
      const int named = __ldg(conditions + 3 * row + 2);
      if (flag == 0) {
        result = val;
        break;
      }
      int next = li + 1;
      if (flag == 1) {
        offset = val;
        if (named >= 0) next = named;
      }
      if (next <= li) break;
      li = next;
    }
    out[oi] = result;
    return;
  }
  for (int li = 0; li < num_layers; ++li) {
    const int l = px.lab[li];
    if (l == 0 || l == b3d::kMissing) break;
    const int row = min(max(offset + l - 1, 0), num_cond - 1);
    const int flag = __ldg(conditions + 2 * row);
    const int val = __ldg(conditions + 2 * row + 1);
    if (flag == 0) {
      result = val;
      break;
    }
    if (flag == 1) offset = val;
  }
  out[oi] = result;
}

// K1 for a model of at most kParamLayers layers of at most 16 classes and
// a conditions table of at most kSmallConditions rows (the flagship's
// kind), as the kernel was before the general one above: the layer
// descriptors in the parameter bank (read as operands), the layers
// unrolled with their labels in registers, the conditions in shared
// memory, leaf rows in 32 bits.  The general kernel holds the descriptors'
// fields in registers; on the flagship it took 8 more registers a thread
// at G = 4 and 7 % longer on the batched and golden cases, so the models
// that fit keep this one.
constexpr int kParamLayers = 4;
constexpr int kSmallConditions = 128;
constexpr int kSmallCondBytes = 2 * kSmallConditions * 4;   // static shared

struct LayeredParams {
  B3dLayerDesc layer[kParamLayers];
  int num_layers;
  int max_trees;                  // scratch entries per pixel
};

template <int G, int kMinBlocks, int kMaxC>
__global__ void __launch_bounds__(kLayeredThreads, kMinBlocks)
evaluate_layered_kernel(const int32_t* __restrict__ depth,
                        int32_t* __restrict__ out, int h, int w, int r,
                        float scale, const __grid_constant__ LayeredParams p,
                        const int32_t* __restrict__ conditions,
                        int num_cond) {
  constexpr int kPix = 32 / G;                         // pixels per warp task
  extern __shared__ __align__(16) int2 scratch[];
  __shared__ int s_cond[2 * kSmallConditions];
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

  int labels[kParamLayers];
#pragma unroll
  for (int li = 0; li < kParamLayers; ++li) {
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
    if (!__any_sync(kFull, eligible)) continue;       // labels[li] stays
    const int tree_rows = 2 * ((1 << layer.levels) - 1);
    const int c = argmax_class<G, kMaxC, false>(
        eligible, ent, layer.trees, layer.classes, k, [&](int t, int s) {
          return layer.pdf + (t * tree_rows + s) * layer.classes;
        });
    if (eligible) labels[li] = c;
    __syncwarp();
  }

  // the conditions walk, as the general kernel's
  int result = b3d::kMissing;
  int offset = 0;
#pragma unroll
  for (int li = 0; li < kParamLayers; ++li) {
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

// How a launch holds its scratch: the lanes per pixel, the dynamic shared
// memory of a block, and whether the per-pixel scratch spills to device
// memory.
struct Plan {
  int lanes;
  int smem;
  bool spill;
};

// slots: int2 per pixel; extra(G): a block's other shared bytes at G lanes.
// With lanes == 0 (the kernel's choice) G comes in as `auto_lanes` and is
// doubled while the scratch would pass the default 48 KB; any grouping
// whose scratch does not fit a block runs at 16 lanes, and spills when
// even that does not fit.
template <class Extra>
Plan plan_scratch(int lanes, int auto_lanes, long long slots, Extra extra) {
  const bool chosen = lanes == 0;
  int g = chosen ? auto_lanes : lanes;
  auto smem = [&](int gg) {
    return static_cast<long long>(kWarps) * (32 / gg) * slots * 8 + extra(gg);
  };
  if (chosen) {
    while (smem(g) > kDefaultSmem && g < kMaxLanes) g *= 2;
  }
  if (smem(g) > kMaxSmem) g = kMaxLanes;
  if (smem(g) <= kMaxSmem) return Plan{g, static_cast<int>(smem(g)), false};
  return Plan{g, static_cast<int>(extra(g)), true};
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Raises a kernel's dynamic shared memory limit to a block's whole 227 KB
// (less its static shared bytes) the first time a launch needs more than
// the default 48 KB (once per device, before any graph capture of the
// launch); `raised`: the kernel's own flags, one per device.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, bool (&raised)[64],
                       int static_bytes = 0) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && raised[dev])) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem - static_bytes);
  if (e == cudaSuccess && dev < 64) raised[dev] = true;
  return e;
}

// Per-pixel scratch slots of K1: the layer labels (two per int2), then the
// most trees of a layer.
long long layered_slots(const B3dLayerDesc* layers, int num_layers) {
  int max_trees = 0;
  for (int i = 0; i < num_layers; ++i) {
    max_trees = layers[i].trees > max_trees ? layers[i].trees : max_trees;
  }
  return (num_layers + 1) / 2 + max_trees;
}

Plan plan_layered(int n, int h, int w, int r, const B3dLayerDesc* layers,
                  int num_layers, int lanes) {
  const long long slots = layered_slots(layers, num_layers);
  const long long max_trees = slots - (num_layers + 1) / 2;
  // one lane per tree; where the lanes would fill the card more than 8
  // times over (the batched call's 32 crops), half as many, each lane
  // walking two trees: lanes kept busy then matter more than the chain
  int g = 1;
  while (g < max_trees && g < kMaxLanes) g *= 2;
  const long long pixels = static_cast<long long>(n) * (h / r) * (w / r);
  if (g > 1 && pixels * g > 8LL * sm_count() * 2048) g /= 2;
  Plan p = plan_scratch(lanes, g, slots, [](int) { return 0LL; });
  // a layer whose leaf-pdf table holds 2^31 floats or more takes the
  // spilling instantiation, which indexes it in 64 bits
  for (int i = 0; i < num_layers; ++i) {
    const B3dLayerDesc& l = layers[i];
    if (2LL * l.trees * ((1LL << l.levels) - 1) * l.classes >= (1LL << 31)) {
      p = Plan{kMaxLanes, 0, true};
    }
  }
  return p;
}

template <int G, int kMaxC, bool kChunks, bool kSpill, bool kRouted>
cudaError_t launch_layered(const int32_t* depth, int32_t* out, int n, int h,
                           int w, int r, float scale,
                           const B3dLayerDesc* layers, int num_layers,
                           int slots, const int32_t* conditions, int num_cond,
                           int2* spill, int smem,
                           unsigned long long* counts, cudaStream_t stream) {
  // two lanes per pixel run best with 6 blocks of 256 threads per SM (40
  // registers a thread), the other groupings with what they need
  auto kernel = evaluate_layered_wide_kernel<G, G == 2 ? 6 : 1, kMaxC,
                                             kChunks, kSpill, kRouted>;
  static bool raised[64] = {};
  cudaError_t e = allow_smem(kernel, smem, raised);
  if (e != cudaSuccess) return e;
  const int hl = h / r, wl = w / r;
  for (int i0 = 0; i0 < n; i0 += kMaxImages) {
    const int nz = n - i0 < kMaxImages ? n - i0 : kMaxImages;
    const dim3 grid((wl + 32 / G - 1) / (32 / G), (hl + kWarps - 1) / kWarps, nz);
    kernel<<<grid, kLayeredThreads, smem, stream>>>(
        depth + static_cast<size_t>(i0) * h * w,
        out + static_cast<size_t>(i0) * hl * wl, h, w, r, scale, layers,
        num_layers, slots, conditions, num_cond, spill, counts);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int G, int kMaxC>
cudaError_t launch_layered_small(const int32_t* depth, int32_t* out, int n,
                                 int h, int w, int r, float scale,
                                 const LayeredParams& p,
                                 const int32_t* conditions, int num_cond,
                                 int smem, cudaStream_t stream) {
  auto kernel = evaluate_layered_kernel<G, G == 2 ? 6 : 1, kMaxC>;
  static bool raised[64] = {};
  cudaError_t e = allow_smem(kernel, smem, raised, kSmallCondBytes);
  if (e != cudaSuccess) return e;
  const int hl = h / r, wl = w / r;
  for (int i0 = 0; i0 < n; i0 += kMaxImages) {
    const int nz = n - i0 < kMaxImages ? n - i0 : kMaxImages;
    const dim3 grid((wl + 32 / G - 1) / (32 / G), (hl + kWarps - 1) / kWarps, nz);
    kernel<<<grid, kLayeredThreads, smem, stream>>>(
        depth + static_cast<size_t>(i0) * h * w,
        out + static_cast<size_t>(i0) * hl * wl, h, w, r, scale, p,
        conditions, num_cond);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Whether K1 takes these arguments: at least one layer and one condition
// row, each layer's trees, levels (<= kMaxLevels) and classes positive and
// its filter an earlier layer.
bool layered_args_ok(int r, const B3dLayerDesc* layers, int num_layers,
                     int num_cond) {
  if (num_layers < 1 || num_cond < 1 || r < 1) return false;
  for (int i = 0; i < num_layers; ++i) {
    const B3dLayerDesc& l = layers[i];
    if (l.classes < 1 || l.trees < 1 || l.levels < 1 ||
        l.levels > kMaxLevels || l.filter_model >= i) {
      return false;
    }
  }
  return true;
}

}  // namespace

// int2 entries of device memory that b3d_evaluate_layered needs for these
// arguments (0 when every pixel's scratch fits in shared memory); layers:
// host array of num_layers descriptors; lanes as below.
extern "C" long long b3d_layered_spill(int n, int h, int w, int r,
                                       const B3dLayerDesc* layers,
                                       int num_layers, int lanes) {
  if (n < 1 || r < 1 || num_layers < 1) return 0;
  const Plan p = plan_layered(n, h, w, r, layers, num_layers, lanes);
  if (!p.spill) return 0;
  const long long per_launch = n < kMaxImages ? n : kMaxImages;
  return per_launch * (h / r) * (w / r) * layered_slots(layers, num_layers);
}

namespace {

// The general kernel's launch for the plan p (kRouted: the routed
// instantiation, which adds to `counts`).
template <bool kRouted>
cudaError_t launch_wide(const Plan& p, int max_classes, const int32_t* depth,
                        int32_t* out, int n, int h, int w, int r, float scale,
                        const B3dLayerDesc* layers_dev, int num_layers,
                        int slots, const int32_t* conditions, int num_cond,
                        int2* spill, unsigned long long* counts,
                        cudaStream_t s) {
#define B3D_ARGS                                                               \
  depth, out, n, h, w, r, scale, layers_dev, num_layers, slots, conditions,    \
      num_cond, spill, p.smem, counts, s
#define B3D_PICK(G, SPILL)                                                     \
  (max_classes > 16                                                            \
       ? launch_layered<G, 16, true, SPILL, kRouted>(B3D_ARGS)                 \
   : max_classes > 8 ? launch_layered<G, 16, false, SPILL, kRouted>(B3D_ARGS)  \
                     : launch_layered<G, 8, false, SPILL, kRouted>(B3D_ARGS))
#define B3D_LAUNCH(G)                                                          \
  case G:                                                                      \
    return B3D_PICK(G, false);
  if (p.spill) return B3D_PICK(kMaxLanes, true);
  switch (p.lanes) {
    B3D_LAUNCH(1)
    B3D_LAUNCH(2)
    B3D_LAUNCH(4)
    B3D_LAUNCH(8)
    B3D_LAUNCH(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef B3D_LAUNCH
#undef B3D_PICK
#undef B3D_ARGS
}

int max_layer_classes(const B3dLayerDesc* layers, int num_layers) {
  int max_classes = 0;
  for (int i = 0; i < num_layers; ++i) {
    max_classes = layers[i].classes > max_classes ? layers[i].classes : max_classes;
  }
  return max_classes;
}

}  // namespace

// depth: (n, h, w) int32; out: (n, h / r, w / r) int32; conditions:
// (num_cond, 2) int32; all device pointers.  layers: host array of
// num_layers descriptors, layers_dev the same array in device memory.
// lanes: lanes per pixel (1, 2, 4, 8 or 16; 0 = one per tree, at most 16,
// as the model and the input size suggest).  spill:
// b3d_layered_spill(...) int2 entries of device memory, or null when that
// is 0.  Returns cudaGetLastError() after the launches.
extern "C" int b3d_evaluate_layered(const int32_t* depth, int32_t* out, int n,
                                    int h, int w, int r, float scale,
                                    const B3dLayerDesc* layers,
                                    const B3dLayerDesc* layers_dev,
                                    int num_layers, const int32_t* conditions,
                                    int num_cond, int lanes, int2* spill,
                                    void* stream) {
  if (!layered_args_ok(r, layers, num_layers, num_cond) || n < 0 ||
      layers_dev == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pixels = static_cast<long long>(n) * (h / r) * (w / r);
  if (pixels == 0) return static_cast<int>(cudaSuccess);
  const Plan p = plan_layered(n, h, w, r, layers, num_layers, lanes);
  if (p.spill && spill == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int max_classes = max_layer_classes(layers, num_layers);
  const int slots = static_cast<int>(layered_slots(layers, num_layers));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  const int max_trees = slots - (num_layers + 1) / 2;
  const int small_smem = kWarps * (32 / p.lanes) * max_trees * 8;
  if (!p.spill && num_layers <= kParamLayers && max_classes <= 16 &&
      num_cond <= kSmallConditions &&
      small_smem <= kMaxSmem - kSmallCondBytes) {
    LayeredParams small{};
    small.num_layers = num_layers;
    small.max_trees = max_trees;
    for (int i = 0; i < num_layers; ++i) small.layer[i] = layers[i];
    const int smem = small_smem;
#define B3D_SMALL(G)                                                           \
  case G:                                                                      \
    e = max_classes > 8                                                        \
            ? launch_layered_small<G, 16>(depth, out, n, h, w, r, scale,       \
                                          small, conditions, num_cond, smem, s) \
            : launch_layered_small<G, 8>(depth, out, n, h, w, r, scale, small, \
                                         conditions, num_cond, smem, s);       \
    break;
    switch (p.lanes) {
      B3D_SMALL(1)
      B3D_SMALL(2)
      B3D_SMALL(4)
      B3D_SMALL(8)
      B3D_SMALL(16)
      default:
        e = cudaErrorInvalidValue;
    }
#undef B3D_SMALL
    return static_cast<int>(e);
  }
  return static_cast<int>(launch_wide<false>(
      p, max_classes, depth, out, n, h, w, r, scale, layers_dev, num_layers,
      slots, conditions, num_cond, spill, nullptr, s));
}

// K1 for a routed model, as b3d_evaluate_layered, with conditions
// (num_cond, 3) int32 rows (flag, value, layer) and counts: (num_layers,
// 3) uint64 routing counters in device memory (per layer the pixels that
// walk it, the warp tasks that walk it, their pixel slots), which the
// launch adds to.  Always the general kernel: the parameter kernel reads
// two-column rows only.
extern "C" int b3d_evaluate_layered_routed(
    const int32_t* depth, int32_t* out, int n, int h, int w, int r,
    float scale, const B3dLayerDesc* layers, const B3dLayerDesc* layers_dev,
    int num_layers, const int32_t* conditions, int num_cond, int lanes,
    int2* spill, unsigned long long* counts, void* stream) {
  if (!layered_args_ok(r, layers, num_layers, num_cond) || n < 0 ||
      layers_dev == nullptr || counts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pixels = static_cast<long long>(n) * (h / r) * (w / r);
  if (pixels == 0) return static_cast<int>(cudaSuccess);
  const Plan p = plan_layered(n, h, w, r, layers, num_layers, lanes);
  if (p.spill && spill == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_wide<true>(
      p, max_layer_classes(layers, num_layers), depth, out, n, h, w, r, scale,
      layers_dev, num_layers, static_cast<int>(layered_slots(layers, num_layers)),
      conditions, num_cond, spill, counts, static_cast<cudaStream_t>(stream)));
}

// ---------------------------------------------------------------------------
// B1: one forest (evaluate_forest_cuda).
//
// Replaces the Pallas TPU kernel
// beats3d_tpu/ops/forest_eval_pallas.py:evaluate_forest_pallas (_run_pallas,
// body _make_kernel) and keeps the contract of the plain evaluator
// beats3d_tpu/ops/forest_eval.py:evaluate_forest: labels of one forest of
// any number of trees and classes on the stride-r grid, with an optional
// filter image (evaluate only where it equals filter_class), a probe scale,
// and single-tree semantics (write_all_eligible = 0: write only where every
// tree reached a leaf); the argmax takes the strictly greater class from
// (0.0, class 0), the first maximum; 65535 marks pixels not written.
//
// Bound, as K1, by latency: per level a node read, four probe offsets and
// two depth gathers whose addresses depend on the node; on the golden
// frames only ~10 % of the pixels are eligible, so the chains run in less
// than one wave.  The trainer calls it mostly on one new tree (T = 1),
// read in place in the dense layout (its rows are new at every call; a
// repack would cost a pass of its own).
//
// Design: K1's, on the dense layout.  G lanes per pixel, lane k walking
// trees k, k + G, ... (one lane per tree up to 16, halved while the lanes
// would fill the card more than 4 times over: on 848x480 frames at r = 1
// most pixels are ineligible, and idle lanes cost more than the chain); a
// block covers (32 / G) x 8 label pixels, one row per warp; each lane
// writes its trees' (stop level, leaf side) to a per-pixel scratch (in
// shared memory, sized and spilled as K1's) and then sums its classes
// k, k + G, ... level by level, in tree order within a level (the plain
// order, so the float32 sums and an argmax near a tie are the plain
// evaluator's bit for bit), in chunks of 16 classes past 16; the group's
// argmax is a shuffle butterfly that takes the smaller class on a tie.
// No per-thread array is indexed at run time (a pdf pointer and a stop
// level per tree would take 192 bytes of local memory), and the class sums
// are sized to the forest (8 or 16).
//
// Pdf-sum mode (kPdfSum, entry b3d_forest_pdf_sum): the same walk, scratch
// and level-order sums, with the argmax epilogue replaced by the sums
// themselves, for a forest sharded by trees (the counterpart of the
// per-shard beats3d_tpu/ops/forest_eval.py:forest_pdf_sum that JAX's
// beats3d_tpu/parallel/eval_sharded.py combines with one psum).  What
// bounds it is the store: the (N, H/r, W/r, C) float32 sums are 22.8 MB on
// the golden frames at r = 1, some 7 us at 3.35 TB/s, against ~1 us of
// walks.  A warp's (32 / G) pixels have consecutive outputs, so each
// pass of classes is staged per warp in shared memory (row-major, the
// pixel's classes side by side, placed at dst's offset within its 16-byte
// line) and the warp writes its (32 / G) x C floats back as 16-byte stores
// from consecutive lanes; an ineligible pixel's zeros go out the same way,
// and the eligibility and all-trees-done bytes are staged and written as
// 16-byte vectors too.  A warp with no eligible pixel (most of them on the
// golden frames) skips the staging and fills its rows directly.  (Each
// thread storing its own pixel's sums touched some 7x the L2 sectors that
// the bytes need.)  The mode is held to 64 registers a thread.  An
// ineligible pixel is not walked: its sums are 0 and its done byte 1 (the
// plain version walks it, and its callers never read it there).

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

// A warp's copy of count elements from its staging buffer to dst, with
// consecutive lanes on consecutive addresses: the elements before dst's
// first 16-byte boundary one by one, then 16-byte vectors, then the rest.
// The staging buffer (16-byte aligned) holds element e at src[mis + e],
// mis = dst's element offset within its 16-byte line, so that the vectors
// read it aligned.
template <class E>
__device__ __forceinline__ void warp_store(E* dst, const E* src, int mis,
                                           int count, int lane) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(E));
  int head = (kVec - mis) % kVec;
  head = head < count ? head : count;
  if (lane < head) dst[lane] = src[mis + lane];
  const int body = (count - head) / kVec;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + mis + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
#pragma unroll 1
  for (int i = lane; i < body; i += 32) d4[i] = s4[i];
#pragma unroll 1
  for (int e = head + body * kVec + lane; e < count; e += 32) {
    dst[e] = src[mis + e];
  }
}

// dst's element offset within its 16-byte line.
template <class E>
__device__ __forceinline__ int line_offset(const E* dst) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(E));
}

// A warp's fill of count elements of dst with v, as warp_store writes
// them (for a warp with no pixel walked, which needs no staging).
template <class E>
__device__ __forceinline__ void warp_fill(E* dst, E v, int count, int lane) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(E));
  union {
    E e[kVec];
    uint4 u;
  } pack;
#pragma unroll
  for (int i = 0; i < kVec; ++i) pack.e[i] = v;
  int head = (kVec - line_offset(dst)) % kVec;
  head = head < count ? head : count;
  if (lane < head) dst[lane] = v;
  const int body = (count - head) / kVec;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
#pragma unroll 1
  for (int i = lane; i < body; i += 32) d4[i] = pack.u;
#pragma unroll 1
  for (int e = head + body * kVec + lane; e < count; e += 32) dst[e] = v;
}

// Pdf-sum mode's staging per warp: kPix x kMaxC floats and 4 of padding,
// then two kStageBytes-byte lines for the eligibility and done bytes.
constexpr int kStageBytes = 48;              // 32 pixels + 16 of padding

__host__ __device__ constexpr int stage_floats(int pix, int max_c) {
  return pix * max_c + 4;
}

// Pdf-sum mode is held to 64 registers a thread (4 blocks an SM): left
// free, ptxas gave its epilogue 110-120 and the walks lost half their
// occupancy.
template <int G, int kMaxC, bool kChunks, bool kPdfSum, bool kSpill>
__global__ void __launch_bounds__(kLayeredThreads, kPdfSum ? 4 : 1)
evaluate_forest_kernel(const int32_t* __restrict__ depth,
                       int32_t* __restrict__ out, int h, int w, int r,
                       float scale, const float* __restrict__ forest,
                       int trees, int levels, int classes,
                       const int32_t* __restrict__ filter, int filter_class,
                       int write_all_eligible, float* __restrict__ pdf_out,
                       uint8_t* __restrict__ eligible_out,
                       uint8_t* __restrict__ done_out,
                       int2* __restrict__ spill) {
  constexpr int kPix = 32 / G;
  constexpr int kCls = (kMaxC + G - 1) / G;
  extern __shared__ __align__(16) int2 scratch[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pix = lane / G;
  const int k = lane % G;
  const int hl = h / r;
  const int wl = w / r;
  const int yl = blockIdx.y * kWarps + warp;
  if (yl >= hl) return;                                // the whole warp

  const int x0 = blockIdx.x * kPix;                    // the warp's first
  const int xl = x0 + pix;
  const bool inside = xl < wl;
  const int32_t* img = depth + static_cast<size_t>(blockIdx.z) * h * w;
  const int y = yl * r;
  const int x = xl * r;
  const size_t o0 = (static_cast<size_t>(blockIdx.z) * hl + yl) * wl + x0;
  const size_t oi = o0 + pix;
  // the scratch entries of the block, rounded to 16 bytes
  const int entries = kSpill ? 0 : (kWarps * kPix * trees + 1) & ~1;
  int2* ent = kSpill ? spill + oi * trees
                     : scratch + (warp * kPix + pix) * trees;
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
    done = __shfl_xor_sync(kFull, static_cast<int>(done), m) && done;
  }
  const bool write = eligible && (write_all_eligible || done);
  __syncwarp();
  auto row = [&](int t, int s) {
    return forest + (t * nodes + (s >> 1)) * els + 7 + (s & 1) * classes;
  };
  if constexpr (!kPdfSum) {
    int best_c = 0;
    if (__any_sync(kFull, write)) {
      best_c = argmax_class<G, kMaxC, kChunks>(write, ent, trees, classes, k,
                                               row);
    }
    if (inside && k == 0) out[oi] = write ? best_c : b3d::kMissing;
  } else {
    float* stage = reinterpret_cast<float*>(scratch + entries) +
                   warp * stage_floats(kPix, kMaxC);
    uint8_t* stage_b =
        reinterpret_cast<uint8_t*>(reinterpret_cast<float*>(scratch + entries) +
                                   kWarps * stage_floats(kPix, kMaxC)) +
        warp * 2 * kStageBytes;
    const int npix = wl - x0 < kPix ? wl - x0 : kPix;  // the warp's, inside
    if (!__any_sync(kFull, write)) {
      // no pixel of the warp was walked: sums 0, eligibility 0, done 1
      warp_fill(pdf_out + o0 * classes, 0.0f, npix * classes, lane);
      warp_fill(eligible_out + o0, uint8_t{0}, npix, lane);
      warp_fill(done_out + o0, uint8_t{1}, npix, lane);
      return;
    }
    const int passes = class_passes<kMaxC, kChunks>(classes);
#pragma unroll 1
    for (int pass = 0; pass < passes; ++pass) {
      // one pass's classes: all of them (contiguous per warp), or a chunk
      // of 16 (rows of 16 floats, `classes` apart)
      const int c0 = pass * kMaxC;
      const int cw = kChunks ? min(kMaxC, classes - c0) : classes;
      float acc[kCls];
#pragma unroll
      for (int q = 0; q < kCls; ++q) acc[q] = 0.0f;
      if (write) level_sums<G, kCls>(acc, ent, trees, classes, c0, k, row);
      float* dst = pdf_out + o0 * classes + c0;
      const int mis = kChunks ? 0 : line_offset(dst);
#pragma unroll
      for (int q = 0; q < kCls; ++q) {
        const int j = k + q * G;
        if (j < cw) stage[mis + pix * cw + j] = acc[q];
      }
      __syncwarp();
      if (!kChunks) {
        warp_store(dst, stage, mis, npix * cw, lane);
      } else {
        for (int e = lane; e < npix * cw; e += 32) {
          const int p = e / cw;
          dst[static_cast<size_t>(p) * classes + (e - p * cw)] = stage[e];
        }
      }
      __syncwarp();
    }
    const int mis_e = line_offset(eligible_out + o0);
    const int mis_d = line_offset(done_out + o0);
    if (k == 0) {
      stage_b[mis_e + pix] = eligible ? 1 : 0;
      stage_b[kStageBytes + mis_d + pix] = done ? 1 : 0;  // 1 where not walked
    }
    __syncwarp();
    warp_store(eligible_out + o0, stage_b, mis_e, npix, lane);
    warp_store(done_out + o0, stage_b + kStageBytes, mis_d, npix, lane);
  }
}

// Label mode writes out; pdf-sum mode writes the three arrays of sums.
struct ForestSums {
  float* pdf;
  uint8_t* eligible;
  uint8_t* done;
};

template <int G, int kMaxC, bool kChunks, bool kPdfSum, bool kSpill>
cudaError_t launch_forest(const int32_t* depth, int32_t* out, ForestSums sums,
                          int n, int h, int w, int r, float scale,
                          const float* forest, int trees, int levels,
                          int classes, const int32_t* filter,
                          int filter_class, int write_all_eligible,
                          int2* spill, int smem, cudaStream_t stream) {
  auto kernel = evaluate_forest_kernel<G, kMaxC, kChunks, kPdfSum, kSpill>;
  static bool raised[64] = {};
  cudaError_t e = allow_smem(kernel, smem, raised);
  if (e != cudaSuccess) return e;
  const int hl = h / r, wl = w / r;
  for (int i0 = 0; i0 < n; i0 += kMaxImages) {
    const int nz = n - i0 < kMaxImages ? n - i0 : kMaxImages;
    const size_t o = static_cast<size_t>(i0) * hl * wl;
    const dim3 grid((wl + 32 / G - 1) / (32 / G), (hl + kWarps - 1) / kWarps, nz);
    kernel<<<grid, kLayeredThreads, smem, stream>>>(
        depth + static_cast<size_t>(i0) * h * w, out ? out + o : nullptr, h,
        w, r, scale, forest, trees, levels, classes,
        filter ? filter + o : nullptr, filter_class, write_all_eligible,
        sums.pdf ? sums.pdf + o * classes : nullptr,
        sums.eligible ? sums.eligible + o : nullptr,
        sums.done ? sums.done + o : nullptr, spill);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

Plan plan_forest(int n, int h, int w, int r, int trees, int classes,
                 bool pdf, int lanes) {
  int g = 1;
  while (g < trees && g < kMaxLanes) g *= 2;
  const long long pixels = static_cast<long long>(n) * (h / r) * (w / r);
  const long long fill = 4LL * sm_count() * 2048;
  while (g > 1 && pixels * g > fill) g /= 2;
  const int max_c = classes > 8 ? 16 : 8;
  return plan_scratch(lanes, g, trees, [&](int gg) {
    // 16 bytes of rounding after the entries, then the staging
    return pdf ? 16LL + kWarps * (4LL * stage_floats(32 / gg, max_c) +
                                  2 * kStageBytes)
               : 0LL;
  });
}

bool forest_args_ok(int r, int trees, int levels, int classes) {
  return trees >= 1 && classes >= 1 && levels >= 1 && levels <= kMaxLevels &&
         r >= 1;
}

// Checks the arguments, plans the lanes per pixel and the scratch, and
// launches B1 in label mode (sums.pdf null) or in pdf-sum mode.
int run_forest(const int32_t* depth, int32_t* out, ForestSums sums, int n,
               int h, int w, int r, float scale, const float* forest,
               int trees, int levels, int classes, const int32_t* filter,
               int filter_class, int write_all_eligible, int lanes,
               int2* spill, void* stream) {
  if (!forest_args_ok(r, trees, levels, classes) || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pixels = static_cast<long long>(n) * (h / r) * (w / r);
  if (pixels == 0) return static_cast<int>(cudaSuccess);
  const bool pdf = sums.pdf != nullptr;
  const Plan p = plan_forest(n, h, w, r, trees, classes, pdf, lanes);
  if (p.spill && spill == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define B3D_ARGS                                                               \
  depth, out, sums, n, h, w, r, scale, forest, trees, levels, classes, filter, \
      filter_class, write_all_eligible, spill, p.smem, s
#define B3D_MODE(G, C, CHUNKS, SPILL)                                          \
  (pdf ? launch_forest<G, C, CHUNKS, true, SPILL>(B3D_ARGS)                    \
       : launch_forest<G, C, CHUNKS, false, SPILL>(B3D_ARGS))
#define B3D_PICK(G, SPILL)                                                     \
  (classes > 16  ? B3D_MODE(G, 16, true, SPILL)                                \
   : classes > 8 ? B3D_MODE(G, 16, false, SPILL)                               \
                 : B3D_MODE(G, 8, false, SPILL))
#define B3D_FOREST(G)                                                          \
  case G:                                                                      \
    e = B3D_PICK(G, false);                                                    \
    break;
  if (p.spill) {
    e = B3D_PICK(kMaxLanes, true);
  } else {
    switch (p.lanes) {
      B3D_FOREST(1)
      B3D_FOREST(2)
      B3D_FOREST(4)
      B3D_FOREST(8)
      B3D_FOREST(16)
      default:
        e = cudaErrorInvalidValue;
    }
  }
#undef B3D_FOREST
#undef B3D_PICK
#undef B3D_MODE
#undef B3D_ARGS
  return static_cast<int>(e);
}

}  // namespace

// int2 entries of device memory that b3d_evaluate_forest (pdf = 0) or
// b3d_forest_pdf_sum (pdf = 1, lanes 0) needs for these arguments: 0 when
// every pixel's scratch fits in shared memory.
extern "C" long long b3d_forest_spill(int n, int h, int w, int r, int trees,
                                      int classes, int pdf, int lanes) {
  if (n < 1 || r < 1 || trees < 1 || classes < 1) return 0;
  const Plan p = plan_forest(n, h, w, r, trees, classes, pdf != 0, lanes);
  if (!p.spill) return 0;
  const long long per_launch = n < kMaxImages ? n : kMaxImages;
  return per_launch * (h / r) * (w / r) * trees;
}

// depth: (n, h, w) int32; out: (n, h / r, w / r) int32; forest: (trees,
// 2^levels - 1, 7 + 2 * classes) float32; filter: (n, h / r, w / r) int32 or
// null; all device pointers.  lanes: lanes per pixel (1, 2, 4, 8 or 16; 0 =
// one per tree up to 16, halved while the lanes would fill the card more
// than 4 times over).  spill: b3d_forest_spill(..., 0, lanes) int2 entries
// of device memory, or null when that is 0.  Returns cudaGetLastError()
// after the launches.
extern "C" int b3d_evaluate_forest(const int32_t* depth, int32_t* out, int n,
                                   int h, int w, int r, float scale,
                                   const float* forest, int trees, int levels,
                                   int classes, const int32_t* filter,
                                   int filter_class, int write_all_eligible,
                                   int lanes, int2* spill, void* stream) {
  return run_forest(depth, out, ForestSums{nullptr, nullptr, nullptr}, n, h,
                    w, r, scale, forest, trees, levels, classes, filter,
                    filter_class, write_all_eligible, lanes, spill, stream);
}

// B1's pdf-sum mode.  depth: (n, h, w) int32; pdf: (n, h / r, w / r,
// classes) float32; eligible, all_done: (n, h / r, w / r) uint8 (0 or 1);
// forest as above; all device pointers; the lanes per pixel are the label
// mode's default; spill: b3d_forest_spill(..., 1, 0) entries or null.
// Returns cudaGetLastError() after the launches.
extern "C" int b3d_forest_pdf_sum(const int32_t* depth, float* pdf,
                                  uint8_t* eligible, uint8_t* all_done, int n,
                                  int h, int w, int r, float scale,
                                  const float* forest, int trees, int levels,
                                  int classes, int2* spill, void* stream) {
  if (pdf == nullptr || eligible == nullptr || all_done == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run_forest(depth, nullptr, ForestSums{pdf, eligible, all_done}, n, h,
                    w, r, scale, forest, trees, levels, classes, nullptr, -1,
                    1, 0, spill, stream);
}

// Message of a cudaError_t returned by the entries above.
extern "C" const char* b3d_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
