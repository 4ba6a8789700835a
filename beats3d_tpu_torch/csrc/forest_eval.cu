// Decision-forest evaluation kernels:
//
// * K1, evaluate_layered_kernel (evaluate_layered_cuda): every layer of a
//   layered forest plus the conditions composite;
// * B1, evaluate_forest_kernel (evaluate_forest_cuda): one forest, at the
//   end of this file.
//
// Replaces the Pallas TPU kernel
// beats3d_tpu/ops/forest_eval_pallas.py:evaluate_layered_pallas
// (_run_layered_pallas, body _make_layered_kernel).  It keeps that kernel's
// contract, not its TPU design: the packed row pairs, needed-set probe
// sweeps and lane shuffles exist because Mosaic has no per-lane gather;
// Hopper gathers per thread through the read-only cache.
//
// Design: one thread per label pixel (n, yl, xl).  The thread walks every
// layer in order; a filtered layer runs only where the thread's own label
// of the filter layer equals the filter class.  Per layer it walks the trees
// in order from the root over the dense reference layout, sums the leaf pdfs
// in tree order, and takes the strictly-greater argmax from (0.0, class 0).
// Then it walks the conditions table, staged in shared memory, and writes
// the composite label (65535 = unlabelled).
//
// What bounds it on the H100: dependent gathers and their latency.  Each
// tree level is a node read whose address depends on the previous level's
// branch, then two depth probes whose addresses depend on the node; there
// is almost no arithmetic.  The design answers with occupancy and caches:
// small blocks of 32x8 label pixels, few registers, so many warps hide each
// other's latency; node rows and depth are read through __ldg; the flagship
// fine forest (4 x 65535 x 21 float32, 22 MB) stays resident in the 50 MB
// L2, so a dense table needs no repacking; neighbouring threads walk the
// same upper tree levels, so their node reads coalesce.  Ineligible pixels
// (missing depth, outside the hand stencil) return after one load.

#include <cstdint>

#include <cuda_runtime.h>

#include "forest_walk.cuh"

namespace {

constexpr int kMaxLayers = 4;
constexpr int kMaxClasses = 16;
constexpr int kMaxConditions = 128;
constexpr int kMaxTrees = 16;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

}  // namespace

// One layer, as the Python wrapper passes it (ctypes mirrors this layout).
struct B3dLayerDesc {
  const float* forest;  // (trees, 2^levels - 1, 7 + 2 * classes) float32
  int trees;
  int levels;
  int classes;
  int filter_model;     // earlier layer index, or -1
  int filter_class;
};

struct LayeredParams {
  B3dLayerDesc layer[kMaxLayers];
  int num_layers;
};

__global__ void __launch_bounds__(kBlockX * kBlockY)
evaluate_layered_kernel(const int32_t* __restrict__ depth,
                        int32_t* __restrict__ out, int h, int w, int r,
                        float scale, LayeredParams p,
                        const int32_t* __restrict__ conditions,
                        int num_cond) {
  __shared__ int s_cond[2 * kMaxConditions];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 2 * num_cond; i += blockDim.x * blockDim.y) {
    s_cond[i] = conditions[i];
  }
  __syncthreads();

  const int hl = h / r;
  const int wl = w / r;
  const int xl = blockIdx.x * blockDim.x + threadIdx.x;
  const int yl = blockIdx.y * blockDim.y + threadIdx.y;
  if (xl >= wl || yl >= hl) return;
  const int32_t* img = depth + static_cast<size_t>(blockIdx.z) * h * w;
  const int y = yl * r;
  const int x = xl * r;
  const int dc = __ldg(img + static_cast<size_t>(y) * w + x);
  const bool base_eligible = dc != 0 && dc != b3d::kMissing;
  const float d = static_cast<float>(dc);

  int labels[kMaxLayers];
#pragma unroll
  for (int li = 0; li < kMaxLayers; ++li) {
    labels[li] = b3d::kMissing;
    if (li >= p.num_layers || !base_eligible) continue;
    const B3dLayerDesc layer = p.layer[li];
    if (layer.filter_model >= 0) {
      int filter_label = labels[0];
#pragma unroll
      for (int q = 1; q < li; ++q) {
        if (q == layer.filter_model) filter_label = labels[q];
      }
      if (filter_label != layer.filter_class) continue;
    }
    float acc[kMaxClasses];
#pragma unroll
    for (int k = 0; k < kMaxClasses; ++k) acc[k] = 0.0f;
    const size_t tree_stride =
        static_cast<size_t>((1 << layer.levels) - 1) * (7 + 2 * layer.classes);
    for (int t = 0; t < layer.trees; ++t) {
      const float* pdf = b3d::walk_tree(layer.forest + t * tree_stride,
                                        layer.levels, layer.classes, img, h,
                                        w, y, x, d, scale);
      if (pdf == nullptr) continue;
#pragma unroll
      for (int k = 0; k < kMaxClasses; ++k) {
        if (k < layer.classes) acc[k] = __fadd_rn(acc[k], __ldg(pdf + k));
      }
    }
    float best = 0.0f;
    int best_c = 0;
#pragma unroll
    for (int k = 0; k < kMaxClasses; ++k) {
      if (k < layer.classes && acc[k] > best) {
        best = acc[k];
        best_c = k;
      }
    }
    labels[li] = best_c;
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
  out[(static_cast<size_t>(blockIdx.z) * hl + yl) * wl + xl] = result;
}

// depth: (n, h, w) int32; out: (n, h / r, w / r) int32; conditions:
// (num_cond, 2) int32; all device pointers.  layers: host array of
// num_layers descriptors.  Returns cudaGetLastError() after the launch.
extern "C" int b3d_evaluate_layered(const int32_t* depth, int32_t* out, int n,
                                    int h, int w, int r, float scale,
                                    const B3dLayerDesc* layers, int num_layers,
                                    const int32_t* conditions, int num_cond,
                                    void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || num_cond < 1 ||
      num_cond > kMaxConditions || r < 1 || n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LayeredParams p;
  for (int i = 0; i < kMaxLayers; ++i) {
    if (i < num_layers) {
      p.layer[i] = layers[i];
      if (layers[i].classes < 1 || layers[i].classes > kMaxClasses ||
          layers[i].filter_model >= i) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    } else {
      p.layer[i] = B3dLayerDesc{nullptr, 0, 0, 0, -1, 0};
    }
  }
  p.num_layers = num_layers;
  const int hl = h / r;
  const int wl = w / r;
  if (n == 0 || hl == 0 || wl == 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((wl + kBlockX - 1) / kBlockX, (hl + kBlockY - 1) / kBlockY, n);
  evaluate_layered_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      depth, out, h, w, r, scale, p, conditions, num_cond);
  return static_cast<int>(cudaGetLastError());
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
// (write_all_eligible = 0: write only where every tree reached a leaf).
//
// Design: one thread per label pixel walks every tree with walk_tree_level
// and records each tree's leaf pdf and the level it stopped at.  The pdfs
// are then summed in the plain evaluator's order, level by level and in
// tree order within a level, so the float32 sums, and with them an argmax
// near a tie, are the plain evaluator's bit for bit (the trainer picks trees
// by the labels this kernel writes).  The argmax takes the strictly greater
// class from (0.0, class 0), the first maximum; 65535 marks pixels not
// written.  Bound, as K1, by dependent gathers (node row, then two depth
// probes per level); occupancy hides their latency, the node rows and depth
// go through the read-only cache, and a D=16 forest stays in the 50 MB L2.
// Ineligible pixels return after one or two loads.

__global__ void __launch_bounds__(kBlockX * kBlockY)
evaluate_forest_kernel(const int32_t* __restrict__ depth,
                       int32_t* __restrict__ out, int h, int w, int r,
                       float scale, const float* __restrict__ forest,
                       int trees, int levels, int classes,
                       const int32_t* __restrict__ filter, int filter_class,
                       int write_all_eligible) {
  const int hl = h / r;
  const int wl = w / r;
  const int xl = blockIdx.x * blockDim.x + threadIdx.x;
  const int yl = blockIdx.y * blockDim.y + threadIdx.y;
  if (xl >= wl || yl >= hl) return;
  const size_t oi = (static_cast<size_t>(blockIdx.z) * hl + yl) * wl + xl;
  const int32_t* img = depth + static_cast<size_t>(blockIdx.z) * h * w;
  const int y = yl * r;
  const int x = xl * r;
  const int dc = __ldg(img + static_cast<size_t>(y) * w + x);
  bool eligible = dc != 0 && dc != b3d::kMissing;
  if (eligible && filter != nullptr) eligible = __ldg(filter + oi) == filter_class;
  if (!eligible) {
    out[oi] = b3d::kMissing;
    return;
  }
  const float d = static_cast<float>(dc);

  const size_t tree_stride =
      static_cast<size_t>((1 << levels) - 1) * (7 + 2 * classes);
  const float* pdf[kMaxTrees];
  int stop[kMaxTrees];
  bool all_done = true;
  for (int t = 0; t < trees; ++t) {
    pdf[t] = b3d::walk_tree_level(forest + t * tree_stride, levels, classes,
                                  img, h, w, y, x, d, scale, &stop[t]);
    all_done = all_done && pdf[t] != nullptr;
  }
  if (!write_all_eligible && !all_done) {
    out[oi] = b3d::kMissing;
    return;
  }

  float acc[kMaxClasses];
#pragma unroll
  for (int k = 0; k < kMaxClasses; ++k) acc[k] = 0.0f;
  for (int j = 0; j < levels; ++j) {
    float level_sum[kMaxClasses];
    bool any = false;
    for (int t = 0; t < trees; ++t) {
      if (pdf[t] == nullptr || stop[t] != j) continue;
#pragma unroll
      for (int k = 0; k < kMaxClasses; ++k) {
        if (k < classes) {
          const float v = __ldg(pdf[t] + k);
          level_sum[k] = any ? __fadd_rn(level_sum[k], v) : v;
        }
      }
      any = true;
    }
    if (!any) continue;
#pragma unroll
    for (int k = 0; k < kMaxClasses; ++k) {
      if (k < classes) acc[k] = __fadd_rn(acc[k], level_sum[k]);
    }
  }
  float best = 0.0f;
  int best_c = 0;
#pragma unroll
  for (int k = 0; k < kMaxClasses; ++k) {
    if (k < classes && acc[k] > best) {
      best = acc[k];
      best_c = k;
    }
  }
  out[oi] = best_c;
}

// depth: (n, h, w) int32; out: (n, h / r, w / r) int32; forest: (trees,
// 2^levels - 1, 7 + 2 * classes) float32; filter: (n, h / r, w / r) int32 or
// null; all device pointers.  Returns cudaGetLastError() after the launch.
extern "C" int b3d_evaluate_forest(const int32_t* depth, int32_t* out, int n,
                                   int h, int w, int r, float scale,
                                   const float* forest, int trees, int levels,
                                   int classes, const int32_t* filter,
                                   int filter_class, int write_all_eligible,
                                   void* stream) {
  if (trees < 1 || trees > kMaxTrees || classes < 1 || classes > kMaxClasses ||
      levels < 1 || levels > 30 || r < 1 || n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hl = h / r;
  const int wl = w / r;
  if (n == 0 || hl == 0 || wl == 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((wl + kBlockX - 1) / kBlockX, (hl + kBlockY - 1) / kBlockY, n);
  evaluate_forest_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      depth, out, h, w, r, scale, forest, trees, levels, classes, filter,
      filter_class, write_all_eligible);
  return static_cast<int>(cudaGetLastError());
}

// Message of a cudaError_t returned by the entries above.
extern "C" const char* b3d_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
