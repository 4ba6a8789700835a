// Connected components to their fixpoint on the device: label_components.
//
// Replaces no pallas_call: it is the counterpart of the lax.while_loop of
// beats3d_tpu/ops/components.py:label_components (:101-124), which XLA runs
// on the TPU as a loop whose condition never leaves the device.  The plain
// version, ops/components.label_components_plain, runs the same rounds
// eagerly and reads its fixpoint test on the host once per round.
//
// Contract: for each (h, w) image of a mask batch, the 4-connected
// component labels: a mask pixel gets the minimum linear index of its
// component, a background pixel h * w.  That answer does not depend on the
// order in which the work is done, so this kernel equals the plain loop
// bit for bit.
//
// What bounds it on the H100.  The bytes are few: the app's 1/8 mipmap is
// 60x106, a 6.4 KB mask in and 51 KB of int64 labels out, some 17 ns at
// 3.35 TB/s.  What costs is the chain of rounds: each round reads the
// labels its previous round wrote, so the rounds follow each other, and
// one image is too small to fill more than one SM.
//
// Design.
// * One block of 1024 threads per image; the labels live in shared memory
//   (60x106 int32 is 25.4 KB; an image of more than kMaxPixels pixels is
//   refused, never sent elsewhere).  A frame batch runs one block per
//   frame, side by side.
// * A round: each thread takes its pixels in turn, reads the smallest
//   label among the pixel and its 4 neighbours, follows that label's chain
//   to its root (labels only ever point at smaller indices of the same
//   component), does the same for the pixel's own label, and hooks the
//   larger of the two roots under the smaller (atomicMin), then lowers its
//   pixel's label to the smaller root.  Every write is an atomicMin, so a
//   label only decreases and always names a pixel of its own component,
//   whatever order the threads run in.
// * Rounds repeat until one in which no thread lowered any label
//   (__syncthreads_or over the block).  In such a round every pixel's label
//   is its own root and no larger than its neighbours', so each component
//   holds one label, the root, and the component's smallest index m is
//   that root (its label is at most m and names a pixel of the component).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kDefaultSmem = 48 * 1024;
// A block's shared memory on the H100 (227 KB), one int32 label a pixel.
constexpr int kMaxSmem = 232448;
constexpr int kMaxPixels = kMaxSmem / 4;

__device__ __forceinline__ int root_of(volatile int* lab, int r) {
  for (int next = lab[r]; next < r; next = lab[r]) r = next;
  return r;
}

__global__ void __launch_bounds__(kThreads)
    label_components_kernel(const uint8_t* __restrict__ mask,
                            int64_t* __restrict__ out, int h, int w) {
  extern __shared__ int lab_smem[];
  volatile int* lab = lab_smem;
  const int n = h * w;
  const uint8_t* m = mask + static_cast<size_t>(blockIdx.x) * n;
  int64_t* o = out + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) lab[i] = m[i] ? i : n;

  bool lowered = true;
  while (__syncthreads_or(lowered)) {
    lowered = false;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int cur = lab[i];
      if (cur == n) continue;                   // background
      const int y = i / w;
      const int x = i - y * w;
      // background neighbours hold n, larger than any label
      int best = cur;
      if (x > 0) best = min(best, lab[i - 1]);
      if (x + 1 < w) best = min(best, lab[i + 1]);
      if (y > 0) best = min(best, lab[i - w]);
      if (y + 1 < h) best = min(best, lab[i + w]);
      const int ra = root_of(lab, best);
      const int rb = root_of(lab, cur);
      const int lo = min(ra, rb);
      const int hi = max(ra, rb);
      if (lo < hi && atomicMin(lab_smem + hi, lo) > lo) lowered = true;
      if (lo < cur && atomicMin(lab_smem + i, lo) > lo) lowered = true;
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = lab[i];
}

}  // namespace

// mask: (b, h, w) uint8 (0 or 1) device; out: (b, h, w) int64 device.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// an image of more than kMaxPixels pixels (components.MAX_PIXELS).
extern "C" int b3d_label_components(const uint8_t* mask, int64_t* out, int b,
                                    int h, int w, void* stream) {
  if (b < 0 || h < 0 || w < 0 ||
      static_cast<long long>(h) * w > kMaxPixels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  const int smem = h * w * 4;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        label_components_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  label_components_kernel<<<b, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(mask, out,
                                                                 h, w);
  return static_cast<int>(cudaGetLastError());
}
