// The frame's grouping stage in one launch: hand_groups.
//
// Replaces no pallas_call.  It is the counterpart of three pieces of the
// JAX frame program that XLA compiles into the frame's one program on the
// TPU: the lax.while_loop of label_components
// (beats3d_tpu/ops/components.py:57-124), the XLA selection of
// make_hand_groups (:127-202) and points.grow_groups
// (beats3d_tpu/ops/points.py:176).  The plain version is
// ops/components.hand_groups_grown_plain: shrink_image -> make_hand_groups
// (label_components_plain, float32 scatter sums, argmax) -> grow_groups.
//
// Contract, for each image of a (b, H, W) int32 depth batch read at stride
// (the image is depth[::f, ::f], h x w, n = h * w pixels):
// * labels: a mask pixel (depth > 0) gets the minimum linear index of its
//   4-connected component, a background pixel n;
// * per root, the size and the sums of x and y, as exact integers: the
//   plain version's float32 scatter sums are the same integers while they
//   stay below 2^24 (the sum of x over an image is at most n (w - 1) / 2,
//   so for every image up to kBlockPixels whose sides are at most 578);
// * selection: a component survives when size / n > pct (IEEE division,
//   strictly greater); the right hand is the largest survivor whose
//   centroid x (sum / size, IEEE) is below w / 2, the left the largest of
//   the rest; equal sizes go to the smaller root (argmax's first maximum);
//   a side with no survivor is slot 0 with size 0, whose centroid is that
//   of the component rooted at pixel 0, or 0 when pixel 0 is background;
// * outputs, by mode: the labels (int64); or groups (int32: 1 right, 2
//   left, 0 elsewhere), g_info (2, 3) float32 (size, cx, cy) per side and,
//   in the stage mode, grown (the empty pixels take the first non-zero
//   group of their left, right, up and down neighbours).
// Every step is exact or order-free, so the kernel equals the plain
// composition bit for bit.
//
// What bounds it on the H100.  The bytes are few: the live frame's 1/8
// mipmap is 60x106, 25 KB of int32 depth in (one value per 32-byte sector,
// as the image is read at stride 8) and 51 KB of grown and groups out,
// some 23 ns at 3.35 TB/s.  What costs is latency: one image fills one SM
// at most, and the stage is a chain of dependent steps (the merge's labels
// feed the sums, the sums the selection, the selection the groups), each
// a block-wide pass over shared memory whose time is set by the
// instructions the SM's four schedulers dispatch for every pixel and by the
// dependent reads and atomics of the unions and finds.  The JAX stage on
// the card ran as one union-find launch looping to a fixpoint and some 75
// small PyTorch operations around it.
//
// Design: one block of 1024 threads per image (a batch runs one block per
// frame, side by side), the labels in shared memory, and five passes
// separated by __syncthreads(), with no fixpoint loop: the block
// union-find of Playne and Hawick (IEEE TPDS 29(6), 2018) with the
// run-based initialisation of the block algorithms of Allegretti, Bolelli
// and Grana (IEEE TPDS 31(2), 2020).  A warp takes rows y = warp,
// warp + 32, ..., each in segments of 32 pixels, so y and x come from the
// loops, never from a division.
//  1. init: each mask pixel points at the first pixel of its run within
//     the segment (from the warp's ballot); background gets n.
//  2. merge: unions across the segment boundary (the segment's first
//     pixel with its left neighbour) and with the pixel above, skipped
//     where the left and up-left pixels already join them.  A union finds
//     both roots and hooks the larger under the smaller with a
//     compare-and-swap that succeeds only while it is still a root,
//     retrying from the returned value until the roots agree; finds halve
//     the paths they walk, also by compare-and-swap (Jayanti and Tarjan's
//     concurrent union-find, PODC 2016).  Trees only ever merge, labels
//     only fall and always name a pixel of their own component, so after
//     the pass each component is one tree whose root is its smallest
//     index, whatever the order of the threads.  (An atomicMin hook, which
//     also lowers a root that was hooked meanwhile, moves a subtree from
//     tree to tree and so rules out halving; without halving the rows'
//     parallel hooks built chains as long as the image is high.)
//  3. compress: a run shares one root, which its first pixel finds and
//     hands to the run by a shuffle.  In the groups modes that pixel adds
//     the run's count, sum of x (from its length) and sum of y to the
//     root's slots with three atomics, so a hand's ~2,000 pixels make a
//     few hundred atomics, and a root adds itself to a list of roots.
//  4. select: each root (from the list, or from the labels when more than
//     kRootCap roots overflow it) makes a key per side, the score's float
//     bits high and the complemented index low, and the block takes the
//     maximum (per thread, warp shuffles, one atomicMax per warp).
//  5. write: groups, grown and g_info.  The labels-only mode stops after
//     pass 3, which writes the labels.
// The per-root sums, the keys and the root list live in shared memory
// beside the labels when they fit (16 n + 4,120 bytes: images up to 14,270
// pixels, the live and batched frames' 6,360), else in a scratch the
// wrapper allocates and the kernel initialises.  An image of more than
// kBlockPixels pixels (one block's shared memory as int32 labels; the
// mipmaps of depth_mm_level <= 1 at 848x480) takes the multi-block path at
// the end of this file.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kDefaultSmem = 48 * 1024;
// A block's shared memory on the H100 (227 KB), one int32 label a pixel.
constexpr int kMaxSmem = 232448;
constexpr int kBlockPixels = kMaxSmem / 4;
// The aux block: two uint64 selection keys, the count of roots and a list
// of up to kRootCap of them, then size, sum x and sum y per pixel slot.
constexpr int kRootCap = 1024;
constexpr int kCount = 4;
constexpr int kHeadInts = 6 + kRootCap;
// The key of slot 0 with score 0: argmax's answer when nothing survives.
constexpr unsigned long long kNoGroup = 0xFFFFFFFFull;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The root of a's tree, halving the path as it goes: each step points a
// node at its grandparent with a compare-and-swap (only while its parent
// is unchanged) and moves there.  Links only ever join whole trees (see
// unite), so a grandparent stays an ancestor and no tree loses a member.
__device__ __forceinline__ int find_root(int* lab_raw, volatile int* lab,
                                         int a) {
  for (;;) {
    const int p = lab[a];
    if (p == a) return a;
    const int g = lab[p];
    if (g == p) return p;
    atomicCAS(lab_raw + a, p, g);
    a = g;
  }
}

// Union of a's and b's trees: hook the larger root under the smaller with
// a compare-and-swap that succeeds only while it is still a root; when
// another union hooked it first, retry from the parent the swap returned.
__device__ void unite(int* lab_raw, volatile int* lab, int a, int b) {
  a = find_root(lab_raw, lab, a);
  b = find_root(lab_raw, lab, b);
  while (a != b) {
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(lab_raw + a, a, b);
    if (old == a) return;
    a = find_root(lab_raw, lab, old);
    b = find_root(lab_raw, lab, b);
  }
}

__device__ __forceinline__ unsigned long long max_u64(unsigned long long a,
                                                      unsigned long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1)
    v = max_u64(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// (score, cx, cy) of slot j, as the plain version computes them from its
// float32 sums: a slot that is no root has size 0 and centroid 0 / 1.
// The sums are int32 (one block) or uint64 (the multi-block path), each
// rounded to float32 once.
struct Slot {
  float size, cx, cy;
};

__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_float(unsigned long long v) {
  return __ull2float_rn(v);
}

template <class S>
__device__ __forceinline__ Slot slot_of(const S* sums, int n, int j,
                                        bool root) {
  const float size = root ? to_float(sums[j]) : 0.0f;
  const float sx = root ? to_float(sums[n + j]) : 0.0f;
  const float sy = root ? to_float(sums[2 * n + j]) : 0.0f;
  const float safe = root ? size : 1.0f;
  return Slot{size, __fdiv_rn(sx, safe), __fdiv_rn(sy, safe)};
}

// Root i's key into the right (kr) or left (kl) maximum when it survives:
// its size's float bits high, its complemented index low.
template <class S>
__device__ __forceinline__ void consider(const S* sums, int n, int i,
                                         float n_f, float p, float half_w,
                                         unsigned long long& kr,
                                         unsigned long long& kl) {
  const Slot sl = slot_of(sums, n, i, true);
  if (!(__fdiv_rn(sl.size, n_f) > p)) return;
  const unsigned long long key =
      (static_cast<unsigned long long>(__float_as_uint(sl.size)) << 32) |
      (0xFFFFFFFFu - static_cast<unsigned>(i));
  if (sl.cx < half_w) kr = max_u64(kr, key); else kl = max_u64(kl, key);
}

// The group of a pixel with label v: 2 for the left hand's root, 1 for the
// right's, 0 elsewhere (-1 names no root).
__device__ __forceinline__ int group_of(int v, int r_pick, int l_pick) {
  return v == l_pick ? 2 : (v == r_pick ? 1 : 0);
}

// The first lane of the run of set bits of ``ball`` that holds ``lane``
// (the lane itself when the bit below it is clear).
__device__ __forceinline__ int run_start(unsigned ball, int lane) {
  const unsigned gaps = ~ball & ((1u << lane) - 1u);
  return gaps ? 32 - __clz(gaps) : 0;
}

template <bool kSharedAux>
__global__ void __launch_bounds__(kThreads)
    hand_groups_kernel(const int32_t* __restrict__ depth, long long sb,
                       long long sh, long long sw, int h, int w,
                       const float* __restrict__ pct,
                       int64_t* __restrict__ labels_out,
                       int32_t* __restrict__ groups_out,
                       int32_t* __restrict__ grown_out,
                       float* __restrict__ g_info, int* __restrict__ scratch,
                       long long stride) {
  extern __shared__ __align__(16) int smem[];
  const int n = h * w;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool groups_mode = g_info != nullptr;
  // aux: keys, then sizes, sums of x, sums of y; then the labels
  int* aux = kSharedAux ? smem : scratch + blockIdx.x * stride;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(aux);
  int* roots = aux + 6;
  int* sums = aux + kHeadInts;
  int* lab_raw = kSharedAux ? smem + kHeadInts + 3 * n : smem;
  volatile int* lab = lab_raw;
  const int32_t* d = depth + blockIdx.x * sb;

  // A warp takes rows y = warp, warp + 32, ..., and each row in segments
  // of 32 pixels (x = xs + lane), so the loops are warp-uniform.

  // 1. init: a mask pixel points at its run's first pixel in the segment;
  //    a run's first pixel (the only kind that can become a root) zeroes
  //    its sums.  The loads of a warp's two rows (four segments each) are
  //    in flight before their ballots.
  if (groups_mode && threadIdx.x == 0) {
    keys[0] = keys[1] = kNoGroup;
    aux[kCount] = 0;
  }
  for (int y0 = warp; y0 < h; y0 += 2 * kWarps) {
    const int32_t* rows[2] = {d + y0 * sh, d + (y0 + kWarps) * sh};
    const bool two = y0 + kWarps < h;
    for (int x0 = 0; x0 < w; x0 += 128) {
      int32_t v[2][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int x = x0 + 32 * k + lane;
        v[0][k] = x < w ? rows[0][x * sw] : 0;
        v[1][k] = two && x < w ? rows[1][x * sw] : 0;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int y = y0 + r * kWarps;
        if (y >= h) break;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int xs = x0 + 32 * k;
          const unsigned ball = __ballot_sync(kFull, v[r][k] > 0);
          if (xs + lane >= w) continue;
          const int i = y * w + xs + lane;
          const int st = run_start(ball, lane);
          const bool in = ball >> lane & 1u;
          lab[i] = in ? y * w + xs + st : n;
          if (groups_mode && in && st == lane)
            sums[i] = sums[n + i] = sums[2 * n + i] = 0;
        }
      }
    }
  }
  __syncthreads();

  // 2. merge: the segment's first pixel with its left neighbour, and each
  //    pixel with the one above unless the left and up-left pixels join
  //    them already
  for (int y = warp; y < h; y += kWarps) {
    for (int xs = 0; xs < w; xs += 32) {
      const int x = xs + lane;
      const int i = y * w + x;
      const bool in = x < w && lab[i] != n;
      const bool up = x < w && y > 0 && lab[i - w] != n;
      const unsigned ball = __ballot_sync(kFull, in);
      const unsigned ball_up = __ballot_sync(kFull, up);
      if (!in) continue;
      bool left, up_left;
      if (lane) {
        left = ball >> (lane - 1) & 1u;
        up_left = ball_up >> (lane - 1) & 1u;
      } else {
        left = x > 0 && lab[i - 1] != n;
        up_left = left && y > 0 && lab[i - w - 1] != n;
        if (left) unite(lab_raw, lab, i, i - 1);
      }
      if (up && !(left && up_left)) unite(lab_raw, lab, i, i - w);
    }
  }
  __syncthreads();

  // 3. compress: a run shares its first pixel's root, which only that
  //    pixel finds; in the groups modes it adds the run's count, sum of x
  //    and sum of y to the root's slots
  for (int y = warp; y < h; y += kWarps) {
    for (int xs = 0; xs < w; xs += 32) {
      const int x = xs + lane;
      const int i = y * w + x;
      const bool in = x < w && lab[i] != n;
      const unsigned ball = __ballot_sync(kFull, in);
      const int s = run_start(ball, lane);
      int r = n;
      if (in && s == lane) {
        r = find_root(lab_raw, lab, i);
        if (groups_mode) {
          if (r == i) {
            const int k = atomicAdd(aux + kCount, 1);
            if (k < kRootCap) roots[k] = i;
          }
          const unsigned rest = ~ball & (kFull << lane);
          const int cnt = (rest ? __ffs(rest) - 1 : 32) - lane;
          atomicAdd(sums + r, cnt);
          atomicAdd(sums + n + r, cnt * x + cnt * (cnt - 1) / 2);
          atomicAdd(sums + 2 * n + r, cnt * y);
        }
      }
      r = __shfl_sync(kFull, r, s);
      if (x >= w) continue;
      if (!in) r = n;
      else lab[i] = r;
      if (labels_out) labels_out[static_cast<long long>(blockIdx.x) * n + i] = r;
    }
  }
  if (!groups_mode) return;
  __syncthreads();

  // 4. select: the first maximum per side over the roots (from the list
  //    pass 3 made, or from the labels when it overflowed), per thread,
  //    then per warp, then one atomicMax per warp
  const float p = *pct;
  const float n_f = __int2float_rn(n);
  const float half_w = 0.5f * __int2float_rn(w);
  const int* labc = lab_raw;         // no writer is left
  unsigned long long kr = kNoGroup, kl = kNoGroup;
  const int n_roots = aux[kCount];
  if (n_roots <= kRootCap) {
    for (int k = threadIdx.x; k < n_roots; k += kThreads)
      consider(sums, n, roots[k], n_f, p, half_w, kr, kl);
  } else {
    for (int y = warp; y < h; y += kWarps)
      for (int x = lane; x < w; x += 32)
        if (labc[y * w + x] == y * w + x)
          consider(sums, n, y * w + x, n_f, p, half_w, kr, kl);
  }
  kr = warp_max(kr);
  kl = warp_max(kl);
  if (lane == 0 && (kr != kNoGroup || kl != kNoGroup)) {
    atomicMax(keys, kr);
    atomicMax(keys + 1, kl);
  }
  __syncthreads();

  // 5. write groups, grown and g_info
  const unsigned long long r_key = keys[0], l_key = keys[1];
  const float rs = __uint_as_float(static_cast<unsigned>(r_key >> 32));
  const float ls = __uint_as_float(static_cast<unsigned>(l_key >> 32));
  const int r_root = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(r_key));
  const int l_root = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(l_key));
  const int r_pick = rs > 0.0f ? r_root : -1;
  const int l_pick = ls > 0.0f ? l_root : -1;
  const long long base = static_cast<long long>(blockIdx.x) * n;
  for (int y = warp; y < h; y += kWarps) {
    for (int x = lane; x < w; x += 32) {
      const int i = y * w + x;
      const int g = group_of(labc[i], r_pick, l_pick);
      groups_out[base + i] = g;
      if (!grown_out) continue;
      // the neighbours' groups, read independently, then left, right, up,
      // down in turn
      const int gl = x > 0 ? group_of(labc[i - 1], r_pick, l_pick) : 0;
      const int gr = x + 1 < w ? group_of(labc[i + 1], r_pick, l_pick) : 0;
      const int gu = y > 0 ? group_of(labc[i - w], r_pick, l_pick) : 0;
      const int gd = y + 1 < h ? group_of(labc[i + w], r_pick, l_pick) : 0;
      grown_out[base + i] = g ? g : gl ? gl : gr ? gr : gu ? gu : gd;
    }
  }
  if (threadIdx.x < 2) {
    const int j = threadIdx.x ? l_root : r_root;
    const Slot sl = slot_of(sums, n, j, labc[j] == j);
    float* o = g_info + blockIdx.x * 6 + threadIdx.x * 3;
    o[0] = threadIdx.x ? ls : rs;
    o[1] = sl.cx;
    o[2] = sl.cy;
  }
}

// Whether the aux block (keys and per-slot sums) fits in shared memory
// beside the labels.
bool shared_aux(long long n) {
  return 4 * (kHeadInts + 4 * n) <= kMaxSmem;
}

template <bool kSharedAux>
cudaError_t launch(const int32_t* depth, long long sb, long long sh,
                   long long sw, int b, int h, int w, const float* pct,
                   int64_t* labels, int32_t* groups, int32_t* grown,
                   float* g_info, int* scratch, long long stride, int smem,
                   cudaStream_t stream) {
  // the attribute once per device, before any capture of a launch
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > kDefaultSmem && dev < 64 && !raised[dev]) {
    e = cudaFuncSetAttribute(hand_groups_kernel<kSharedAux>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  hand_groups_kernel<kSharedAux><<<b, kThreads, smem, stream>>>(
      depth, sb, sh, sw, h, w, pct, labels, groups, grown, g_info, scratch,
      stride);
  return cudaGetLastError();
}

}  // namespace

// int32 scratch per image that b3d_hand_groups needs in its groups modes
// (0 when the aux block fits in shared memory); even, so the keys stay
// 8-byte aligned.
extern "C" long long b3d_hand_groups_scratch(int h, int w) {
  const long long n = static_cast<long long>(h) * w;
  if (shared_aux(n)) return 0;
  const long long ints = kHeadInts + 3 * n;
  return ints + (ints & 1);
}

// depth: (b, H, W) int32 device, the image's element strides sb, sh, sw
// (sh and sw already multiplied by the mipmap factor); h x w: the shrunk
// image.  Modes: labels != nullptr: (b, h, w) int64 labels only; else
// groups (b, h, w) int32 and g_info (b, 2, 3) float32, with grown
// (b, h, w) int32 when grown != nullptr.  pct: a float32 device scalar,
// read by the kernel.  scratch: b * b3d_hand_groups_scratch(h, w) ints,
// or nullptr when that is 0.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an image of more than kBlockPixels
// pixels (components.BLOCK_PIXELS; b3d_hand_groups_mb takes those) or a
// missing output or scratch.
extern "C" int b3d_hand_groups(const int32_t* depth, long long sb,
                               long long sh, long long sw, int b, int h,
                               int w, const float* pct, int64_t* labels,
                               int32_t* groups, int32_t* grown, float* g_info,
                               int* scratch, void* stream) {
  const long long n = static_cast<long long>(h) * w;
  const bool groups_mode = labels == nullptr;
  if (b < 0 || h < 0 || w < 0 || n > kBlockPixels ||
      (groups_mode && (groups == nullptr || g_info == nullptr ||
                       pct == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const long long stride = b3d_hand_groups_scratch(h, w);
  if (groups_mode && stride > 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (groups_mode && stride == 0) {
    e = launch<true>(depth, sb, sh, sw, b, h, w, pct, nullptr, groups, grown,
                     g_info, nullptr, 0,
                     static_cast<int>(4 * (kHeadInts + 4 * n)), s);
  } else {
    e = launch<false>(depth, sb, sh, sw, b, h, w, pct, labels,
                      groups_mode ? groups : nullptr,
                      groups_mode ? grown : nullptr,
                      groups_mode ? g_info : nullptr, scratch, stride,
                      static_cast<int>(4 * n), s);
  }
  return static_cast<int>(e);
}

// ---------------------------------------------------------------------------
// The multi-block path (b3d_hand_groups_mb): images of more than
// kBlockPixels pixels, whose labels do not fit one block's shared memory.
// The same contract and outputs, bit for bit (the sums are uint64, so they
// stay exact at any size; the plain version's float32 sums agree while
// they stay below 2^24).  Five launches with no host read, each a grid of
// 32 x 32 tiles (1024 threads, one pixel each; warp y a 32-pixel row
// segment), the labels and the sums in a scratch of device memory:
//  1. local: a tile's union-find in shared memory (the block kernel's
//     compare-and-swap hooks and halving finds), written out as global
//     indices (the tile's smallest index is its component part's smallest
//     global index); the sums' slots and the image's keys are zeroed;
//  2. merge: unions across the tiles' left and top borders, the same hooks
//     and finds on the global labels (every link points at a smaller index,
//     so each component ends as one tree rooted at its smallest index);
//  3. compress: as the block kernel's pass 3, a run's first pixel finds the
//     root and adds the run's count, sum of x and sum of y with three
//     64-bit atomics; every mask pixel then holds its root (the labels-only
//     mode writes them out and stops here);
//  4. select: each root makes its keys (as in pass 4), a warp's maximum
//     goes to the image's two keys with one 64-bit atomicMax each;
//  5. write: groups, grown and g_info, as pass 5.
// What bounds it: at 240x424 (level 1) 101,760 pixels are 0.4 MB of depth
// in and 0.8 MB of groups and grown out, some 0.4 us at 3.35 TB/s; the
// five launches' latency (a few us each, dependent) and the unions along
// the tile borders set its time.

namespace {

constexpr int kTile = 32;

// Scratch per image, in int32 units: the labels (n, rounded up to even),
// then size, sum of x and sum of y (uint64, n each), then the two keys.
__host__ __device__ constexpr long long mb_label_ints(long long n) {
  return (n + 1) & ~1LL;
}

__host__ __device__ constexpr long long mb_scratch_ints(long long n) {
  return mb_label_ints(n) + 6 * n + 4;
}

struct MbImage {
  int* lab;
  unsigned long long* sums;   // size, sum x, sum y: n each
  unsigned long long* keys;   // right, left
};

__device__ __forceinline__ MbImage mb_image(int* scratch, int z, int n) {
  int* lab = scratch + z * mb_scratch_ints(n);
  unsigned long long* sums =
      reinterpret_cast<unsigned long long*>(lab + mb_label_ints(n));
  return MbImage{lab, sums, sums + 3 * static_cast<long long>(n)};
}

__global__ void __launch_bounds__(kThreads)
    hand_groups_mb_local(const int32_t* __restrict__ depth, long long sb,
                         long long sh, long long sw, int h, int w,
                         int* __restrict__ scratch, bool groups_mode) {
  __shared__ int tl[kTile * kTile];
  constexpr int kNone = kTile * kTile;
  const int lx = threadIdx.x, ly = threadIdx.y;
  const int x = blockIdx.x * kTile + lx, y = blockIdx.y * kTile + ly;
  const int n = h * w;
  const MbImage im = mb_image(scratch, blockIdx.z, n);
  const int t = ly * kTile + lx;
  const bool inside = x < w && y < h;
  const bool m = inside && depth[blockIdx.z * sb + y * sh + x * sw] > 0;
  tl[t] = m ? t : kNone;
  __syncthreads();
  volatile int* tv = tl;
  if (m && lx > 0 && tv[t - 1] != kNone) unite(tl, tv, t, t - 1);
  if (m && ly > 0 && tv[t - kTile] != kNone) unite(tl, tv, t, t - kTile);
  __syncthreads();
  if (inside) {
    const int i = y * w + x;
    int g = n;
    if (m) {
      const int r = find_root(tl, tv, t);
      g = (blockIdx.y * kTile + r / kTile) * w + blockIdx.x * kTile + r % kTile;
    }
    im.lab[i] = g;
    if (groups_mode) im.sums[i] = im.sums[n + i] = im.sums[2 * n + i] = 0;
  }
  if (groups_mode && t == 0 && blockIdx.x == 0 && blockIdx.y == 0)
    im.keys[0] = im.keys[1] = kNoGroup;
}

__global__ void __launch_bounds__(kThreads)
    hand_groups_mb_merge(int h, int w, int* __restrict__ scratch) {
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + threadIdx.y;
  if (x >= w || y >= h || (threadIdx.x && threadIdx.y)) return;
  const int n = h * w;
  int* lab = mb_image(scratch, blockIdx.z, n).lab;
  volatile int* lv = lab;
  const int i = y * w + x;
  if (lv[i] == n) return;
  if (threadIdx.x == 0 && x > 0 && lv[i - 1] != n) unite(lab, lv, i, i - 1);
  if (threadIdx.y == 0 && y > 0 && lv[i - w] != n) unite(lab, lv, i, i - w);
}

__global__ void __launch_bounds__(kThreads)
    hand_groups_mb_compress(int h, int w, int* __restrict__ scratch,
                            int64_t* __restrict__ labels_out,
                            bool groups_mode) {
  const int lane = threadIdx.x;
  const int x = blockIdx.x * kTile + lane;
  const int y = blockIdx.y * kTile + threadIdx.y;
  if (y >= h) return;                          // the whole warp
  const int n = h * w;
  const MbImage im = mb_image(scratch, blockIdx.z, n);
  volatile int* lv = im.lab;
  const int i = y * w + x;
  const bool in = x < w && lv[i] != n;
  const unsigned ball = __ballot_sync(kFull, in);
  const int s = run_start(ball, lane);
  int r = n;
  if (in && s == lane) {
    r = find_root(im.lab, lv, i);
    if (groups_mode) {
      const unsigned rest = ~ball & (kFull << lane);
      const unsigned long long cnt = (rest ? __ffs(rest) - 1 : 32) - lane;
      atomicAdd(im.sums + r, cnt);
      atomicAdd(im.sums + n + r, cnt * x + cnt * (cnt - 1) / 2);
      atomicAdd(im.sums + 2 * n + r, cnt * y);
    }
  }
  r = __shfl_sync(kFull, r, s);
  if (x >= w) return;
  if (!in) r = n;
  else im.lab[i] = r;
  if (labels_out) labels_out[static_cast<long long>(blockIdx.z) * n + i] = r;
}

__global__ void __launch_bounds__(kThreads)
    hand_groups_mb_select(int h, int w, const float* __restrict__ pct,
                          int* __restrict__ scratch) {
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + threadIdx.y;
  const int n = h * w;
  const MbImage im = mb_image(scratch, blockIdx.z, n);
  unsigned long long kr = kNoGroup, kl = kNoGroup;
  if (x < w && y < h && im.lab[y * w + x] == y * w + x) {
    consider(im.sums, n, y * w + x, __int2float_rn(n), *pct,
             0.5f * __int2float_rn(w), kr, kl);
  }
  kr = warp_max(kr);
  kl = warp_max(kl);
  if (threadIdx.x == 0 && (kr != kNoGroup || kl != kNoGroup)) {
    atomicMax(im.keys, kr);
    atomicMax(im.keys + 1, kl);
  }
}

__global__ void __launch_bounds__(kThreads)
    hand_groups_mb_write(int h, int w, int* __restrict__ scratch,
                         int32_t* __restrict__ groups_out,
                         int32_t* __restrict__ grown_out,
                         float* __restrict__ g_info) {
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + threadIdx.y;
  const int n = h * w;
  const MbImage im = mb_image(scratch, blockIdx.z, n);
  const int* labc = im.lab;
  const unsigned long long r_key = im.keys[0], l_key = im.keys[1];
  const float rs = __uint_as_float(static_cast<unsigned>(r_key >> 32));
  const float ls = __uint_as_float(static_cast<unsigned>(l_key >> 32));
  const int r_root = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(r_key));
  const int l_root = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(l_key));
  const int r_pick = rs > 0.0f ? r_root : -1;
  const int l_pick = ls > 0.0f ? l_root : -1;
  const long long base = static_cast<long long>(blockIdx.z) * n;
  if (x < w && y < h) {
    const int i = y * w + x;
    const int g = group_of(labc[i], r_pick, l_pick);
    groups_out[base + i] = g;
    if (grown_out) {
      const int gl = x > 0 ? group_of(labc[i - 1], r_pick, l_pick) : 0;
      const int gr = x + 1 < w ? group_of(labc[i + 1], r_pick, l_pick) : 0;
      const int gu = y > 0 ? group_of(labc[i - w], r_pick, l_pick) : 0;
      const int gd = y + 1 < h ? group_of(labc[i + w], r_pick, l_pick) : 0;
      grown_out[base + i] = g ? g : gl ? gl : gr ? gr : gu ? gu : gd;
    }
  }
  const int side = threadIdx.x;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.y == 0 && side < 2) {
    const int j = side ? l_root : r_root;
    const Slot sl = slot_of(im.sums, n, j, labc[j] == j);
    float* o = g_info + blockIdx.z * 6 + side * 3;
    o[0] = side ? ls : rs;
    o[1] = sl.cx;
    o[2] = sl.cy;
  }
}

}  // namespace

// int32 scratch per image that b3d_hand_groups_mb needs (the labels, the
// uint64 sums and keys); even, so the sums stay 8-byte aligned.
extern "C" long long b3d_hand_groups_mb_scratch(int h, int w) {
  return mb_scratch_ints(static_cast<long long>(h) * w);
}

// The multi-block path, for any image of fewer than 2^31 pixels and at
// most 65535 * 32 rows: arguments and modes as b3d_hand_groups; scratch:
// b * b3d_hand_groups_mb_scratch(h, w) ints in every mode.  Returns
// cudaGetLastError() after the launches.
extern "C" int b3d_hand_groups_mb(const int32_t* depth, long long sb,
                                  long long sh, long long sw, int b, int h,
                                  int w, const float* pct, int64_t* labels,
                                  int32_t* groups, int32_t* grown,
                                  float* g_info, int* scratch, void* stream) {
  const long long n = static_cast<long long>(h) * w;
  const bool groups_mode = labels == nullptr;
  if (b < 0 || h < 0 || w < 0 || n >= (1LL << 31) ||
      (h + kTile - 1) / kTile > 65535 || scratch == nullptr ||
      (groups_mode && (groups == nullptr || g_info == nullptr ||
                       pct == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long stride = mb_scratch_ints(n);
  const dim3 block(kTile, kTile);
  for (int z0 = 0; z0 < b; z0 += 65535) {
    const int nz = b - z0 < 65535 ? b - z0 : 65535;
    const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, nz);
    int* sc = scratch + z0 * stride;
    const long long o = z0 * n;
    hand_groups_mb_local<<<grid, block, 0, s>>>(depth + z0 * sb, sb, sh, sw,
                                                 h, w, sc, groups_mode);
    hand_groups_mb_merge<<<grid, block, 0, s>>>(h, w, sc);
    hand_groups_mb_compress<<<grid, block, 0, s>>>(
        h, w, sc, groups_mode ? nullptr : labels + o, groups_mode);
    if (groups_mode) {
      hand_groups_mb_select<<<grid, block, 0, s>>>(h, w, pct, sc);
      hand_groups_mb_write<<<grid, block, 0, s>>>(
          h, w, sc, groups + o, grown ? grown + o : nullptr,
          g_info + 6LL * z0);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}
