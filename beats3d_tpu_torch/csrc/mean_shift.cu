// Per-class mean shift of label images, every round and class in one
// launch: mean_shift_cuda (ops/meanshift_cuda.py).
//
// Not a port of a pallas_call: JAX runs beats3d_tpu/ops/meanshift.py:
// mean_shift as XLA operations, and the port's plain version
// (ops/meanshift.py) as some 110 ATen kernels, each of which passes over a
// float32 mask per class, (N, C, H, W).  Semantics are the plain version's:
//
//   round 0:     each class's centroid, sum(x) / max(count, 1)
//   rounds 1..:  m += sum(p * d) / (sum(p) == 0 ? 1 : sum(p)),
//                d = (x, y) - m, p = exp(-|d|^2 / (2 * var * var))
//   a class with no pixel is NaN; labels outside 1..C are background.
//
// A pixel's arithmetic is the plain version's, each operation rounded to
// float32 on its own (__fsub_rn, __fmul_rn, __fadd_rn, IEEE __fdiv_rn, full
// precision expf), so only the order of the sums differs.  Round 0 sums
// counts and coordinates as integers: exact, and equal to the plain
// version's float32 sums while those stay under 2^24.
//
// What bounds it on the H100.  The one input is the int32 label image; read
// once it is 7.3 MB for the batched call's 32 crops of 224x256 (2.2 us at
// 3.35 TB/s), and the float work, 12 operations per labelled pixel and
// round, is far less.  What a launch cannot avoid is the chain of dependent
// steps: each round needs every pixel of an image before the next round's
// means exist, so a call is six whole-image reductions in a row, and each
// pixel's weight is a chain of a division and an exp.
//
// Design.
// * One image to one cluster of kCluster = 8 CTAs of 256 threads on
//   neighbouring SMs: 32 crops are 256 CTAs, 2 crops 16.  CTA `rank` takes
//   the image's rows rank, rank + kCluster, ..., so a hand spreads evenly
//   over the cluster.  (On the H100 at the main path's shapes, 4 CTAs of
//   256, 8 of 128 or 512, 2 of 512 and one CTA of 1024 threads per image
//   all measured slower.)
// * Each CTA stages its rows in shared memory once, packed as bytes (the
//   class, or 0), 16-byte loads in flight together; device memory is not
//   read again.  A model of more than kGroup classes takes them kGroup at a
//   time, each group staged anew; an image too large to stage (past about
//   1.6 M label pixels) is read from device memory at every pass.
// * A round walks the staged words, 4 pixels a word, skipping empty words;
//   the 4 pixels' chains run side by side.  A labelled pixel computes one
//   weight, for its own class only.  Each thread keeps (sum p, sum p*dx,
//   sum p*dy) of kChunk classes in registers; a model of more classes takes
//   one pass over the words per kChunk classes (the flagship's 6 classes
//   one, the 17-class wide models three).
// * The partial sums are reduced in a fixed order: a reduce-scatter of warp
//   shuffles (27 shuffles for 24 sums), the warps through shared memory,
//   then each CTA's sums are stored into every CTA of the cluster
//   (distributed shared memory) and summed there in rank order.  Every CTA
//   computes the same new means from the same sums, and the next round
//   starts: one barrier of the cluster per round, no float atomics, so a
//   launch gives the same bits every time (graph replays equal eager
//   calls).

#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;                 // CTAs per image
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;                   // classes a thread sums at once
constexpr int kSums = 3 * kChunk;           // (p, p*dx, p*dy) per class
constexpr int kGroup = 64;                  // classes whose means a CTA holds
constexpr int kStageBatch = 8;              // 16-byte loads in flight
constexpr int kStagedBytes = 200 * 1024;    // labels staged up to this a CTA

struct Params {
  const int32_t* labels;  // (n, h, w)
  const float* var;       // (classes,)
  float* out;             // (n, classes, 2)
  int h, w, classes, rounds;
};

// A CTA's labels: staged in shared memory (4 a word), or read from device
// memory at every pass (an image whose rows of one CTA exceed kStagedBytes).
struct Labels {
  const uint32_t* staged;
  const int32_t* img;     // the image's (h, w) labels
  int w;
  bool vec;               // rows start 16-byte aligned
  int g0, gc;             // the class group: classes g0 + 1 .. g0 + gc
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) { return a + b; }
__device__ __forceinline__ uint32_t bits(float a) { return __float_as_uint(a); }
__device__ __forceinline__ uint32_t bits(uint32_t a) { return a; }
template <typename T>
__device__ __forceinline__ T value(uint32_t b);
template <>
__device__ __forceinline__ float value<float>(uint32_t b) { return __uint_as_float(b); }
template <>
__device__ __forceinline__ uint32_t value<uint32_t>(uint32_t b) { return b; }

// The sums v[0..23] over a warp's lanes.  Afterwards lane l holds in v[0..2]
// the sums of entries 12*b4 + 6*b3 + 3*b2 + {0, 1, 2}, b4..b2 being bits 4..2
// of l: one class's three sums, the same in the four lanes that differ in
// bits 1 and 0 (an add is commutative).
template <typename T>
__device__ __forceinline__ void warp_reduce_scatter(T (&v)[kSums], int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const T send = h16 ? v[i] : v[i + 12];
    const T keep = h16 ? v[i + 12] : v[i];
    v[i] = add(keep, __shfl_xor_sync(0xffffffffu, send, 16));
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const T send = h8 ? v[i] : v[i + 6];
    const T keep = h8 ? v[i + 6] : v[i];
    v[i] = add(keep, __shfl_xor_sync(0xffffffffu, send, 8));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T send = h4 ? v[i] : v[i + 3];
    const T keep = h4 ? v[i + 3] : v[i];
    v[i] = add(keep, __shfl_xor_sync(0xffffffffu, send, 4));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = add(v[i], __shfl_xor_sync(0xffffffffu, v[i], 2));
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = add(v[i], __shfl_xor_sync(0xffffffffu, v[i], 1));
}

// Every thread of the cluster's CTAs, each warp converged: the stores to the
// cluster's shared memory before it are seen by every thread after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Labels x .. x + 3 of a row (those past its end 0).
__device__ __forceinline__ int4 load4(const int32_t* row, int x, int w, bool vec) {
  if (vec) return *reinterpret_cast<const int4*>(row + x);
  int4 q = make_int4(row[x], 0, 0, 0);
  if (x + 1 < w) q.y = row[x + 1];
  if (x + 2 < w) q.z = row[x + 2];
  if (x + 3 < w) q.w = row[x + 3];
  return q;
}

// Four labels as bytes: the class within the group (1 .. gc), or 0.
__device__ __forceinline__ uint32_t pack(int4 q, int g0, int gc) {
  const int l[4] = {q.x, q.y, q.z, q.w};
  uint32_t word = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int c = l[b] - g0;
    word |= static_cast<uint32_t>(c >= 1 && c <= gc ? c : 0) << (8 * b);
  }
  return word;
}

// A pixel's three terms: round 0 (kCentroid) (1, x, y), later rounds
// (p, p*dx, p*dy) about class c's mean, each operation rounded on its own as
// the plain version rounds it.
template <bool kCentroid, typename T>
__device__ __forceinline__ void pixel(int c, int x, int y, float (*mean)[2],
                                      const float* two_var2, T& s0, T& s1,
                                      T& s2) {
  if constexpr (kCentroid) {
    s0 = 1;
    s1 = x;
    s2 = y;
  } else {
    const float dx = __fsub_rn(__int2float_rn(x), mean[c][0]);
    const float dy = __fsub_rn(__int2float_rn(y), mean[c][1]);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    s0 = expf(__fdiv_rn(-d2, two_var2[c]));
    s1 = __fmul_rn(s0, dx);
    s2 = __fmul_rn(s0, dy);
  }
}

// Adds a pixel's terms to the sums of its class k of the chunk (none for a
// k outside 0..kChunk-1), the sums staying in registers.
template <typename T>
__device__ __forceinline__ void dispatch(T (&acc)[kSums], int k, T s0, T s1,
                                         T s2) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (i == k) {
      acc[3 * i] = add(acc[3 * i], s0);
      acc[3 * i + 1] = add(acc[3 * i + 1], s1);
      acc[3 * i + 2] = add(acc[3 * i + 2], s2);
    }
  }
}

// One pass of a round over this CTA's words for the group's classes
// base + 1 .. base + kChunk: round 0 (kCentroid) sums (1, x, y) as 32-bit
// integers, later rounds (p, p*dx, p*dy) as floats.  The warps' sums go to
// slot, the CTA's to gathered[rank][3 * class + 0..2] in every CTA of the
// cluster.
template <bool kCentroid, bool kStaged>
__device__ __forceinline__ void class_sums(
    cg::cluster_group& cluster, const Labels& lab, int nwords, int wpr,
    int rank, int base, float (*mean)[2], const float* two_var2,
    uint32_t (*slot)[kSums], uint32_t (*gathered)[3 * kGroup]) {
  using T = typename std::conditional<kCentroid, uint32_t, float>::type;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0;
  // the word j = tid + i * kThreads is (row li, column xw), stepped without
  // a division
  const int wq = max(wpr, 1);
  const int step_rows = kThreads / wq, step_cols = kThreads - step_rows * wq;
  int li = tid / wq, xw = tid - li * wq;
  for (int j = tid; j < nwords; j += kThreads) {
    const int x0 = 4 * xw, y = rank + li * kCluster;
    uint32_t word;
    if constexpr (kStaged) {
      word = lab.staged[j];
    } else {
      word = pack(load4(lab.img + static_cast<size_t>(y) * lab.w, x0, lab.w, lab.vec),
                  lab.g0, lab.gc);
    }
    if (word != 0) {
      // the word's four pixels side by side, so that their chains overlap;
      // a pixel of no class of the chunk computes for class `base` and adds
      // nothing
      const int k0 = static_cast<int>(word & 0xffu) - 1 - base;
      const int k1 = static_cast<int>((word >> 8) & 0xffu) - 1 - base;
      const int k2 = static_cast<int>((word >> 16) & 0xffu) - 1 - base;
      const int k3 = static_cast<int>(word >> 24) - 1 - base;
      auto cls = [&](int k) {
        return static_cast<unsigned>(k) < static_cast<unsigned>(kChunk) ? base + k
                                                                        : base;
      };
      T a0, a1, a2, b0, b1, b2, c0, c1, c2, d0, d1, d2;
      pixel<kCentroid>(cls(k0), x0, y, mean, two_var2, a0, a1, a2);
      pixel<kCentroid>(cls(k1), x0 + 1, y, mean, two_var2, b0, b1, b2);
      pixel<kCentroid>(cls(k2), x0 + 2, y, mean, two_var2, c0, c1, c2);
      pixel<kCentroid>(cls(k3), x0 + 3, y, mean, two_var2, d0, d1, d2);
      dispatch(acc, k0, a0, a1, a2);
      dispatch(acc, k1, b0, b1, b2);
      dispatch(acc, k2, c0, c1, c2);
      dispatch(acc, k3, d0, d1, d2);
    }
    xw += step_cols;
    li += step_rows;
    if (xw >= wq) {
      xw -= wq;
      ++li;
    }
  }
  warp_reduce_scatter(acc, lane);
  if ((lane & 3) == 0) {
    const int first = 12 * ((lane >> 4) & 1) + 6 * ((lane >> 3) & 1) +
                      3 * ((lane >> 2) & 1);
#pragma unroll
    for (int i = 0; i < 3; ++i) slot[warp][first + i] = bits(acc[i]);
  }
  __syncthreads();
  if (tid < kSums && base + tid / 3 < lab.gc) {
    T t = 0;
    for (int wp = 0; wp < kWarps; ++wp) t = add(t, value<T>(slot[wp][tid]));
    uint32_t* to = &gathered[rank][3 * base + tid];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) *cluster.map_shared_rank(to, r) = bits(t);
  }
}

template <bool kStaged>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    mean_shift_kernel(Params p) {
  extern __shared__ uint32_t staged[];      // this CTA's rows, 4 labels a word
  __shared__ float mean[kGroup][2];
  __shared__ float two_var2[kGroup];
  __shared__ int present[kGroup];
  __shared__ uint32_t slot[2][kWarps][kSums];               // by pass parity
  __shared__ uint32_t gathered[2][kCluster][3 * kGroup];    // by round parity

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int img = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int h = p.h, w = p.w;
  const int wpr = (w + 3) / 4;                               // words per row
  const int rows = rank < h ? (h - 1 - rank) / kCluster + 1 : 0;
  const int nwords = rows * wpr;
  Labels lab{staged, p.labels + static_cast<size_t>(img) * h * w, w, false, 0, 0};
  lab.vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(lab.img) % 16 == 0;

  // slot[pass & 1] is written again two passes on, after the next pass's
  // barrier, which its readers reach only once done reading it; a CTA's
  // gathered[t & 1] likewise two rounds on, after the next round's cluster
  // barrier.  No CTA touches another's memory after the last round's
  // barrier, so each may then leave.
  int pass = 0, t = 0;
  for (lab.g0 = 0; lab.g0 < p.classes; lab.g0 += kGroup) {
    lab.gc = min(kGroup, p.classes - lab.g0);
    __syncthreads();          // the previous group is done with staged, mean
    if constexpr (kStaged) {
      for (int j0 = tid; j0 < nwords; j0 += kThreads * kStageBatch) {
        int4 q[kStageBatch];
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const int j = j0 + u * kThreads;
          q[u] = make_int4(0, 0, 0, 0);
          if (j < nwords) {
            const int li = j / wpr;
            q[u] = load4(lab.img + static_cast<size_t>(rank + li * kCluster) * w,
                         (j - li * wpr) * 4, w, lab.vec);
          }
        }
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const int j = j0 + u * kThreads;
          if (j < nwords) staged[j] = pack(q[u], lab.g0, lab.gc);
        }
      }
    }
    for (int c = tid; c < lab.gc; c += kThreads) {
      const float v = p.var[lab.g0 + c];
      two_var2[c] = __fmul_rn(2.0f, __fmul_rn(v, v));
    }
    __syncthreads();

    for (int round = 0; round < max(p.rounds, 1); ++round, ++t) {
      for (int base = 0; base < lab.gc; base += kChunk, ++pass) {
        if (round == 0) {
          class_sums<true, kStaged>(cluster, lab, nwords, wpr, rank, base,
                                    mean, two_var2, slot[pass & 1],
                                    gathered[t & 1]);
        } else {
          class_sums<false, kStaged>(cluster, lab, nwords, wpr, rank, base,
                                     mean, two_var2, slot[pass & 1],
                                     gathered[t & 1]);
        }
      }
      cluster_barrier();            // every CTA's sums of this round are here
      uint32_t (*q)[3 * kGroup] = gathered[t & 1];
      for (int c = tid; c < lab.gc; c += kThreads) {
        if (round == 0) {
          // the coordinate sums of a whole image may pass 32 bits
          unsigned long long n = 0, sx = 0, sy = 0;
#pragma unroll
          for (int r = 0; r < kCluster; ++r) {
            n += q[r][3 * c];
            sx += q[r][3 * c + 1];
            sy += q[r][3 * c + 2];
          }
          const float cnt = __ull2float_rn(n > 0 ? n : 1);
          present[c] = n > 0;
          mean[c][0] = __fdiv_rn(__ull2float_rn(sx), cnt);
          mean[c][1] = __fdiv_rn(__ull2float_rn(sy), cnt);
        } else {
          float den = 0.0f, sx = 0.0f, sy = 0.0f;
#pragma unroll
          for (int r = 0; r < kCluster; ++r) {
            den = __fadd_rn(den, __uint_as_float(q[r][3 * c]));
            sx = __fadd_rn(sx, __uint_as_float(q[r][3 * c + 1]));
            sy = __fadd_rn(sy, __uint_as_float(q[r][3 * c + 2]));
          }
          const float safe = den == 0.0f ? 1.0f : den;
          mean[c][0] = __fadd_rn(mean[c][0], __fdiv_rn(sx, safe));
          mean[c][1] = __fadd_rn(mean[c][1], __fdiv_rn(sy, safe));
        }
      }
      __syncthreads();
    }
    if (rank == 0) {
      const float nan = __int_as_float(0x7fc00000);
      float* out = p.out + (static_cast<size_t>(img) * p.classes + lab.g0) * 2;
      for (int c = tid; c < lab.gc; c += kThreads) {
        out[2 * c] = present[c] ? mean[c][0] : nan;
        out[2 * c + 1] = present[c] ? mean[c][1] : nan;
      }
    }
  }
}

template <bool kStaged>
int launch(const Params& p, int n, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mean_shift_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mean_shift_kernel<kStaged><<<n * kCluster, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// labels: (n, h, w) int32 device; var: (classes,) float32 device; out:
// (n, classes, 2) float32 device.  rounds: the plain version's num_rounds
// (round 0 the centroid).  Classes are taken kGroup at a time, each group's
// labels staged anew; an image whose rows of one CTA exceed kStagedBytes is
// read from device memory at every pass instead.  Refuses an image whose
// coordinate sums over one CTA's rows could pass 32 bits (past about
// 3,000 x 3,000 label pixels).  Returns cudaGetLastError() after the launch.
extern "C" int b3d_mean_shift(const int32_t* labels, const float* var,
                              float* out, int n, int h, int w, int classes,
                              int rounds, void* stream) {
  const long long rows = (h + kCluster - 1) / kCluster;
  if (n < 0 || h < 0 || w < 0 || classes < 1 ||
      static_cast<long long>(n) * kCluster > 0x7fffffffLL ||
      rows * w * (h > w ? h : w) > 0xffffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Params p{labels, var, out, h, w, classes, rounds};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long staged = rows * ((w + 3) / 4) * 4;
  return staged <= kStagedBytes
             ? launch<true>(p, n, static_cast<int>(staged > 16 ? staged : 16), s)
             : launch<false>(p, n, 16, s);
}
