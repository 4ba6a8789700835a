// Shared pieces of the probe kernels (probe_tile.cu, probe_gather.cu,
// probe_tile_list.cu), the counterparts of the scripts/ Mosaic probes.
//
// A TPU vreg is 8 sublanes x 128 lanes of int32.  Here one (8, 128) tile is
// one CTA of 128 threads (4 warps), and thread l holds column l, the 8
// values t[s][l], in registers:
//
// * sublane-axis work (row broadcasts, rolls along axis 0, gathers along
//   axis 0) stays in the thread's registers;
// * lane-axis work (take_along_axis along axis 1) crosses threads through
//   shared memory, with a barrier before each dependent read;
// * a full-tile min / max / any folds the thread's 8 registers, reduces in
//   the warp (__reduce_*_sync) and combines the 4 warps through shared
//   memory; every thread then holds the scalar.  This is the counterpart of
//   the TPU's vector -> scalar round trip.
//
// Arithmetic that can overflow is done in uint32_t, so it wraps in two's
// complement as XLA does (signed overflow is undefined in C++).  jnp's // and
// % are floor division and floor modulo; C's truncate, hence floor_div and
// floor_mod.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace b3d_probe {

constexpr int kSub = 8;
constexpr int kLane = 128;
constexpr int kTile = kSub * kLane;
constexpr int kWarps = kLane / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBadArgument = static_cast<int>(cudaErrorInvalidValue);

// Launch kernel on `ctas` CTAs of one tile's 128 threads; returns
// cudaGetLastError() (cudaSuccess without a launch when ctas is 0).
template <class Kernel, class... Args>
int launch(Kernel kernel, int ctas, void* stream, Args... args) {
  if (ctas == 0) return static_cast<int>(cudaSuccess);
  kernel<<<ctas, kLane, 0, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// Column threadIdx.x of the (8, 128) tile at src, into registers.
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ src,
                                          int v[kSub]) {
#pragma unroll
  for (int s = 0; s < kSub; ++s) v[s] = src[s * kLane + threadIdx.x];
}

__device__ __forceinline__ void store_tile(int32_t* __restrict__ dst,
                                           const int v[kSub]) {
#pragma unroll
  for (int s = 0; s < kSub; ++s) dst[s * kLane + threadIdx.x] = v[s];
}

struct Min {
  __device__ static int op(int a, int b) { return a < b ? a : b; }
  __device__ static int warp(int v) { return __reduce_min_sync(kFullMask, v); }
};

struct Max {
  __device__ static int op(int a, int b) { return a > b ? a : b; }
  __device__ static int warp(int v) { return __reduce_max_sync(kFullMask, v); }
};

struct Or {
  __device__ static int op(int a, int b) { return a | b; }
  __device__ static int warp(int v) {
    return static_cast<int>(__reduce_or_sync(kFullMask, static_cast<unsigned>(v)));
  }
};

// The thread's 8 registers folded into one value.
template <class R>
__device__ __forceinline__ int fold(const int v[kSub]) {
  int r = v[0];
#pragma unroll
  for (int s = 1; s < kSub; ++s) r = R::op(r, v[s]);
  return r;
}

// Reduce one value per thread over the CTA; every thread gets the result.
// buf is kWarps ints of shared memory.  One barrier: callers alternate two
// buffers, so a buffer is rewritten only after the next barrier, when every
// thread has read it.
template <class R>
__device__ __forceinline__ int tile_reduce(int v, int* buf) {
  v = R::warp(v);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  return R::op(R::op(buf[0], buf[1]), R::op(buf[2], buf[3]));
}

// Roll along axis 0 by a static shift, as jnp.roll / pltpu.roll:
// out[i] = in[(i - S) mod 8].  Register renaming, no instruction.
template <int S>
__device__ __forceinline__ void roll_rows(const int in[kSub], int out[kSub]) {
#pragma unroll
  for (int i = 0; i < kSub; ++i) out[i] = in[((i - S) % kSub + kSub) % kSub];
}

// Roll along axis 0 by a shift known only at run time: a switch over the 8
// static rolls, so the rows stay in registers.
__device__ __forceinline__ void roll_rows_dyn(const int in[kSub], int shift,
                                              int out[kSub]) {
  switch (floor_mod(shift, kSub)) {
    case 0: roll_rows<0>(in, out); break;
    case 1: roll_rows<1>(in, out); break;
    case 2: roll_rows<2>(in, out); break;
    case 3: roll_rows<3>(in, out); break;
    case 4: roll_rows<4>(in, out); break;
    case 5: roll_rows<5>(in, out); break;
    case 6: roll_rows<6>(in, out); break;
    default: roll_rows<7>(in, out); break;
  }
}

// take_along_axis along axis 0 for one element: v[i & 7], the register array
// indexed at run time.  Whether nvcc keeps it in registers (a select chain)
// or moves the array to local memory shows in the ptxas -v log as a stack
// frame; PERF.md records which.
__device__ __forceinline__ int sublane_gather(const int v[kSub], int i) {
  return v[i & (kSub - 1)];
}

}  // namespace b3d_probe
