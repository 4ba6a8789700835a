// Gathers, rolls, scratch round trips, one-hot counts and the serve trip:
// the counterparts of six scripts/ Mosaic probes, one C entry per
// pallas_call.
//
//   b3d_probe_axis0        scripts/try_axis0.py:run (:40)              P4
//   b3d_probe_vgather_run  scripts/try_vgather.py:run, its body (:62)  P6
//   b3d_probe_vgather8     try_vgather.py:main -> k_vgather (:82)      P7
//   b3d_probe_vgather16    try_vgather.py:main -> k_vgather16 (:90)    P8
//   b3d_probe_prim         scripts/prim_bench.py:run (:166)            P9
//   b3d_probe_roll24       scripts/repro_roll24.py:run (:45)           P12
//
// One (8, 128) tile per CTA of 128 threads, thread l holding column l
// (probe_common.cuh).  A gather along axis 0 is the thread's own registers:
// sublane_gather indexes the register array at run time, emul8 and the roll
// candidates are explicit compare-select chains.  A gather along axis 1
// reads another thread's column through shared memory.  The TPU's VMEM
// scratch is shared memory; its SMEM scalars (repro_roll24's offset) are read
// from device memory.  Counts are run-time arguments (see probe_tile.cu).
//
// The serve trip (prim_bench.py:68-127) keeps the plane block of its tile
// (80 x 128) in shared memory, so the TPU's aligned window load, its roll by
// -(q - q_al) and its static rolls by 24 - d become one address computation
// per row; each trip's 8 probe minima still come from the previous trip's
// remainders, so the chain the probe times stays dependent.
//
// What bounds them: like probe_tile.cu, the latency of dependent register,
// shared-memory and barrier chains on at most two waves of CTAs (one CTA
// for the single-tile probes), not device-memory bytes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

using namespace b3d_probe;

// ---------------------------------------------------------------- P4 axis0

enum Axis0Mode { kAxis0, kEmul8, kAxis1, kNumAxis0Modes };

template <int MODE>
__global__ void __launch_bounds__(kLane)
axis0_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
             int32_t* __restrict__ out, int reps) {
  __shared__ int s_lanes[2][kSub][kLane];
  const int l = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  int xv[kSub], i8[kSub], acc[kSub];
  load_tile(x + base, xv);
  load_tile(idx + base, i8);
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    i8[s] &= kSub - 1;  // idx % 8 (floor modulo)
    acc[s] = 0;
  }
  for (int rep = 0; rep < reps; ++rep) {
    int v[kSub];
#pragma unroll
    for (int r = 0; r < kSub; ++r) v[r] = wrap_add(xv[r], rep);
    if constexpr (MODE == kAxis0) {
#pragma unroll
      for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(acc[s], sublane_gather(v, i8[s]));
    } else if constexpr (MODE == kEmul8) {
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        int g = 0;
#pragma unroll
        for (int r = 0; r < kSub; ++r) g = i8[s] == r ? v[r] : g;
        acc[s] = wrap_add(acc[s], g);
      }
    } else {  // kAxis1: lanes 0..7 of the row, through shared memory
      int(*buf)[kLane] = s_lanes[rep & 1];
#pragma unroll
      for (int s = 0; s < kSub; ++s) buf[s][l] = v[s];
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(acc[s], buf[s][i8[s]]);
    }
  }
  store_tile(out + base, acc);
}

// ---------------------------------------------------------------- P6-P8 vgather

enum VgatherMode { kV8, kRollSelect, kH, kNumVgatherModes };

// o += gather(v, idx ^ (o % 2)), reps times on one tile; v8 along axis 0,
// roll as 8 roll candidates and a select (the pattern of k_rolls, which no
// pallas_call of the script reaches), h along axis 1.
template <int MODE>
__global__ void __launch_bounds__(kLane)
vgather_run_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
                   int32_t* __restrict__ out, int reps) {
  __shared__ int s_v[kSub][kLane];
  const int l = threadIdx.x;
  int v[kSub], ix[kSub], o[kSub];
  load_tile(x, v);
  load_tile(idx, ix);
#pragma unroll
  for (int s = 0; s < kSub; ++s) o[s] = 0;
  if constexpr (MODE == kH) {
#pragma unroll
    for (int s = 0; s < kSub; ++s) s_v[s][l] = v[s];
    __syncthreads();
  }
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const int iv = ix[s] ^ (o[s] & 1);  // idx ^ (o % 2)
      if constexpr (MODE == kV8) {
        o[s] = wrap_add(o[s], sublane_gather(v, iv));
      } else if constexpr (MODE == kRollSelect) {
        // candidate k2 is roll(v, (8 - k2) % 8, 0): row s reads v[(s + k2) % 8]
        int a = 0;
#pragma unroll
        for (int k2 = 0; k2 < kSub; ++k2) a = iv == k2 ? v[(s + k2) % kSub] : a;
        o[s] = wrap_add(o[s], a);
      } else {
        o[s] = wrap_add(o[s], s_v[s][iv & (kLane - 1)]);
      }
    }
  }
  store_tile(out, o);
}

__global__ void __launch_bounds__(kLane)
vgather8_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
                int32_t* __restrict__ out) {
  int v[kSub], ix[kSub], o[kSub];
  load_tile(x, v);
  load_tile(idx, ix);
#pragma unroll
  for (int s = 0; s < kSub; ++s) o[s] = sublane_gather(v, ix[s]);
  store_tile(out, o);
}

// out[s, l] = x[idx[s, l], l] over 16 rows: two 8-row gathers and a select
__global__ void __launch_bounds__(kLane)
vgather16_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
                 int32_t* __restrict__ out) {
  int lo[kSub], hi[kSub], ix[kSub], o[kSub];
  load_tile(x, lo);
  load_tile(x + kTile, hi);
  load_tile(idx, ix);
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    const int i8 = ix[s] & (kSub - 1);  // idx % 8
    o[s] = ix[s] < kSub ? sublane_gather(lo, i8) : sublane_gather(hi, i8);
  }
  store_tile(out, o);
}

// ---------------------------------------------------------------- P9 prim

enum PrimOp {
  kShufDep, kShufIndep, kRollIndep, kScratchRt, kOnehot,
  kServeTrip1, kServeTrip2, kServeTrip4, kServeTrip8, kNumPrimOps,
};
constexpr int kPlaneRows = 64;                     // prim_bench.py PLANE_ROWS
constexpr int kPlaneBlock = kPlaneRows + 2 * kSub;  // rows of a plane block
constexpr int kPlanes = 4;                          // tile t reads plane t % 4
constexpr int kProbes = 8;
constexpr int kBig = 1 << 29;

template <int OP>
__global__ void __launch_bounds__(kLane)
prim_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
            int32_t* __restrict__ out, int k) {
  __shared__ int s_lanes[2][kSub][kLane];
  __shared__ int s_scr[2][kSub][kWarps];  // the (8, 64) VMEM scratch
  const int l = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  int xv[kSub], ix[kSub], acc[kSub];
  load_tile(x + base, xv);
  load_tile(idx + base, ix);
#pragma unroll
  for (int s = 0; s < kSub; ++s) acc[s] = xv[s];

  if constexpr (OP == kShufDep) {
    for (int it = 0; it < k; ++it) {
      int(*buf)[kLane] = s_lanes[it & 1];
#pragma unroll
      for (int s = 0; s < kSub; ++s) buf[s][l] = acc[s] & 127;
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kSub; ++s) acc[s] = buf[s][ix[s] & (kLane - 1)];
    }
  } else if constexpr (OP == kShufIndep) {
    // shuffles of the k sources x + i; none reads another's result
    for (int i = 0; i < k; ++i) {
      int(*buf)[kLane] = s_lanes[i & 1];
#pragma unroll
      for (int s = 0; s < kSub; ++s) buf[s][l] = wrap_add(xv[s], i);
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        acc[s] = wrap_add(acc[s], buf[s][ix[s] & (kLane - 1)]);
      }
    }
  } else if constexpr (OP == kRollIndep) {
    for (int i = 0; i < k; ++i) {
      int src[kSub], r[kSub];
#pragma unroll
      for (int s = 0; s < kSub; ++s) src[s] = wrap_add(xv[s], i);
      roll_rows_dyn(src, 1 + i % 7, r);
#pragma unroll
      for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(acc[s], r[s]);
    }
  } else if constexpr (OP == kScratchRt) {
    // row mins -> scratch column 0 -> scalar scratch[0, 0] -> acc
    for (int i = 0; i < k; ++i) {
      int(*scr)[kWarps] = s_scr[i & 1];
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        const int m = Min::warp(acc[s]);
        if ((l & 31) == 0) scr[s][l >> 5] = m;
      }
      __syncthreads();
      const int s0 = min(min(scr[0][0], scr[0][1]), min(scr[0][2], scr[0][3]));
#pragma unroll
      for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(acc[s], s0);
    }
  } else if constexpr (OP == kOnehot) {
    // flat = x.reshape(1024) & 127, taken once; each i counts, for each of
    // the 512 first columns c, the rows r < 128 with flat[c] + i == r, in
    // float32, and adds the counts of columns 0..127 to every row.  Thread l
    // owns columns l, 128 + l, 256 + l and 384 + l (rows 0..3 of its column).
    int flat[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) flat[c] = xv[c] & 127;
    for (int i = 0; i < k; ++i) {
      float cnt[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int f = wrap_add(flat[c], i);
        float n = 0.0f;
        for (int r = 0; r < kLane; ++r) n = __fadd_rn(n, f == r ? 1.0f : 0.0f);
        cnt[c] = n;
      }
      const int add = __float2int_rz(cnt[0]);
#pragma unroll
      for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(acc[s], add);
    }
  }
  store_tile(out + base, acc);
}

// min over the tile of each probe's remainders, through the scratch with one
// barrier (prim_bench.py batched_mins)
__device__ __forceinline__ void batched_mins(const int rem[kProbes][kSub],
                                             int (*scr)[kWarps],
                                             int ms[kProbes]) {
#pragma unroll
  for (int p = 0; p < kProbes; ++p) {
    const int m = Min::warp(fold<Min>(rem[p]));
    if ((threadIdx.x & 31) == 0) scr[p][threadIdx.x >> 5] = m;
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kProbes; ++p) {
    ms[p] = min(min(scr[p][0], scr[p][1]), min(scr[p][2], scr[p][3]));
  }
}

// prim_bench.py serve_trip_S: k trips of 8 probes serving S cells each.
template <int S>
__global__ void __launch_bounds__(kLane)
serve_trip_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
                  const int32_t* __restrict__ plane, int32_t* __restrict__ out,
                  int k) {
  __shared__ int s_plane[kPlaneBlock][kLane];
  __shared__ int s_scr[2][kProbes][kWarps];
  const int l = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  const int32_t* pl = plane + static_cast<size_t>(blockIdx.x % kPlanes) * kPlaneBlock * kLane;
  for (int r = 0; r < kPlaneBlock; ++r) s_plane[r][l] = pl[r * kLane + l];
  int xv[kSub], ix[kSub];
  load_tile(x + base, xv);
  load_tile(idx + base, ix);
  int rem[kProbes][kSub], accp[kProbes][kSub], ms[kProbes];
#pragma unroll
  for (int p = 0; p < kProbes; ++p) {
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      rem[p][s] = floor_mod(wrap_add(xv[s], 131 * p), 997);
      accp[p][s] = 0;
    }
  }
  batched_mins(rem, s_scr[0], ms);  // its barrier also publishes s_plane
  for (int trip = 0; trip < k; ++trip) {
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
      const int m = ms[p];
      const int q = min(max(floor_div(m, 4), 0), kPlaneRows - 3 * kSub);
      const int q_al = floor_div(q, kSub) * kSub;
      const int sh = q - q_al;  // the window is rolled by -(q - q_al)
      const bool live = m < kBig;
#pragma unroll
      for (int d = 0; d < S; ++d) {
        const int want = wrap_add(m, d);
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          // row s of roll(roll(window, -sh), 24 - d): window row (s + d + sh) % 24
          const int row = q_al + floor_mod(s + d + sh, 3 * kSub);
          const int v = s_plane[row][ix[s] & (kLane - 1)];
          const bool hit = rem[p][s] == want && live;
          accp[p][s] = hit ? v : accp[p][s];
          rem[p][s] = hit ? kBig : rem[p][s];
        }
      }
#pragma unroll
      for (int s = 0; s < kSub; ++s) rem[p][s] = wrap_add(rem[p][s], 1);
    }
    batched_mins(rem, s_scr[(trip + 1) & 1], ms);
  }
  int acc[kSub];
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    acc[s] = xv[s];
#pragma unroll
    for (int p = 0; p < kProbes; ++p) acc[s] = wrap_add(acc[s], accp[p][s]);
  }
  store_tile(out + base, acc);
}

// ---------------------------------------------------------------- P12 roll24

constexpr int kLoad = 24;  // repro_roll24.py NLOAD

// out[i] = x[(i + off + d) mod 24]: the dynamic roll by -off, then the
// static roll by 24 - d, rows 0..7; off is read from device memory.
__global__ void __launch_bounds__(kLane)
roll24_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ off,
              int32_t* __restrict__ out, int d) {
  const long long o = off[0];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const long long r = (i + o + d) % kLoad;
    const int row = static_cast<int>(r < 0 ? r + kLoad : r);
    out[i * kLane + threadIdx.x] = x[row * kLane + threadIdx.x];
  }
}

}  // namespace

// All pointers are device pointers to contiguous int32 arrays.  Each entry
// returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a mode it does not know.

// x, idx, out: (nt, 8, 128)
extern "C" int b3d_probe_axis0(const int32_t* x, const int32_t* idx,
                               int32_t* out, int nt, int mode, int reps,
                               void* stream) {
  switch (mode) {
    case kAxis0: return launch(axis0_kernel<kAxis0>, nt, stream, x, idx, out, reps);
    case kEmul8: return launch(axis0_kernel<kEmul8>, nt, stream, x, idx, out, reps);
    case kAxis1: return launch(axis0_kernel<kAxis1>, nt, stream, x, idx, out, reps);
    default: return kBadArgument;
  }
}

// x, idx, out: (8, 128)
extern "C" int b3d_probe_vgather_run(const int32_t* x, const int32_t* idx,
                                     int32_t* out, int mode, int reps,
                                     void* stream) {
  switch (mode) {
    case kV8: return launch(vgather_run_kernel<kV8>, 1, stream, x, idx, out, reps);
    case kRollSelect: return launch(vgather_run_kernel<kRollSelect>, 1, stream, x, idx, out, reps);
    case kH: return launch(vgather_run_kernel<kH>, 1, stream, x, idx, out, reps);
    default: return kBadArgument;
  }
}

// x, idx, out: (8, 128)
extern "C" int b3d_probe_vgather8(const int32_t* x, const int32_t* idx,
                                  int32_t* out, void* stream) {
  return launch(vgather8_kernel, 1, stream, x, idx, out);
}

// x: (16, 128); idx, out: (8, 128)
extern "C" int b3d_probe_vgather16(const int32_t* x, const int32_t* idx,
                                   int32_t* out, void* stream) {
  return launch(vgather16_kernel, 1, stream, x, idx, out);
}

// x, idx, out: (nt, 8, 128); plane: (4, 80, 128)
extern "C" int b3d_probe_prim(const int32_t* x, const int32_t* idx,
                              const int32_t* plane, int32_t* out, int nt,
                              int op, int k, void* stream) {
  switch (op) {
    case kShufDep: return launch(prim_kernel<kShufDep>, nt, stream, x, idx, out, k);
    case kShufIndep: return launch(prim_kernel<kShufIndep>, nt, stream, x, idx, out, k);
    case kRollIndep: return launch(prim_kernel<kRollIndep>, nt, stream, x, idx, out, k);
    case kScratchRt: return launch(prim_kernel<kScratchRt>, nt, stream, x, idx, out, k);
    case kOnehot: return launch(prim_kernel<kOnehot>, nt, stream, x, idx, out, k);
    case kServeTrip1: return launch(serve_trip_kernel<1>, nt, stream, x, idx, plane, out, k);
    case kServeTrip2: return launch(serve_trip_kernel<2>, nt, stream, x, idx, plane, out, k);
    case kServeTrip4: return launch(serve_trip_kernel<4>, nt, stream, x, idx, plane, out, k);
    case kServeTrip8: return launch(serve_trip_kernel<8>, nt, stream, x, idx, plane, out, k);
    default: return kBadArgument;
  }
}

// x: (24, 128); off: (1, 1); out: (8, 128)
extern "C" int b3d_probe_roll24(const int32_t* x, const int32_t* off,
                                int32_t* out, int d, void* stream) {
  return launch(roll24_kernel, 1, stream, x, off, out, d);
}
