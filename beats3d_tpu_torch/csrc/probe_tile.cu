// Op chains on one (8, 128) int32 tile: the counterparts of five scripts/
// Mosaic probes, one C entry per pallas_call.
//
//   b3d_probe_opcost     scripts/try_opcost.py:run (:58)      P11
//   b3d_probe_reduce     scripts/try_reduce.py:run (:47)      P1
//   b3d_probe_loopcost   scripts/try_loopcost.py:run (:30)    P2
//   b3d_probe_loopcost2  scripts/try_loopcost2.py:run (:46)   P3
//   b3d_probe_batchmin   scripts/try_batchmin.py:run (:58)    P10
//
// Each grid step of the Pallas kernel is one CTA of 128 threads here, thread
// l holding column l of its tile (probe_common.cuh).  The count (k, n_loops,
// reps) is a run-time argument and the op a template parameter chosen by a
// switch on the host: a compile-time count would let nvcc fold a chain of
// +1s into one add and the per-op times would mean nothing.  Where nvcc
// still removes work (a trip count of max(x) * 0 + 1, a loop-invariant
// gather), it removes it on the card too; PERF.md reports what the card did.
//
// What bounds them: a probe is a chain of dependent register operations,
// shared-memory round trips and barriers on 64-256 tiles, at most two waves
// of CTAs on 132 SMs, and it moves 4-8 KB of device memory per tile.  So the
// time is the chain's latency plus the launch; the scripts difference two
// counts to take the launch out.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

using namespace b3d_probe;

// ---------------------------------------------------------------- P11 opcost

enum OpcostOp {
  kOpGather, kOpGatherSame, kOpWhere, kOpFmath, kOpAny, kOpMinmax, kOpRoll,
  kOpBcastRow, kNumOpcostOps,
};

template <int OP>
__global__ void __launch_bounds__(kLane)
opcost_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
              int32_t* __restrict__ out, int k) {
  __shared__ int s_lanes[2][kSub][kLane];
  __shared__ int s_red[2][2][kWarps];
  const int l = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  int xv[kSub], ix[kSub], acc[kSub];
  load_tile(x + base, xv);
  load_tile(idx + base, ix);
#pragma unroll
  for (int s = 0; s < kSub; ++s) acc[s] = xv[s];

  if constexpr (OP == kOpGather) {
    // acc = take_along_axis(acc & 127, idx, axis=1), k times, dependent
    for (int it = 0; it < k; ++it) {
      int(*buf)[kLane] = s_lanes[it & 1];
#pragma unroll
      for (int s = 0; s < kSub; ++s) buf[s][l] = acc[s] & 127;
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kSub; ++s) acc[s] = buf[s][ix[s] & (kLane - 1)];
    }
  } else if constexpr (OP == kOpGatherSame) {
    // acc += take_along_axis(x, idx, axis=1), k times, one source
#pragma unroll
    for (int s = 0; s < kSub; ++s) s_lanes[0][s][l] = xv[s];
    __syncthreads();
    for (int it = 0; it < k; ++it) {
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        acc[s] = wrap_add(acc[s], s_lanes[0][s][ix[s] & (kLane - 1)]);
      }
    }
  } else if constexpr (OP == kOpWhere) {
    for (int it = 0; it < k; ++it) {
#pragma unroll
      for (int s = 0; s < kSub; ++s) acc[s] = xv[s] > 5 ? wrap_add(acc[s], 1) : acc[s];
    }
  } else if constexpr (OP == kOpFmath) {
    // a = floor((1.5 * a) / (f + 3)), f = float(x) + 2, in JAX's order
    float f[kSub], a[kSub];
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      f[s] = __fadd_rn(__int2float_rn(xv[s]), 2.0f);
      a[s] = f[s];
    }
    for (int it = 0; it < k; ++it) {
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        a[s] = floorf(__fdiv_rn(__fmul_rn(1.5f, a[s]), __fadd_rn(f[s], 3.0f)));
      }
    }
#pragma unroll
    for (int s = 0; s < kSub; ++s) acc[s] = __float2int_rz(a[s]);
  } else if constexpr (OP == kOpAny) {
    for (int it = 0; it < k; ++it) {
      int any = 0;
#pragma unroll
      for (int s = 0; s < kSub; ++s) any |= acc[s] > 0;
      const int t = tile_reduce<Or>(any, s_red[it & 1][0]);
#pragma unroll
      for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(acc[s], t);
    }
  } else if constexpr (OP == kOpMinmax) {
    // acc += min(acc) + max(acc): both reduces share one barrier
    for (int it = 0; it < k; ++it) {
      const int mn = Min::warp(fold<Min>(acc));
      const int mx = Max::warp(fold<Max>(acc));
      int* bmin = s_red[it & 1][0];
      int* bmax = s_red[it & 1][1];
      if ((l & 31) == 0) {
        bmin[l >> 5] = mn;
        bmax[l >> 5] = mx;
      }
      __syncthreads();
      const int t = wrap_add(min(min(bmin[0], bmin[1]), min(bmin[2], bmin[3])),
                             max(max(bmax[0], bmax[1]), max(bmax[2], bmax[3])));
#pragma unroll
      for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(acc[s], t);
    }
  } else if constexpr (OP == kOpRoll) {
    for (int it = 0; it < k; ++it) {
      int r[kSub];
      roll_rows<1>(acc, r);
#pragma unroll
      for (int s = 0; s < kSub; ++s) acc[s] = r[s];
    }
  } else if constexpr (OP == kOpBcastRow) {
    for (int it = 0; it < k; ++it) {
      const int row = acc[0];
#pragma unroll
      for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(acc[s], row);
    }
  }
  store_tile(out + base, acc);
}

// ---------------------------------------------------------------- P1 reduce

enum ReduceMode {
  kIndepReduce, kSerialReduce, kStaticLoop, kDynLoop, kDynLoop1Red,
  kNumReduceModes,
};

// min over the tile of x + c (wrapping), every thread gets it
__device__ __forceinline__ int tile_min_plus(const int xv[kSub], int c, int* buf) {
  int m = INT_MAX;
#pragma unroll
  for (int s = 0; s < kSub; ++s) m = min(m, wrap_add(xv[s], c));
  return tile_reduce<Min>(m, buf);
}

template <int MODE>
__global__ void __launch_bounds__(kLane)
reduce_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int k) {
  __shared__ int s_red[2][kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  int xv[kSub], acc[kSub];
  load_tile(x + base, xv);
#pragma unroll
  for (int s = 0; s < kSub; ++s) acc[s] = xv[s];

  if constexpr (MODE == kIndepReduce) {
    // k reduces whose scalars meet only in the sum
    int tot = 0;
    for (int i = 0; i < k; ++i) tot = wrap_add(tot, tile_min_plus(xv, i, s_red[i & 1]));
#pragma unroll
    for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(xv[s], tot);
  } else if constexpr (MODE == kSerialReduce) {
    int sc = 0;
    for (int i = 0; i < k; ++i) sc = tile_min_plus(xv, sc, s_red[i & 1]);
#pragma unroll
    for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(xv[s], sc);
  } else if constexpr (MODE == kStaticLoop) {
    // the 4-trip loop is static and meant to unroll
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(acc[s], 1);
      }
    }
  } else if constexpr (MODE == kDynLoop) {
    const int lo = tile_reduce<Min>(fold<Min>(xv), s_red[0]) * 0;  // "dynamic" 0
    for (int i = 0; i < k; ++i) {
      for (int j = lo; j < lo + 4; ++j) {
#pragma unroll
        for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(acc[s], 1);
      }
    }
  } else if constexpr (MODE == kDynLoop1Red) {
    for (int i = 0; i < k; ++i) {
      const int lo = tile_reduce<Min>(fold<Min>(acc), s_red[i & 1]) * 0;
      for (int j = lo; j < lo + 4; ++j) {
#pragma unroll
        for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(acc[s], 1);
      }
    }
  }
  store_tile(out + base, acc);
}

// ---------------------------------------------------------------- P2 loopcost

template <bool DYN>
__global__ void __launch_bounds__(kLane)
loopcost_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                int n_loops) {
  __shared__ int s_red[kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  int acc[kSub];
  load_tile(x + base, acc);
  // the data-derived trip count min(max(acc) * 0 + 1, 1)
  const int t = min(tile_reduce<Max>(fold<Max>(acc), s_red) * 0 + 1, 1);
  for (int i = 0; i < n_loops; ++i) {
    if constexpr (DYN) {
      for (int j = 0; j < t; ++j) {
#pragma unroll
        for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(acc[s], 1);
      }
    } else {
#pragma unroll
      for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(acc[s], 1);
    }
  }
  store_tile(out + base, acc);
}

// ---------------------------------------------------------------- P3 loopcost2

enum Loopcost2Mode { kNoloop, kFlat, kNested, kDiv, kNumLoopcost2Modes };

template <int MODE, int NC>
__global__ void __launch_bounds__(kLane)
loopcost2_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                 int n_loops) {
  __shared__ int s_red[kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  int xv[kSub];
  load_tile(x + base, xv);
  const int t = min(tile_reduce<Max>(fold<Max>(xv), s_red) * 0 + 1, 1);
  int c[NC][kSub];  // the NC vreg carries x + i
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int s = 0; s < kSub; ++s) c[i][s] = wrap_add(xv[s], i);
  }
  auto bump = [&]() {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
#pragma unroll
      for (int s = 0; s < kSub; ++s) c[i][s] = wrap_add(c[i][s], 1);
    }
  };
  int acc[kSub];
  if constexpr (MODE == kDiv) {
    // a_i = f + i, f = float(x) + 3; a = floor((a + 1) / f), n_loops times;
    // the 4 results (truncated to int) replace the first carries
    float f[kSub], a[4][kSub];
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      f[s] = __fadd_rn(__int2float_rn(xv[s]), 3.0f);
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i][s] = __fadd_rn(f[s], static_cast<float>(i));
    }
    for (int n = 0; n < n_loops; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          a[i][s] = floorf(__fdiv_rn(__fadd_rn(a[i][s], 1.0f), f[s]));
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      acc[s] = __float2int_rz(a[0][s]);
#pragma unroll
      for (int i = 1; i < 4; ++i) acc[s] = wrap_add(acc[s], __float2int_rz(a[i][s]));
#pragma unroll
      for (int i = 4; i < NC; ++i) acc[s] = wrap_add(acc[s], c[i][s]);
    }
  } else {
    for (int n = 0; n < n_loops; ++n) {
      if constexpr (MODE == kNoloop) {
        bump();
      } else if constexpr (MODE == kFlat) {
        for (int j = 0; j < t; ++j) bump();
      } else {  // kNested
        for (int j = 0; j < t; ++j) {
          for (int j2 = 0; j2 < t; ++j2) bump();
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      acc[s] = c[0][s];
#pragma unroll
      for (int i = 1; i < NC; ++i) acc[s] = wrap_add(acc[s], c[i][s]);
    }
  }
  store_tile(out + base, acc);
}

// ---------------------------------------------------------------- P10 batchmin

enum BatchminMode { kBase, kBatched, kNumBatchminModes };
constexpr int kProbes = 8;  // try_batchmin.py NPROBE: 16 scalars per rep

template <int MODE>
__global__ void __launch_bounds__(kLane)
batchmin_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                int reps) {
  __shared__ int s_red[2][kWarps];                 // base: one reduce each
  __shared__ int s_scr[2][2 * kProbes][kWarps];    // batched: the VMEM scratch
  const int l = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  int xv[kSub], acc[kSub];
  load_tile(x + base, xv);
#pragma unroll
  for (int s = 0; s < kSub; ++s) acc[s] = xv[s];
  // arrs[i] = x + i; mins j < 8 of rep are min(arrs[j] + rep), j >= 8
  // min(arrs[j - 8] + rep + 1)
  for (int rep = 0; rep < reps; ++rep) {
    int sum = 0;
    if constexpr (MODE == kBase) {
      // 16 separate full-tile reduces, one barrier each
#pragma unroll
      for (int j = 0; j < 2 * kProbes; ++j) {
        int m = INT_MAX;
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          m = min(m, wrap_add(wrap_add(xv[s], j % kProbes), rep + j / kProbes));
        }
        sum = wrap_add(sum, tile_reduce<Min>(m, s_red[j & 1]));
      }
    } else {
      // axis-0 mins in the thread, the axis-1 mins in the warp, the 16
      // scalars through the scratch with one barrier
      int(*scr)[kWarps] = s_scr[rep & 1];
#pragma unroll
      for (int j = 0; j < 2 * kProbes; ++j) {
        int m = INT_MAX;
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          m = min(m, wrap_add(wrap_add(xv[s], j % kProbes), rep + j / kProbes));
        }
        m = Min::warp(m);
        if ((l & 31) == 0) scr[j][l >> 5] = m;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 2 * kProbes; ++j) {
        sum = wrap_add(sum, min(min(scr[j][0], scr[j][1]), min(scr[j][2], scr[j][3])));
      }
    }
#pragma unroll
    for (int s = 0; s < kSub; ++s) acc[s] = wrap_add(acc[s], sum);
  }
  store_tile(out + base, acc);
}

}  // namespace

// All pointers are device pointers to contiguous int32 arrays of nt (8, 128)
// tiles; out has x's shape.  Each entry returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an op it does not know.

extern "C" int b3d_probe_opcost(const int32_t* x, const int32_t* idx,
                                int32_t* out, int nt, int op, int k,
                                void* stream) {
  switch (op) {
    case kOpGather: return launch(opcost_kernel<kOpGather>, nt, stream, x, idx, out, k);
    case kOpGatherSame: return launch(opcost_kernel<kOpGatherSame>, nt, stream, x, idx, out, k);
    case kOpWhere: return launch(opcost_kernel<kOpWhere>, nt, stream, x, idx, out, k);
    case kOpFmath: return launch(opcost_kernel<kOpFmath>, nt, stream, x, idx, out, k);
    case kOpAny: return launch(opcost_kernel<kOpAny>, nt, stream, x, idx, out, k);
    case kOpMinmax: return launch(opcost_kernel<kOpMinmax>, nt, stream, x, idx, out, k);
    case kOpRoll: return launch(opcost_kernel<kOpRoll>, nt, stream, x, idx, out, k);
    case kOpBcastRow: return launch(opcost_kernel<kOpBcastRow>, nt, stream, x, idx, out, k);
    default: return kBadArgument;
  }
}

extern "C" int b3d_probe_reduce(const int32_t* x, int32_t* out, int nt,
                                int mode, int k, void* stream) {
  switch (mode) {
    case kIndepReduce: return launch(reduce_kernel<kIndepReduce>, nt, stream, x, out, k);
    case kSerialReduce: return launch(reduce_kernel<kSerialReduce>, nt, stream, x, out, k);
    case kStaticLoop: return launch(reduce_kernel<kStaticLoop>, nt, stream, x, out, k);
    case kDynLoop: return launch(reduce_kernel<kDynLoop>, nt, stream, x, out, k);
    case kDynLoop1Red: return launch(reduce_kernel<kDynLoop1Red>, nt, stream, x, out, k);
    default: return kBadArgument;
  }
}

extern "C" int b3d_probe_loopcost(const int32_t* x, int32_t* out, int nt,
                                  int dyn, int n_loops, void* stream) {
  return dyn ? launch(loopcost_kernel<true>, nt, stream, x, out, n_loops)
             : launch(loopcost_kernel<false>, nt, stream, x, out, n_loops);
}

template <int MODE>
static int loopcost2_carries(const int32_t* x, int32_t* out, int nt,
                             int n_loops, int n_carries, void* stream) {
  switch (n_carries) {
    case 1: return launch(loopcost2_kernel<MODE, 1>, nt, stream, x, out, n_loops);
    case 2: return launch(loopcost2_kernel<MODE, 2>, nt, stream, x, out, n_loops);
    case 4: return launch(loopcost2_kernel<MODE, 4>, nt, stream, x, out, n_loops);
    case 8: return launch(loopcost2_kernel<MODE, 8>, nt, stream, x, out, n_loops);
    case 16: return launch(loopcost2_kernel<MODE, 16>, nt, stream, x, out, n_loops);
    default: return kBadArgument;
  }
}

// n_carries is one of 1, 2, 4, 8, 16 (a register array needs its size at
// compile time).
extern "C" int b3d_probe_loopcost2(const int32_t* x, int32_t* out, int nt,
                                   int mode, int n_loops, int n_carries,
                                   void* stream) {
  switch (mode) {
    case kNoloop: return loopcost2_carries<kNoloop>(x, out, nt, n_loops, n_carries, stream);
    case kFlat: return loopcost2_carries<kFlat>(x, out, nt, n_loops, n_carries, stream);
    case kNested: return loopcost2_carries<kNested>(x, out, nt, n_loops, n_carries, stream);
    case kDiv: return loopcost2_carries<kDiv>(x, out, nt, n_loops, n_carries, stream);
    default: return kBadArgument;
  }
}

extern "C" int b3d_probe_batchmin(const int32_t* x, int32_t* out, int nt,
                                  int mode, int reps, void* stream) {
  switch (mode) {
    case kBase: return launch(batchmin_kernel<kBase>, nt, stream, x, out, reps);
    case kBatched: return launch(batchmin_kernel<kBatched>, nt, stream, x, out, reps);
    default: return kBadArgument;
  }
}
