// A grid sized by a count that lives on the device: the counterpart of
// scripts/try_dyngrid.py:run (:29), P5.
//
// The Pallas call runs a grid of n_active steps (a traced scalar), takes each
// step's tile id from a scalar-prefetched list, writes x * 2 + 1 into that
// tile and leaves the others as they are (the output aliases x).  Here the
// launch has max_tiles CTAs; each reads n_active and its tile id from device
// memory and returns when blockIdx.x >= n_active.  The host never reads
// n_active: that sync is what the probe exists to avoid, and it is the
// pattern of crop origins computed on the device.  The wrapper hands the
// kernel a copy of x (the JAX call is functional), so the kernel writes only
// the listed tiles.
//
// What bounds it: the launch of max_tiles CTAs, most of which exit after two
// loads; an active tile moves 8 KB.

#include <cstdint>

#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

using namespace b3d_probe;

__global__ void __launch_bounds__(kLane)
tile_list_kernel(const int32_t* __restrict__ x,
                 const int32_t* __restrict__ tile_list,
                 const int32_t* __restrict__ n_active,
                 int32_t* __restrict__ out, int num_tiles) {
  if (static_cast<int>(blockIdx.x) >= *n_active) return;
  const int t = tile_list[blockIdx.x];
  if (t < 0 || t >= num_tiles) return;  // ids outside x are skipped
  const size_t base = static_cast<size_t>(t) * kTile;
  int v[kSub];
  load_tile(x + base, v);
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    v[s] = static_cast<int>(static_cast<uint32_t>(v[s]) * 2u + 1u);
  }
  store_tile(out + base, v);
}

}  // namespace

// x, out: (num_tiles, 8, 128), out holding a copy of x; tile_list: at least
// max_tiles ids; n_active: one int32; all device pointers.  Returns
// cudaGetLastError() after the launch.
extern "C" int b3d_probe_dyngrid(const int32_t* x, const int32_t* tile_list,
                                 const int32_t* n_active, int32_t* out,
                                 int max_tiles, int num_tiles, void* stream) {
  if (max_tiles < 0 || num_tiles < 0) return b3d_probe::kBadArgument;
  return b3d_probe::launch(tile_list_kernel, max_tiles, stream, x, tile_list,
                           n_active, out, num_tiles);
}
