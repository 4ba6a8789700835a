// Stage stamps of a captured frame program: the device side of
// runtime/pipeline.py:stage, which splits each replay of a frame graph into
// its stages (front, eval, meanshift, heights) with no host work per replay.
// Not a port of a TPU kernel: the JAX package reads its stages from XLA's
// profile.
//
// b3d_stage_stamp, called while `stream` captures a graph (the frame graph,
// or a body of one of its conditional nodes), appends one launch of a
// one-thread kernel.  At each replay the kernel reads the card's global
// nanosecond timer (%globaltimer) and
//
//   * at a replay's first stamp (`first` != 0) adds one to acc[max_stages],
//     the replays;
//   * at any later stamp adds the time since the previous stamp of the same
//     replay to acc[stage], `stage` being the one the previous stamp opened;
//
// then keeps the time and `opening` (the stage that starts here; -1 at the
// last stamp) in clock[0] and clock[1].  `clock` belongs to one graph, so a
// replay's stamps run in the graph's own order; `acc` is shared by every
// graph of one program on one card, so it is added to atomically.  The
// kernel follows the node before it and precedes the node after it, so a
// stage's time is the card's wall time from the end of the stage before it
// to its own end, gaps between its kernels included.
//
// %globaltimer ticks in ns, but may advance in steps of up to about 1 us;
// the stages are read as means over many replays.

#include <cuda_runtime.h>

namespace {

__global__ void stage_stamp_kernel(long long* clock,
                                   unsigned long long* acc, int opening,
                                   int first, int max_stages) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (first) {
    atomicAdd(&acc[max_stages], 1ull);
  } else {
    const long long ending = clock[1];
    if (ending >= 0 && ending < max_stages)
      atomicAdd(&acc[ending], now - static_cast<unsigned long long>(clock[0]));
  }
  clock[0] = static_cast<long long>(now);
  clock[1] = opening;
}

}  // namespace

extern "C" int b3d_stage_stamp(void* stream, void* clock, void* acc,
                               int opening, int first, int max_stages) {
  stage_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(clock), static_cast<unsigned long long*>(acc),
      opening, first, max_stages);
  return cudaGetLastError();
}
