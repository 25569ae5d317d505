// Device phase stamp: one thread reads the card's global nanosecond timer and
// charges the time since the previous stamp to one phase's accumulator.
//
// Replaces no TPU kernel: the JAX package times its phases from the host
// around jitted calls, which a CUDA graph replay does not allow (a host range
// cannot see inside a replay, and CUDA timing events recorded into a graph are
// overwritten by the next replay before the host reads them). This kernel
// sits between the graph's kernels on their stream, so it starts when the work
// enqueued before it has finished, and it is replayed with the graph.
// Bound by launch latency (one thread, four 8-byte accesses).
//
// acc: int64 [1 + 2 * phases]: acc[0] the last stamp (ns), then each phase's
// (ns, count). slot < 0 restarts the clock and charges nothing.

#include <cuda_runtime.h>

__global__ void phase_stamp_kernel(long long* acc, int slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long t = static_cast<long long>(now);
  if (slot >= 0) {
    acc[1 + 2 * slot] += t - acc[0];
    acc[2 + 2 * slot] += 1;
  }
  acc[0] = t;
}

extern "C" int phase_stamp(void* acc, int slot, void* stream) {
  phase_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(acc), slot);
  return static_cast<int>(cudaGetLastError());
}
