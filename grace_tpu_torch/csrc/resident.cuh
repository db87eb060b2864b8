// The grid of a resident launch: as many blocks as the SMs of the current
// device keep resident at once, so that a kernel's grid-stride loop runs
// every block from start to end and none waits for a slot. Shared by the
// kernels of quant.cu and wire.cu (each compiles its own copy).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace resident {

constexpr int kDevices = 64;    // devices whose counts a cache holds

// Blocks of `kernel` (launched with `threads` threads) that the SMs of
// device `dev` keep resident; 0 when the runtime cannot say.
template <typename Kernel>
unsigned int blocks(Kernel kernel, int threads, int dev) {
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess) {
    return 0;
  }
  return static_cast<unsigned int>(sms * (per_sm > 0 ? per_sm : 1));
}

// *out = min(want, the resident blocks of `kernel` on the current device),
// at least 1; `cache` (kDevices entries, zeroed, one array a kernel) keeps
// the count of each device after its first query.
template <typename Kernel>
cudaError_t grid(Kernel kernel, int threads, unsigned int* cache,
                 int64_t want, unsigned int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  unsigned int count = dev < kDevices ? cache[dev] : 0;
  if (count == 0) {
    count = blocks(kernel, threads, dev);
    if (count == 0) {
      err = cudaGetLastError();
      return err != cudaSuccess ? err : cudaErrorUnknown;
    }
    if (dev < kDevices) cache[dev] = count;
  }
  if (want < 1) want = 1;
  *out = static_cast<unsigned int>(want < count ? want : count);
  return cudaSuccess;
}

}  // namespace resident
