// Host-side facts about the current device that a launch needs, each
// read once per device: the queries cost host time on every launch
// otherwise, which CUDA events around the kernel do not see. Several host
// threads may launch at once (one per encoder branch of a hype bin): the
// cache is atomic, and two threads that miss it together read the same
// value.

#pragma once

#include <atomic>
#include <cuda_runtime.h>

namespace {

// the current device's SM count
inline int sm_count(int* sms) {
  static std::atomic<int> cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) {
    const int known = cached[dev].load(std::memory_order_relaxed);
    if (known > 0) {
      *sms = known;
      return (int)cudaSuccess;
    }
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cached[dev].store(*sms, std::memory_order_relaxed);
  return (int)err;
}

}  // namespace
