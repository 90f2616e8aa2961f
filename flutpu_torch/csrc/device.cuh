// Host-side facts about the current device that a launch needs, each
// read once per device: the queries cost host time on every launch
// otherwise, which CUDA events around the kernel do not see.

#pragma once

#include <cuda_runtime.h>

namespace {

// the current device's SM count
inline int sm_count(int* sms) {
  static int cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && cached[dev] > 0) {
    *sms = cached[dev];
    return (int)cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cached[dev] = *sms;
  return (int)err;
}

}  // namespace
