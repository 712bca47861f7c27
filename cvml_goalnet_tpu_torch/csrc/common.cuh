// Shared by every kernel library of the port: each csrc/<name>.cu is one
// translation unit built into its own shared library, so the definition
// below appears once per library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* goalnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory a block may take on Hopper (227 KB).
constexpr size_t kMaxSmemBytes = 232448;

// SMs of the current card (the wrappers make the input's card current before
// every launch).
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Opt a kernel into more than 48 KB of dynamic shared memory (up to
// kMaxSmemBytes).  Returns the CUDA error code.
template <typename Kernel>
static int allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}
