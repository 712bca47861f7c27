// Shared by every kernel library of the port: each csrc/<name>.cu is one
// translation unit built into its own shared library, so the definition
// below appears once per library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* goalnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Opt a kernel into more than 48 KB of dynamic shared memory (Hopper allows
// up to 227 KB per block).  Returns the CUDA error code.
template <typename Kernel>
static int allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}
