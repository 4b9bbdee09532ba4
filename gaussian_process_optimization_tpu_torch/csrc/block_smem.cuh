// Dynamic shared memory of the block kernels (chol_blocks.cu, tri_inv.cu),
// which size it from the block edge nb: each entry point asks here before it
// launches, so the size is known in one place, the kernel's own source.
#pragma once

#include <cuda_runtime.h>

// What an entry point returns, having launched nothing, when one thread block
// would need more shared memory than the current device lets it opt in to
// (ops/_build.py raises on it).
constexpr int kSmemDoesNotFit = -1;

// Lets `kernel` take `smem` bytes of dynamic shared memory. Returns 0,
// kSmemDoesNotFit, or the CUDA error of the device query or the attribute.
template <typename Kernel>
int opt_in_smem(Kernel* kernel, size_t smem) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(limit)) return kSmemDoesNotFit;
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}
