// Shared declarations of the port's CUDA kernels (sm_90a).
//
// Every entry point has a plain C interface so the library is built with
// nvcc alone and bound from Python with ctypes (ops/_build.py,
// ops/cuda_kernels.py): pointers and the stream arrive as void*, sizes as
// int64_t. An entry launches on the caller's stream (PyTorch's current
// stream), allocates nothing, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported to the wrapper.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define VT_EXPORT extern "C" __attribute__((visibility("default")))

namespace vt {

constexpr int32_t kInf = 0x7fffffff;  // "no hit" in the k-index minimum

// Opt a kernel into more than the default 48 KB of dynamic shared memory
// when it needs it; returns the error of the attribute call.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace vt
