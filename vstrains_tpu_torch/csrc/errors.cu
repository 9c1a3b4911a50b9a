// Error text for the codes the kernel entries return.

#include "vt_common.cuh"

VT_EXPORT const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
