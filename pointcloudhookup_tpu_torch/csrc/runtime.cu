// Error text for the codes the kernel entry points return.
#include "common.cuh"

PCH_API const char* pch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
