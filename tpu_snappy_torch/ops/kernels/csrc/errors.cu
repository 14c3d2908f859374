// Error text for the codes the kernel entry points return.
#include "common.cuh"

SNK_EXPORT const char* snk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
