// Error text for the cudaError_t codes the kernel entry points return.
#include <cuda_runtime.h>

extern "C" const char* ccdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
