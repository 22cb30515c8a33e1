// The message for a cudaError_t returned by one of the kernel entry points,
// from the CUDA runtime this library links.

#include <cuda_runtime.h>

extern "C" const char* sert_cuda_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
