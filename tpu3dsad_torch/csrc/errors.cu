// The text of a cudaError_t, for the Python wrappers' error messages.

#include <cuda_runtime.h>

extern "C" const char* tpu3dsad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
