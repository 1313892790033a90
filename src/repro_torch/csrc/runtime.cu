// Error reporting for the ctypes wrappers: the name of a cudaError_t code.
#include "common.cuh"

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
