// Library-wide C entry points: turns the cudaError_t codes that every
// kernel entry point returns into messages for the Python wrappers.
#include "common.cuh"

extern "C" const char* b2f_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
