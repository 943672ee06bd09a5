// The CUDA runtime's message for an error code returned by an entry point,
// so that the Python wrapper raises with the runtime's own words.
#include "common.cuh"

FK_EXPORT const char* fk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
