// Error text for the codes the entry points return.
#include "common.cuh"

RF_API const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
