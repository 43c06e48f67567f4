// Shared by every kernel library of repro_torch: the C export macro and
// the error-string entry point the Python loader binds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Each library is its own translation unit, so this is defined once in each.
REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
