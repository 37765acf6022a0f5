// Shared helpers for the port's CUDA sources, each built into its own
// shared library with a plain C interface (see kernels/build.py).
#pragma once
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Every library exports this, so the Python wrapper can name a failure.
REPRO_EXPORT const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
