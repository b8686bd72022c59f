// Shared by the port's CUDA sources.  Each source builds on its own into a
// shared library with a plain C interface (no PyTorch headers), loaded from
// Python with ctypes; every launcher returns cudaGetLastError() so that a
// refused launch surfaces in the wrapper.
#pragma once

#include <cuda_runtime.h>

#define RS_EXPORT extern "C" __attribute__((visibility("default")))

RS_EXPORT const char* rs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
