// Shared by the port's CUDA sources.  Each source builds on its own into a
// shared library with a plain C interface (no PyTorch headers), loaded from
// Python with ctypes; every launcher returns cudaGetLastError() so that a
// refused launch surfaces in the wrapper.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

#define RS_EXPORT extern "C" __attribute__((visibility("default")))

RS_EXPORT const char* rs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

// Vec<V>: the unit a thread moves, one float or a 16-byte float4
template <int V>
struct VecOf {
  using type = float;
};
template <>
struct VecOf<4> {
  using type = float4;
};

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The members of one grouped launch, passed by value in the kernel's
// parameter struct (read from the constant bank through __grid_constant__):
// up to N member descriptors and a prefix table of block starts; blocks are
// numbered member by member.
template <typename Member, int N>
struct Grouped {
  Member s[N];
  int block_start[N + 1];
  int n;

  // the member of block blk: the last one whose first block is <= blk
  __device__ __forceinline__ int member_of(int blk) const {
    int lo = 0, hi = n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (block_start[mid] <= blk) lo = mid; else hi = mid - 1;
    }
    return lo;
  }

  // host: append member i with its count of blocks after those before it;
  // false once the grid would pass 2^31 - 1 blocks
  bool add(int i, const Member& m, long long blocks, long long& total) {
    s[i] = m;
    block_start[i] = static_cast<int>(total);
    total += blocks;
    return total <= 0x7fffffffLL;
  }

  void close(int count, long long total) {
    block_start[count] = static_cast<int>(total);
    n = count;
  }
};

}  // namespace
