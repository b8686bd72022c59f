// Shared by the port's CUDA sources.  Each source builds on its own into a
// shared library with a plain C interface (no PyTorch headers), loaded from
// Python with ctypes; every launcher returns cudaGetLastError() so that a
// refused launch surfaces in the wrapper.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
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

__host__ __device__ __forceinline__ bool aligned_to(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & static_cast<uintptr_t>(bytes - 1)) == 0;
}

using bf16 = __nv_bfloat16;

// bfloat16 <-> float32.  Widening is exact: a bf16 value is the high half of
// the float32 with the same bits.  Narrowing rounds to nearest even, as
// torch's .to(torch.bfloat16) and XLA's convert do.
__device__ __forceinline__ float bf16_lo(unsigned int w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned int bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ unsigned int bf16_pair(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// one value of T (float or bf16) as a float, exactly
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// a float as a T (float, or bf16 rounded to nearest even)
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16_rn(x); }

// x rounded to the nearest bf16 (ties to even) and widened back: what a
// bf16 operation that computes in float32 and rounds its result gives
__device__ __forceinline__ float round_bf16(float x) { return bf16_lo(bf16_bits(x)); }

// Lanes<T, V>: V neighbouring values of a row of T (float or bf16), moved as
// one load or store of Raw and worked on as V floats: widen after a load,
// narrow before a store.
template <typename T, int V>
struct Lanes;
template <>
struct Lanes<float, 1> {
  using Raw = float;
  __device__ static void widen(const Raw& r, float* f) { f[0] = r; }
  __device__ static Raw narrow(const float* f) { return f[0]; }
};
template <>
struct Lanes<float, 4> {
  using Raw = float4;
  __device__ static void widen(const Raw& r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  __device__ static Raw narrow(const float* f) { return make_float4(f[0], f[1], f[2], f[3]); }
};
template <>
struct Lanes<float, 8> {
  struct alignas(16) Raw {
    float4 a, b;
  };
  __device__ static void widen(const Raw& r, float* f) {
    Lanes<float, 4>::widen(r.a, f);
    Lanes<float, 4>::widen(r.b, f + 4);
  }
  __device__ static Raw narrow(const float* f) {
    return Raw{Lanes<float, 4>::narrow(f), Lanes<float, 4>::narrow(f + 4)};
  }
};
template <>
struct Lanes<bf16, 1> {
  using Raw = unsigned short;
  __device__ static void widen(const Raw& r, float* f) { f[0] = bf16_lo(r); }
  __device__ static Raw narrow(const float* f) {
    return static_cast<unsigned short>(bf16_bits(f[0]));
  }
};
template <>
struct Lanes<bf16, 4> {
  using Raw = uint2;
  __device__ static void widen(const Raw& r, float* f) {
    f[0] = bf16_lo(r.x);
    f[1] = bf16_hi(r.x);
    f[2] = bf16_lo(r.y);
    f[3] = bf16_hi(r.y);
  }
  __device__ static Raw narrow(const float* f) {
    return make_uint2(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]));
  }
};
template <>
struct Lanes<bf16, 8> {
  using Raw = uint4;
  __device__ static void widen(const Raw& r, float* f) {
    f[0] = bf16_lo(r.x);
    f[1] = bf16_hi(r.x);
    f[2] = bf16_lo(r.y);
    f[3] = bf16_hi(r.y);
    f[4] = bf16_lo(r.z);
    f[5] = bf16_hi(r.z);
    f[6] = bf16_lo(r.w);
    f[7] = bf16_hi(r.w);
  }
  __device__ static Raw narrow(const float* f) {
    return make_uint4(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]), bf16_pair(f[4], f[5]),
                      bf16_pair(f[6], f[7]));
  }
};

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
