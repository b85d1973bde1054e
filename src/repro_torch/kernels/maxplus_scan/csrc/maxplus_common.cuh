// Shared pieces of the (max,+) scan kernels: the affine map, its
// composition, and the plain scan's launch shape.  Included by
// maxplus_scan.cu and maxplus_segment_scan.cu, each built into its own
// library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace maxplus {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Map {
  T a;
  T b;
};

template <typename T>
__device__ __forceinline__ T neg_inf();

template <>
__device__ __forceinline__ float neg_inf<float>() {
  return __int_as_float(0xff800000);
}

template <>
__device__ __forceinline__ double neg_inf<double>() {
  return __longlong_as_double(0xfff0000000000000ULL);
}

// x is the EARLIER map, y the later one.
template <typename T>
__device__ __forceinline__ Map<T> combine(Map<T> x, Map<T> y) {
  const T s = x.a + y.b;
  return Map<T>{y.a > s ? y.a : s, x.b + y.b};
}

}  // namespace maxplus
