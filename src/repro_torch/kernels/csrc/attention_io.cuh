// 16-byte loads and element stores of the flash-attention kernels
// (flash_attention.cu).
//
// They read rows of D contiguous elements of float32 or bfloat16 and
// computes in float32.  `Io<T>` moves 16 B at a time: 4 floats or 8
// bfloat16, which the caller converts to floats in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace attn {

constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;  // elements per 16 B
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float* out) {
    out[0] = r.x;
    out[1] = r.y;
    out[2] = r.z;
    out[3] = r.w;
  }
  __device__ __forceinline__ static float store(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

// exp(x - m) with the conventions of the online softmax: a running max
// of -inf (nothing seen yet) contributes nothing.
__device__ __forceinline__ float exp_sub(float x, float m) {
  return __expf(x - (m == -INFINITY ? 0.0f : m));
}

}  // namespace attn
