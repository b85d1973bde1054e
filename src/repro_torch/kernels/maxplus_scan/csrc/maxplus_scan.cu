// Inclusive (max,+) scan along the last axis of (rows, len) arrays, for
// Hopper (sm_90a).  Replaces the Pallas TPU kernel `maxplus_scan_pallas`
// (src/repro/kernels/maxplus_scan/kernel.py, body `_maxplus_block_kernel`).
//
// Per row, with an optional initial carry (carry_a, carry_b), else the
// identity (-inf, 0):
//
//   out_a[i] = max(a[i], out_a[i-1] + b[i]),   out_b[i] = out_b[i-1] + b[i]
//
// i.e. the composition of the affine max-plus maps c -> max(a, c + b),
//   (a1, b1) then (a2, b2) = (max(a2, a1 + b2), b1 + b2).
// Seeding is folded into the carry's initial value, so a seeded scan costs
// nothing extra.
//
// What bounds it: memory.  Each element moves 16 B in float32 (a and b
// read, out_a and out_b written) against a handful of adds and compares, far
// below the H100's ~20 FLOP/B balance point.  The design streams each
// element through registers exactly once:
//
//   * one block per row, looping over tiles of kTile elements; the carry of
//     all earlier tiles stays in registers (the TPU's sequential
//     "arbitrary" grid axis becomes this loop — nothing carries across
//     blocks);
//   * in a tile each thread scans kItems consecutive elements in registers,
//     a __shfl_up_sync scan composes the thread aggregates inside a warp,
//     and each thread folds the kWarps warp totals from shared memory;
//   * ragged ends load the identity (-inf, 0), so no padding copy exists.
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after the launch.

#include "maxplus_common.cuh"

namespace {

using namespace maxplus;

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxplus_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const T* __restrict__ carry_a,
                    const T* __restrict__ carry_b, T* __restrict__ out_a,
                    T* __restrict__ out_b, int64_t len) {
  __shared__ T warp_a[kWarps];
  __shared__ T warp_b[kWarps];

  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* ra = a + row * len;
  const T* rb = b + row * len;
  T* oa = out_a + row * len;
  T* ob = out_b + row * len;
  const Map<T> identity{neg_inf<T>(), T(0)};

  Map<T> carry{carry_a != nullptr ? carry_a[row] : neg_inf<T>(),
               carry_b != nullptr ? carry_b[row] : T(0)};

  for (int64_t base = 0; base < len; base += kTile) {
    const int64_t start = base + static_cast<int64_t>(tid) * kItems;

    // 1. this thread's kItems elements, scanned in registers
    Map<T> v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = start + j;
      v[j] = i < len ? Map<T>{ra[i], rb[i]} : identity;
    }
#pragma unroll
    for (int j = 1; j < kItems; ++j) v[j] = combine(v[j - 1], v[j]);

    // 2. inclusive warp scan of the thread aggregates
    Map<T> t = v[kItems - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Map<T> up{__shfl_up_sync(kFull, t.a, off),
                      __shfl_up_sync(kFull, t.b, off)};
      if (lane >= off) t = combine(up, t);
    }
    const Map<T> up1{__shfl_up_sync(kFull, t.a, 1),
                     __shfl_up_sync(kFull, t.b, 1)};
    const Map<T> lane_excl = lane == 0 ? identity : up1;
    if (lane == 31) {
      warp_a[warp] = t.a;
      warp_b[warp] = t.b;
    }
    __syncthreads();

    // 3. fold the warp totals: everything before this thread, and the
    //    carry into the next tile (every thread computes the same value)
    Map<T> prefix = carry;
    Map<T> next = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const Map<T> wt{warp_a[w], warp_b[w]};
      if (w < warp) prefix = combine(prefix, wt);
      next = combine(next, wt);
    }
    prefix = combine(prefix, lane_excl);

    // 4. compose and store
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = start + j;
      if (i < len) {
        const Map<T> r = combine(prefix, v[j]);
        oa[i] = r.a;
        ob[i] = r.b;
      }
    }
    carry = next;
    __syncthreads();  // warp totals are rewritten by the next tile
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* carry_a,
           const void* carry_b, void* out_a, void* out_b, int64_t rows,
           int64_t len, void* stream) {
  maxplus_scan_kernel<T><<<dim3(static_cast<unsigned>(rows)), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(carry_a), static_cast<const T*>(carry_b),
      static_cast<T*>(out_a), static_cast<T*>(out_b), len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int maxplus_scan_f32(const void* a, const void* b,
                                const void* carry_a, const void* carry_b,
                                void* out_a, void* out_b, int64_t rows,
                                int64_t len, void* stream) {
  return launch<float>(a, b, carry_a, carry_b, out_a, out_b, rows, len,
                       stream);
}

extern "C" int maxplus_scan_f64(const void* a, const void* b,
                                const void* carry_a, const void* carry_b,
                                void* out_a, void* out_b, int64_t rows,
                                int64_t len, void* stream) {
  return launch<double>(a, b, carry_a, carry_b, out_a, out_b, rows, len,
                        stream);
}
