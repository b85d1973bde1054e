// Segmented inclusive (max,+) scan along the last axis of (rows, len)
// arrays, for Hopper (sm_90a).  Replaces the Pallas TPU kernel
// `maxplus_segment_scan_pallas` (src/repro/kernels/maxplus_scan/kernel.py,
// body `_maxplus_segment_block_kernel`).
//
// Elements are (a, b, f): the affine max-plus map c -> max(a, c + b) and a
// reset flag f ("this element starts a new segment").  The segmented
// combine of an earlier x and a later y discards x where y holds a reset:
//
//   y.f ? (y.a, y.b) : (max(y.a, x.a + y.b), x.b + y.b),   f = x.f | y.f
//
// so out[i] is the plain (max,+) scan restarted at the last flagged
// element at or before i.  The fused replicated simulator compacts each
// replica's queries into contiguous segments of one row and scans all r
// replica queues in one launch.
//
// Flags are one byte per (flag row, element): row `row` reads flag row
// row / rows_per_flag.  At the server level the simulator scans (S * p,
// chunk) arrays whose p server rows share their scenario's segment
// layout, so the (S, chunk) flags are passed once with rows_per_flag = p;
// no (S, p, chunk) flag tensor exists.
//
// What bounds it: memory, as for the plain scan.  Each element moves 16 B
// in float32 (a and b read, out_a and out_b written) plus its flag byte,
// which p rows share through L1/L2.  The design is maxplus_scan.cu's:
//
//   * one block per row, looping over tiles of kTile elements; the carry of
//     all earlier tiles stays in registers.  The carry needs no flag lane:
//     it is always the EARLIER operand of the combine, whose flag is never
//     consumed;
//   * in a tile each thread scans kItems consecutive elements in registers,
//     a __shfl_up_sync scan composes the (a, b, f) thread aggregates inside
//     a warp, and each thread folds the kWarps warp totals from shared
//     memory;
//   * ragged ends load the identity (-inf, 0, 0), so no padding copy exists.
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after the launch.

#include "maxplus_common.cuh"

namespace {

using namespace maxplus;

template <typename T>
struct Seg {
  T a;
  T b;
  int f;
};

// x is the EARLIER element, y the later one.
template <typename T>
__device__ __forceinline__ Seg<T> combine_seg(Seg<T> x, Seg<T> y) {
  if (y.f) return y;
  const Map<T> m = combine(Map<T>{x.a, x.b}, Map<T>{y.a, y.b});
  return Seg<T>{m.a, m.b, x.f};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxplus_segment_scan_kernel(const T* __restrict__ a,
                            const T* __restrict__ b,
                            const uint8_t* __restrict__ f,
                            T* __restrict__ out_a, T* __restrict__ out_b,
                            int64_t len, int64_t rows_per_flag) {
  __shared__ T warp_a[kWarps];
  __shared__ T warp_b[kWarps];
  __shared__ int warp_f[kWarps];

  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* ra = a + row * len;
  const T* rb = b + row * len;
  const uint8_t* rf = f + (row / rows_per_flag) * len;
  T* oa = out_a + row * len;
  T* ob = out_b + row * len;
  const Seg<T> identity{neg_inf<T>(), T(0), 0};

  Seg<T> carry = identity;

  for (int64_t base = 0; base < len; base += kTile) {
    const int64_t start = base + static_cast<int64_t>(tid) * kItems;

    // 1. this thread's kItems elements, scanned in registers
    Seg<T> v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = start + j;
      v[j] = i < len ? Seg<T>{ra[i], rb[i], rf[i] != 0} : identity;
    }
#pragma unroll
    for (int j = 1; j < kItems; ++j) v[j] = combine_seg(v[j - 1], v[j]);

    // 2. inclusive warp scan of the thread aggregates
    Seg<T> t = v[kItems - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Seg<T> up{__shfl_up_sync(kFull, t.a, off),
                      __shfl_up_sync(kFull, t.b, off),
                      __shfl_up_sync(kFull, t.f, off)};
      if (lane >= off) t = combine_seg(up, t);
    }
    const Seg<T> up1{__shfl_up_sync(kFull, t.a, 1),
                     __shfl_up_sync(kFull, t.b, 1),
                     __shfl_up_sync(kFull, t.f, 1)};
    const Seg<T> lane_excl = lane == 0 ? identity : up1;
    if (lane == 31) {
      warp_a[warp] = t.a;
      warp_b[warp] = t.b;
      warp_f[warp] = t.f;
    }
    __syncthreads();

    // 3. fold the warp totals: everything before this thread, and the
    //    carry into the next tile (every thread computes the same value)
    Seg<T> prefix = carry;
    Seg<T> next = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const Seg<T> wt{warp_a[w], warp_b[w], warp_f[w]};
      if (w < warp) prefix = combine_seg(prefix, wt);
      next = combine_seg(next, wt);
    }
    prefix = combine_seg(prefix, lane_excl);

    // 4. compose and store
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = start + j;
      if (i < len) {
        const Seg<T> r = combine_seg(prefix, v[j]);
        oa[i] = r.a;
        ob[i] = r.b;
      }
    }
    carry = next;
    __syncthreads();  // warp totals are rewritten by the next tile
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* f, void* out_a,
           void* out_b, int64_t rows, int64_t len, int64_t rows_per_flag,
           void* stream) {
  maxplus_segment_scan_kernel<T>
      <<<dim3(static_cast<unsigned>(rows)), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<const uint8_t*>(f), static_cast<T*>(out_a),
          static_cast<T*>(out_b), len, rows_per_flag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int maxplus_segment_scan_f32(const void* a, const void* b,
                                        const void* f, void* out_a,
                                        void* out_b, int64_t rows,
                                        int64_t len, int64_t rows_per_flag,
                                        void* stream) {
  return launch<float>(a, b, f, out_a, out_b, rows, len, rows_per_flag,
                       stream);
}

extern "C" int maxplus_segment_scan_f64(const void* a, const void* b,
                                        const void* f, void* out_a,
                                        void* out_b, int64_t rows,
                                        int64_t len, int64_t rows_per_flag,
                                        void* stream) {
  return launch<double>(a, b, f, out_a, out_b, rows, len, rows_per_flag,
                        stream);
}
