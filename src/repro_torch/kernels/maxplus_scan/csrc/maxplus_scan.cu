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
// What bounds it: memory.  An element moves 12 B in float32 when only
// out_a is asked for (a and b read, out_a written: what the simulator's
// FCFS queues read), 16 B with out_b, against a handful of adds and
// compares, far below the H100's ~20 FLOP/B balance point.  The design is
// the segmented scan's (maxplus_common.cuh) without flags: one warp a
// row, 16-byte loads and stores, the next tile prefetched into registers,
// no block barrier; a null out_b is never stored.
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after the launch.

#include "maxplus_common.cuh"

namespace {

using namespace maxplus;

template <typename T, bool kWithB>
__global__ void __launch_bounds__(kRowThreads)
maxplus_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const T* __restrict__ carry_a,
                    const T* __restrict__ carry_b, T* __restrict__ out_a,
                    T* __restrict__ out_b, int64_t rows, int64_t len) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kRowWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kRowWarps +
                     (threadIdx.x >> 5);
       row < rows; row += warps) {
    const T* ra = a + row * len;
    const T* rb = b + row * len;
    T* oa = out_a + row * len;
    T* ob = kWithB ? out_b + row * len : nullptr;
    uintptr_t bits = reinterpret_cast<uintptr_t>(ra) |
                     reinterpret_cast<uintptr_t>(rb) |
                     reinterpret_cast<uintptr_t>(oa);
    if (kWithB) bits |= reinterpret_cast<uintptr_t>(ob);
    const bool vec = (bits & 15u) == 0;

    T ca = carry_a != nullptr ? carry_a[row] : neg_inf<T>();
    T cb = carry_b != nullptr ? carry_b[row] : T(0);
    Tile<T> cur, nxt;
    const int64_t first = static_cast<int64_t>(lane) * kLaneItems;
    load_tile<T, false>(cur, ra, rb, nullptr, first, len, vec);
    for (int64_t base = 0; base < len; base += kRowTile) {
      const int64_t i = base + first;
      if (base + kRowTile < len)
        load_tile<T, false>(nxt, ra, rb, nullptr, i + kRowTile, len, vec);
      scan_tile<T, false>(cur, ca, cb, lane);
      store_tile<T, kWithB>(cur.a, cur.b, oa, ob, i, len, vec);
      cur = nxt;
    }
  }
}

template <typename T, bool kWithB>
int launch_typed(const void* a, const void* b, const void* carry_a,
                 const void* carry_b, void* out_a, void* out_b,
                 int64_t rows, int64_t len, void* stream) {
  const int64_t blocks = (rows + kRowWarps - 1) / kRowWarps;  // warp a row
  maxplus_scan_kernel<T, kWithB>
      <<<dim3(static_cast<unsigned>(blocks)), kRowThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<const T*>(carry_a), static_cast<const T*>(carry_b),
          static_cast<T*>(out_a), static_cast<T*>(out_b), rows, len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* b, const void* carry_a,
           const void* carry_b, void* out_a, void* out_b, int64_t rows,
           int64_t len, void* stream) {
  if (out_b == nullptr)
    return launch_typed<T, false>(a, b, carry_a, carry_b, out_a, out_b,
                                  rows, len, stream);
  return launch_typed<T, true>(a, b, carry_a, carry_b, out_a, out_b, rows,
                               len, stream);
}

}  // namespace

// carry_a, carry_b and out_b may be null: an unseeded half of the carry,
// and out_a written alone.
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
