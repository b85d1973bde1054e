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
// replica queues in one launch; it reads out_a only, so the entry points
// take a null out_b and then never store b.
//
// Flags are one byte per (flag row, element): row `row` reads flag row
// row / rows_per_flag.  At the server level the simulator scans (S * p,
// chunk) arrays whose p server rows share their scenario's segment
// layout, so the (S, chunk) flags are passed once with rows_per_flag = p;
// no (S, p, chunk) flag tensor exists.
//
// What bounds it: memory.  In float32 an element moves 12 B (a and b
// read, out_a written), 16 B with out_b, plus its flag byte, which p rows
// share through L1/L2.  The design keeps loads in flight and spends no
// block-wide barrier: one warp a row, the warp-a-row scan of
// maxplus_common.cuh with its flags (the plain scan, maxplus_scan.cu, is
// the same scan without them).
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after the launch.

#include "maxplus_common.cuh"

namespace {

using namespace maxplus;

template <typename T, bool kWithB>
__global__ void __launch_bounds__(kRowThreads)
maxplus_segment_scan_kernel(const T* __restrict__ a,
                            const T* __restrict__ b,
                            const uint8_t* __restrict__ f,
                            T* __restrict__ out_a, T* __restrict__ out_b,
                            int64_t rows, int64_t len,
                            int64_t rows_per_flag) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kRowWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kRowWarps +
                     (threadIdx.x >> 5);
       row < rows; row += warps) {
    const T* ra = a + row * len;
    const T* rb = b + row * len;
    const uint8_t* rf = f + (row / rows_per_flag) * len;
    T* oa = out_a + row * len;
    T* ob = kWithB ? out_b + row * len : nullptr;
    uintptr_t bits = reinterpret_cast<uintptr_t>(ra) |
                     reinterpret_cast<uintptr_t>(rb) |
                     reinterpret_cast<uintptr_t>(oa);
    if (kWithB) bits |= reinterpret_cast<uintptr_t>(ob);
    const bool vec = (bits & 15u) == 0 &&
                     (reinterpret_cast<uintptr_t>(rf) & 3u) == 0;

    T ca = neg_inf<T>();
    T cb = T(0);
    Tile<T> cur, nxt;
    const int64_t first = static_cast<int64_t>(lane) * kLaneItems;
    load_tile<T, true>(cur, ra, rb, rf, first, len, vec);
    for (int64_t base = 0; base < len; base += kRowTile) {
      const int64_t i = base + first;
      if (base + kRowTile < len)
        load_tile<T, true>(nxt, ra, rb, rf, i + kRowTile, len, vec);
      scan_tile<T, true>(cur, ca, cb, lane);
      store_tile<T, kWithB>(cur.a, cur.b, oa, ob, i, len, vec);
      cur = nxt;
    }
  }
}

template <typename T, bool kWithB>
int launch_typed(const void* a, const void* b, const void* f, void* out_a,
                 void* out_b, int64_t rows, int64_t len,
                 int64_t rows_per_flag, void* stream) {
  const int64_t blocks = (rows + kRowWarps - 1) / kRowWarps;  // warp a row
  maxplus_segment_scan_kernel<T, kWithB>
      <<<dim3(static_cast<unsigned>(blocks)), kRowThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<const uint8_t*>(f), static_cast<T*>(out_a),
          static_cast<T*>(out_b), rows, len, rows_per_flag);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* b, const void* f, void* out_a,
           void* out_b, int64_t rows, int64_t len, int64_t rows_per_flag,
           void* stream) {
  if (out_b == nullptr)
    return launch_typed<T, false>(a, b, f, out_a, out_b, rows, len,
                                  rows_per_flag, stream);
  return launch_typed<T, true>(a, b, f, out_a, out_b, rows, len,
                               rows_per_flag, stream);
}

}  // namespace

// out_b may be null: then only out_a is written.
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
