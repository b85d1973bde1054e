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
// block-wide barrier:
//
//   * one warp per row, walking it in tiles of 32 x kLaneItems elements;
//     the carry of all earlier tiles stays in registers (it is always the
//     EARLIER operand of a combine, so it needs no flag);
//   * a lane holds kLaneItems consecutive elements: a and b come in
//     16-byte loads (float4, or double2 pairs), its flags in one 4-byte
//     load, and out_a (out_b) leave in 16-byte stores, so a warp's access
//     is one contiguous run;
//   * the next tile's loads are issued before the current tile is scanned
//     and stored (register double-buffering);
//   * inside a tile: each lane scans its items in registers, then a
//     Hillis-Steele shuffle scan composes the lane totals.  The flags never
//     travel by shuffle: one ballot gives the warp's flagged lanes, and a
//     lane stops absorbing earlier lanes at the last flagged one;
//   * a row whose start is not 16-byte aligned, or the ragged last tile of
//     a row, takes scalar loads and stores; ragged ends load the identity
//     (-inf, 0, 0), so no padding copy exists.
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after the launch.

#include "maxplus_common.cuh"

namespace {

using namespace maxplus;

constexpr int kLaneItems = 4;               // elements a lane holds a tile
constexpr int kRowTile = 32 * kLaneItems;   // elements a warp scans a tile
constexpr int kRowThreads = 256;            // 8 warps a block, a row each
constexpr int kRowWarps = kRowThreads / 32;
static_assert(kLaneItems % 4 == 0, "a lane loads its flags 4 at a time");

template <typename T>
struct Tile {
  T a[kLaneItems];
  T b[kLaneItems];
  uint32_t f;   // bit j: element j starts a segment
};

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

__device__ __forceinline__ void load4(const double* p, double* o) {
  const double2 x = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 y = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = y.x;
  o[3] = y.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double* v) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// The lane's kLaneItems elements from i (a multiple of kLaneItems):
// vector loads where the row allows them and the tile is whole, else
// guarded scalars.
template <typename T>
__device__ __forceinline__ void load_tile(Tile<T>& t, const T* ra,
                                          const T* rb, const uint8_t* rf,
                                          int64_t i, int64_t len, bool vec) {
  t.f = 0;
  if (vec && i + kLaneItems <= len) {
#pragma unroll
    for (int q = 0; q < kLaneItems; q += 4) {
      load4(ra + i + q, t.a + q);
      load4(rb + i + q, t.b + q);
      const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(
          rf + i + q));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        t.f |= static_cast<uint32_t>(((w >> (8 * j)) & 0xffu) != 0)
               << (q + j);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLaneItems; ++j) {
      const bool in = i + j < len;
      t.a[j] = in ? ra[i + j] : neg_inf<T>();
      t.b[j] = in ? rb[i + j] : T(0);
      t.f |= static_cast<uint32_t>(in && rf[i + j] != 0) << j;
    }
  }
}

template <typename T, bool kWithB>
__device__ __forceinline__ void store_tile(const T* va, const T* vb, T* oa,
                                           T* ob, int64_t i, int64_t len,
                                           bool vec) {
  if (vec && i + kLaneItems <= len) {
#pragma unroll
    for (int q = 0; q < kLaneItems; q += 4) {
      store4(oa + i + q, va + q);
      if (kWithB) store4(ob + i + q, vb + q);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLaneItems; ++j) {
      if (i + j < len) {
        oa[i + j] = va[j];
        if (kWithB) ob[i + j] = vb[j];
      }
    }
  }
}

// Scan one tile in place (t.a, t.b become the outputs) and advance the
// carry (ca, cb) past it.  Every lane of the warp takes part.
template <typename T>
__device__ __forceinline__ void scan_tile(Tile<T>& t, T& ca, T& cb,
                                          int lane) {
  // 1. the lane's items, scanned in registers
#pragma unroll
  for (int j = 1; j < kLaneItems; ++j) {
    if (!((t.f >> j) & 1u)) {
      const Map<T> m = combine(Map<T>{t.a[j - 1], t.b[j - 1]},
                               Map<T>{t.a[j], t.b[j]});
      t.a[j] = m.a;
      t.b[j] = m.b;
    }
  }
  // 2. inclusive shuffle scan of the lane totals.  h is the last flagged
  //    lane at or before this one: lanes before it are never absorbed
  const unsigned flagged = __ballot_sync(kFull, t.f != 0);
  const unsigned upto = flagged & ((2u << lane) - 1u);
  const int h = upto ? 31 - __clz(upto) : 0;
  T sa = t.a[kLaneItems - 1];
  T sb = t.b[kLaneItems - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T ua = __shfl_up_sync(kFull, sa, off);
    const T ub = __shfl_up_sync(kFull, sb, off);
    if (lane - off >= h) {
      const Map<T> m = combine(Map<T>{ua, ub}, Map<T>{sa, sb});
      sa = m.a;
      sb = m.b;
    }
  }
  // 3. everything before this lane: the carry, cut at a flag in an
  //    earlier lane of the tile
  const T ea = __shfl_up_sync(kFull, sa, 1);
  const T eb = __shfl_up_sync(kFull, sb, 1);
  Map<T> pre{ca, cb};
  if (lane > 0) {
    const Map<T> e{ea, eb};
    pre = (flagged & ((1u << lane) - 1u)) ? e : combine(pre, e);
  }
  // 4. compose it into the items, up to the lane's first flag
#pragma unroll
  for (int j = 0; j < kLaneItems; ++j) {
    if (!(t.f & ((2u << j) - 1u))) {
      const Map<T> m = combine(pre, Map<T>{t.a[j], t.b[j]});
      t.a[j] = m.a;
      t.b[j] = m.b;
    }
  }
  // 5. the carry into the next tile: lane 31's last element
  ca = __shfl_sync(kFull, t.a[kLaneItems - 1], 31);
  cb = __shfl_sync(kFull, t.b[kLaneItems - 1], 31);
}

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
    load_tile(cur, ra, rb, rf, first, len, vec);
    for (int64_t base = 0; base < len; base += kRowTile) {
      const int64_t i = base + first;
      if (base + kRowTile < len)
        load_tile(nxt, ra, rb, rf, i + kRowTile, len, vec);
      scan_tile(cur, ca, cb, lane);
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
