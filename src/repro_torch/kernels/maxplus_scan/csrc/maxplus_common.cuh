// Shared pieces of the (max,+) scan kernels: the affine map, its
// composition, and the warp-a-row scan both kernels run.  Included by
// maxplus_scan.cu (no flags) and maxplus_segment_scan.cu (reset flags),
// each built into its own library.
//
// The warp-a-row scan (one warp walks one row):
//
//   * tiles of 32 x kLaneItems elements; the carry of all earlier tiles
//     (and a seed, where the plain scan has one) stays in registers: it
//     is always the EARLIER operand of a combine, so it needs no flag;
//   * a lane holds kLaneItems consecutive elements: a and b come in
//     16-byte loads (float4, or double2 pairs), its flags in one 4-byte
//     load, and out_a (out_b) leave in 16-byte stores, so a warp's access
//     is one contiguous run;
//   * the next tile's loads are issued before the current tile is scanned
//     and stored (register double-buffering); no block-wide barrier;
//   * inside a tile: each lane scans its items in registers, then a
//     Hillis-Steele shuffle scan composes the lane totals.  The flags never
//     travel by shuffle: one ballot gives the warp's flagged lanes, and a
//     lane stops absorbing earlier lanes at the last flagged one;
//   * a row whose start is not 16-byte aligned, or the ragged last tile of
//     a row, takes scalar loads and stores; ragged ends load the identity
//     (-inf, 0, 0), so no padding copy exists.
//
// Each kernel walks its rows itself with load_tile, scan_tile and
// store_tile: with the row loop in one shared function, nvcc re-read the
// lane index inside the tile loop and the segmented scan lost ~10 %.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace maxplus {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLaneItems = 4;               // elements a lane holds a tile
constexpr int kRowTile = 32 * kLaneItems;   // elements a warp scans a tile
constexpr int kRowThreads = 256;            // 8 warps a block, a row each
constexpr int kRowWarps = kRowThreads / 32;
static_assert(kLaneItems % 4 == 0, "a lane loads its flags 4 at a time");

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
// guarded scalars.  Without flags, rf is never read.
template <typename T, bool kFlags>
__device__ __forceinline__ void load_tile(Tile<T>& t, const T* ra,
                                          const T* rb, const uint8_t* rf,
                                          int64_t i, int64_t len, bool vec) {
  t.f = 0;
  if (vec && i + kLaneItems <= len) {
#pragma unroll
    for (int q = 0; q < kLaneItems; q += 4) {
      load4(ra + i + q, t.a + q);
      load4(rb + i + q, t.b + q);
      if (kFlags) {
        const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(
            rf + i + q));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          t.f |= static_cast<uint32_t>(((w >> (8 * j)) & 0xffu) != 0)
                 << (q + j);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLaneItems; ++j) {
      const bool in = i + j < len;
      t.a[j] = in ? ra[i + j] : neg_inf<T>();
      t.b[j] = in ? rb[i + j] : T(0);
      if (kFlags) t.f |= static_cast<uint32_t>(in && rf[i + j] != 0) << j;
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
// carry (ca, cb) past it.  Every lane of the warp takes part.  Without
// flags every lane absorbs every earlier one.
template <typename T, bool kFlags>
__device__ __forceinline__ void scan_tile(Tile<T>& t, T& ca, T& cb,
                                          int lane) {
  // 1. the lane's items, scanned in registers
#pragma unroll
  for (int j = 1; j < kLaneItems; ++j) {
    if (!kFlags || !((t.f >> j) & 1u)) {
      const Map<T> m = combine(Map<T>{t.a[j - 1], t.b[j - 1]},
                               Map<T>{t.a[j], t.b[j]});
      t.a[j] = m.a;
      t.b[j] = m.b;
    }
  }
  // 2. inclusive shuffle scan of the lane totals.  h is the last flagged
  //    lane at or before this one: lanes before it are never absorbed
  unsigned flagged = 0;
  int h = 0;
  if (kFlags) {
    flagged = __ballot_sync(kFull, t.f != 0);
    const unsigned upto = flagged & ((2u << lane) - 1u);
    h = upto ? 31 - __clz(upto) : 0;
  }
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
    pre = (kFlags && (flagged & ((1u << lane) - 1u))) ? e : combine(pre, e);
  }
  // 4. compose it into the items, up to the lane's first flag
#pragma unroll
  for (int j = 0; j < kLaneItems; ++j) {
    if (!kFlags || !(t.f & ((2u << j) - 1u))) {
      const Map<T> m = combine(pre, Map<T>{t.a[j], t.b[j]});
      t.a[j] = m.a;
      t.b[j] = m.b;
    }
  }
  // 5. the carry into the next tile: lane 31's last element
  ca = __shfl_sync(kFull, t.a[kLaneItems - 1], 31);
  cb = __shfl_sync(kFull, t.b[kLaneItems - 1], 31);
}

}  // namespace maxplus
