// EmbeddingBag (multi-hot gather + masked mean), for Hopper (sm_90a).
// Replaces the Pallas TPU kernel `embedding_bag_pallas`
// (src/repro/kernels/embedding_bag/kernel.py, body `_bag_kernel`).
//
// Computes, for a table (R, D), ids (BF, M) and a mask (BF, M):
//
//   out[i, :] = sum_{j : mask[i, j]} table[ids[i, j], :] / max(count_i, 1)
//
// with the sum in float32, in entry order, and one rounding to the table's
// type at the end, as the Pallas kernel does.  The TPU kernel takes
// per-bag counts and sums the first count_i ids; this one takes the mask
// itself, so it computes that function for the data pipeline's prefix
// masks and the model op's (`repro.models.recsys.embedding_bag`) for any
// mask.  A masked entry's id is never used (a vector load may bring its
// bytes along; they are dropped) and its row is never gathered.  A valid
// id outside [0, R) makes its bag NaN (jnp.take's fill), never an
// out-of-bounds read.
//
// What bounds it: memory.  A bag reads its M mask bytes, its ids and its
// valid rows, and writes D values: at xDeepFM's D = 10 in bfloat16 a row
// is 20 bytes, 4-byte aligned only, and M = 4.  The design:
//
//   * a row is cut into units, the widest of 16, 8, 4 or 2 bytes that
//     divides the row and the table's alignment (the wrapper's
//     `bag_plan`): at D = 10 bf16 five 4-byte bf16x2 units, at D = 1 one
//     2-byte unit, at D = 8, 16, ..., 128 bf16 16-byte units;
//   * a lane takes up to 16 bytes of a row (kPer units), so a bag takes
//     ceil(units / kPer) neighbouring lanes: 2 at D = 10 (16 + 4 bytes),
//     1 at D = 1; consecutive bags in consecutive lane groups, so the
//     output is written once, coalesced across the warp.  Few lanes a bag
//     keep many bags in flight on an SM: the gather is bound by latency;
//   * a bag's lanes read its mask and ids once, in one request: for M = 4
//     the mask is one 4-byte load and the ids one (int32) or two (int64)
//     16-byte loads; other M go 4 entries at a time with scalar loads;
//   * all of a group of 4 entries' valid row loads are issued before the
//     first is summed, so the gathers are in flight together;
//   * the mask, ids and output stream through L2 with evict-first hints,
//     so that the hot rows stay;
//   * row offsets in 64 bits (33.8 M rows x D overflows 32 bits at D >= 64).
//
// Zipf-skewed ids keep the hot rows (and every row of the 24 small
// fields) in the 50 MB L2, so DRAM traffic sits well below the gathered
// bytes.  No sort, no host sync, no atomics.
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGroupEntries = 4;   // entries whose rows load together

// Units a lane: up to 16 bytes of a row, 12 in 4-byte units (D = 10 bf16
// splits 3 + 2 over two lanes); a 2-byte unit is an odd row.
__host__ __device__ constexpr int units_per_lane(int w) {
  return w == 2 ? 1 : (w == 4 ? 3 : 16 / w);
}

// A unit of W bytes as 32-bit words (a 2-byte unit in the low half).
template <int W>
struct Unit {
  uint32_t w[W >= 4 ? W / 4 : 1];
};

template <int W>
__device__ __forceinline__ Unit<W> load_unit(const uint8_t* p) {
  Unit<W> u;
  if constexpr (W == 16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    u.w[0] = x.x;
    u.w[1] = x.y;
    u.w[2] = x.z;
    u.w[3] = x.w;
  } else if constexpr (W == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    u.w[0] = x.x;
    u.w[1] = x.y;
  } else if constexpr (W == 4) {
    u.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    u.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return u;
}

// The output is written once and read by the next layer: evict-first
// stores keep it from pushing the hot rows out of L2.
template <int W>
__device__ __forceinline__ void store_unit(uint8_t* p, const Unit<W>& u) {
  if constexpr (W == 16) {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(u.w[0], u.w[1], u.w[2],
                                                   u.w[3]));
  } else if constexpr (W == 8) {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(u.w[0], u.w[1]));
  } else if constexpr (W == 4) {
    __stcs(reinterpret_cast<unsigned int*>(p), u.w[0]);
  } else {
    __stcs(reinterpret_cast<unsigned short*>(p),
           static_cast<unsigned short>(u.w[0]));
  }
}

// Value e of a unit, as float (bf16 widens exactly by a shift).
template <typename T, int W>
__device__ __forceinline__ float unit_value(const Unit<W>& u, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(u.w[e]);
  } else {
    const uint32_t w = u.w[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

template <typename T, int W>
__device__ __forceinline__ Unit<W> pack_unit(const float* v) {
  Unit<W> u;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < W / 4; ++e) u.w[e] = __float_as_uint(v[e]);
  } else {
#pragma unroll
    for (int k = 0; k < (W >= 4 ? W / 4 : 1); ++k) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]));
      const uint32_t hi = 2 * k + 1 < W / 2
          ? __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1])) : 0u;
      u.w[k] = lo | (hi << 16);
    }
  }
  return u;
}

// A bag's mask and ids stream through once: evict-first loads, so that
// they do not push the hot rows out of L2.
__device__ __forceinline__ uint32_t load_mask4(const uint8_t* p) {
  return __ldcs(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void load_ids4(const int32_t* p, int64_t* id) {
  const int4 x = __ldcs(reinterpret_cast<const int4*>(p));
  id[0] = x.x;
  id[1] = x.y;
  id[2] = x.z;
  id[3] = x.w;
}

__device__ __forceinline__ void load_ids4(const int64_t* p, int64_t* id) {
  const longlong2 x = __ldcs(reinterpret_cast<const longlong2*>(p));
  const longlong2 y = __ldcs(reinterpret_cast<const longlong2*>(p) + 1);
  id[0] = x.x;
  id[1] = x.y;
  id[2] = y.x;
  id[3] = y.y;
}

// kVec4: M == 4, the mask on 4 bytes and the ids on 16.  A bag takes
// `group` neighbouring lanes, lane g of it units [g kPer, (g + 1) kPer)
// of the row's blockIdx.y-th run of group kPer units; a block takes
// 256 / group consecutive bags.  Only rows wider than 256 lanes' worth
// (over 3 KB) take more than one run.
template <typename T, typename I, int W, bool kVec4>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const uint8_t* __restrict__ table,
                     const I* __restrict__ ids,
                     const uint8_t* __restrict__ mask,
                     uint8_t* __restrict__ out, int64_t n_bags, int bag,
                     int units, int group, int64_t rows) {
  constexpr int kE = W / static_cast<int>(sizeof(T));   // values a unit
  constexpr int kPer = units_per_lane(W);
  const int per_block = kThreads / group;
  const int in_block = static_cast<int>(threadIdx.x) / group;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t b = first + in_block;
  const bool live = in_block < per_block && b < n_bags;
  const int u0 = (static_cast<int>(blockIdx.y) * group +
                  static_cast<int>(threadIdx.x) - in_block * group) * kPer;
  const int64_t row_bytes = static_cast<int64_t>(units) * W;

  float acc[kPer][kE];
#pragma unroll
  for (int p = 0; p < kPer; ++p)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[p][e] = 0.0f;
  int count = 0;
  uint32_t bad = 0;   // valid entries whose id is outside the table

  const uint8_t* mk = mask + b * bag;
  const I* id = ids + b * bag;
  const int m = !live ? 0 : kVec4 ? kGroupEntries : bag;
  for (int j0 = 0; j0 < m; j0 += kGroupEntries) {
    // the group's valid entries and their ids
    int64_t rid[kGroupEntries];
    uint32_t valid = 0;
    if constexpr (kVec4) {
      const uint32_t w = load_mask4(mk);
#pragma unroll
      for (int j = 0; j < kGroupEntries; ++j)
        valid |= static_cast<uint32_t>((w & (0xffu << (8 * j))) != 0) << j;
      load_ids4(id, rid);
    } else {
#pragma unroll
      for (int j = 0; j < kGroupEntries; ++j) {
        rid[j] = 0;
        if (j0 + j < bag && mk[j0 + j]) {
          valid |= 1u << j;
          rid[j] = static_cast<int64_t>(id[j0 + j]);
        }
      }
    }
    // every valid in-range row's units, in flight together
    uint32_t take = 0;
    Unit<W> r[kGroupEntries][kPer];
#pragma unroll
    for (int j = 0; j < kGroupEntries; ++j) {
      if (((valid >> j) & 1u) && rid[j] >= 0 && rid[j] < rows) {
        take |= 1u << j;
        const uint8_t* src = table + rid[j] * row_bytes;
#pragma unroll
        for (int p = 0; p < kPer; ++p)
          if (u0 + p < units) r[j][p] = load_unit<W>(src + (u0 + p) * W);
      }
    }
    count += __popc(valid);
    bad |= valid & ~take;
    // then summed in entry order
#pragma unroll
    for (int j = 0; j < kGroupEntries; ++j)
      if ((take >> j) & 1u)
#pragma unroll
        for (int p = 0; p < kPer; ++p)
#pragma unroll
          for (int e = 0; e < kE; ++e)
            acc[p][e] += unit_value<T, W>(r[j][p], e);
  }

  // a valid id outside the table makes the bag NaN, as adding NaN would;
  // a power-of-two count (all of xDeepFM's: 1 and 4) divides exactly as a
  // multiply by its reciprocal
  const int c = count > 0 ? count : 1;
  const bool pow2 = (c & (c - 1)) == 0;
  const float inv = __int_as_float((127 - (__ffs(c) - 1)) << 23);
  uint8_t* dst = out + b * row_bytes;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    if (live && u0 + p < units) {
      float v[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float x = bad ? NAN : acc[p][e];
        v[e] = pow2 ? x * inv : x / static_cast<float>(c);
      }
      store_unit<W>(dst + (u0 + p) * W, pack_unit<T, W>(v));
    }
  }
}

template <typename T, typename I, int W>
int launch_unit(const void* table, const void* ids, const void* mask,
                void* out, int64_t n_bags, int64_t bag, int64_t dim,
                int64_t rows, bool vec4, void* stream) {
  constexpr int kPer = units_per_lane(W);
  const int units = static_cast<int>(dim * sizeof(T) / W);
  const int lanes = (units + kPer - 1) / kPer;   // lanes a row
  const int group = lanes < kThreads ? lanes : kThreads;
  const int64_t per_block = kThreads / group;
  const dim3 grid(static_cast<unsigned>((n_bags + per_block - 1) / per_block),
                  static_cast<unsigned>((lanes + group - 1) / group));
  const auto* tab = static_cast<const uint8_t*>(table);
  const auto* id = static_cast<const I*>(ids);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec4)
    embedding_bag_kernel<T, I, W, true><<<grid, kThreads, 0, s>>>(
        tab, id, mk, o, n_bags, static_cast<int>(bag), units, group, rows);
  else
    embedding_bag_kernel<T, I, W, false><<<grid, kThreads, 0, s>>>(
        tab, id, mk, o, n_bags, static_cast<int>(bag), units, group, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I>
int launch_ids(const void* table, const void* ids, const void* mask,
               void* out, int64_t n_bags, int64_t bag, int64_t dim,
               int64_t rows, int64_t unit_bytes, bool vec4, void* stream) {
  switch (unit_bytes) {
    case 16:
      return launch_unit<T, I, 16>(table, ids, mask, out, n_bags, bag, dim,
                                   rows, vec4, stream);
    case 8:
      return launch_unit<T, I, 8>(table, ids, mask, out, n_bags, bag, dim,
                                  rows, vec4, stream);
    case 4:
      return launch_unit<T, I, 4>(table, ids, mask, out, n_bags, bag, dim,
                                  rows, vec4, stream);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_unit<T, I, 2>(table, ids, mask, out, n_bags, bag,
                                    dim, rows, vec4, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const void* table, const void* ids, const void* mask, void* out,
           int64_t n_bags, int64_t bag, int64_t dim, int64_t rows,
           int64_t id_bytes, int64_t unit_bytes, int64_t vec4,
           void* stream) {
  if (n_bags * dim == 0) return 0;
  if (unit_bytes < static_cast<int64_t>(sizeof(T)) ||
      (dim * static_cast<int64_t>(sizeof(T))) % unit_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec4 && bag != kGroupEntries)
    return static_cast<int>(cudaErrorInvalidValue);
  if (id_bytes == 4)
    return launch_ids<T, int32_t>(table, ids, mask, out, n_bags, bag, dim,
                                  rows, unit_bytes, vec4 != 0, stream);
  if (id_bytes == 8)
    return launch_ids<T, int64_t>(table, ids, mask, out, n_bags, bag, dim,
                                  rows, unit_bytes, vec4 != 0, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// table (rows, dim) with rows on unit_bytes; ids (n_bags, bag) int32 or
// int64 (id_bytes 4 or 8) and mask (n_bags, bag) one byte each,
// contiguous; out (n_bags, dim) contiguous, in the table's type.  vec4:
// bag == 4, the mask on 4 bytes and the ids on 16 (`bag_plan`).
extern "C" int embedding_bag_f32(const void* table, const void* ids,
                                 const void* mask, void* out, int64_t n_bags,
                                 int64_t bag, int64_t dim, int64_t rows,
                                 int64_t id_bytes, int64_t unit_bytes,
                                 int64_t vec4, void* stream) {
  return launch<float>(table, ids, mask, out, n_bags, bag, dim, rows,
                       id_bytes, unit_bytes, vec4, stream);
}

extern "C" int embedding_bag_bf16(const void* table, const void* ids,
                                  const void* mask, void* out,
                                  int64_t n_bags, int64_t bag, int64_t dim,
                                  int64_t rows, int64_t id_bytes,
                                  int64_t unit_bytes, int64_t vec4,
                                  void* stream) {
  return launch<__nv_bfloat16>(table, ids, mask, out, n_bags, bag, dim, rows,
                               id_bytes, unit_bytes, vec4, stream);
}
