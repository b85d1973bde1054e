// One-token GQA decode attention against a KV cache, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention/kernel.py, body `_decode_kernel`).
//
// Computes, for q (B, 1, H, D) and one layer's cache k, v (B, S, KV, D) in
// the model's layout (any strides, D contiguous), H = KV * G, and `n` =
// the last valid position + 1:
//
//   out[b, h] = sum_{j < n} softmax_j(q[b, h] . k[b, j, h / G] / sqrt(D)) v[b, j, h / G]
//
// with m, l and acc in float32, l floored at 1e-30, the output cast to q's
// type.  float32 or bfloat16, G = 1..16, D in 8, 16, 32, 64, 128; no TF32.
//
// What bounds it: memory.  K and V for positions < n are read once (at
// B = 8, H = 32, KV = 8, D = 128 and n = 2101, 69 MB: ~20 us at 3.35 TB/s)
// against ~2 FLOP per byte.  The design:
//
//   * one launch a call (flash-decoding in one kernel): block (split, kv
//     head, batch) walks `per` tiles of kBlockN positions of its (b, kv)
//     row; it writes a float32 partial (m, l, acc) per head, and the last
//     block of the row to finish, found by an atomic ticket after a
//     __threadfence on a per-row counter (allocated once by the wrapper
//     for each stream, so that two calls in flight never share one;
//     reset by that block), merges the row's splits in split order, so
//     the result does not depend on which block finished last.  One
//     split: the block writes the output itself;
//   * K and V through TMA into a ring of kStages shared-memory stages
//     (hopper.cuh's mbarrier ring), fed by one producer warp, read by
//     kConsumers consumer warps that take tiles in turn (8 stages were
//     no faster on the card: a block's loads are not what holds it).  The tensor maps
//     describe the cache's full S, never `length`, so the wrapper's plan
//     and the encoded maps (cached by base and spec) stay the same from
//     step to step.  The last tile is loaded from n - kBlockN (from a
//     negative position, which TMA fills with zeros, when n < kBlockN),
//     so no position >= n is ever read; positions below the tile's own
//     first are masked;
//   * bfloat16 (`decode_mma_kernel`): S = q K^T and P V on tensor cores,
//     mma.sync m16n8k16 with the G query heads of a kv head as the A rows
//     (padded to 16 with zero rows that are never stored), K and V
//     fragments by ldmatrix (V transposed) from the swizzled tiles, the
//     online softmax on S's float32 fragment in registers, P rounded to
//     bf16 (as the Pallas kernel casts p to v's type).  D = 8 loads a
//     16-wide band whose upper half TMA fills with zeros, and P V also
//     takes what rounding P to bf16 drops, a second product of the bf16
//     remainder (hop::pack_bf16_rest says why);
//   * float32 (`decode_fma_kernel`): CUDA-core FMAs, a group of D / 4
//     lanes a cache row (16 B each), G a runtime loop under a bucket
//     (4, 8, 16), dot products reduced across the group by shuffles;
//   * the block merges its warps through shared memory (the ring, once
//     every tile is consumed).
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after the launch, or hop::kEncodeError + the CUresult
// when a tensor map cannot be encoded.

#include "../../csrc/hopper.cuh"

#include <atomic>

namespace {

using hop::bf16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockN = 32;                      // positions a K/V tile
constexpr int kStages = 4;                       // the ring
constexpr int kConsumers = 4;                    // consumer warps
constexpr int kThreads = 32 * (1 + kConsumers);  // + the producer warp
constexpr int kMaxG = 16;                        // query heads a kv head

// The tiles of head dimension DP (D, or 16 for a bf16 D of 8) in
// elements of ES bytes: a box row is kRowBytes (also the swizzle), D
// wider than that is several boxes (bands) a tile.
template <int DP, int ES>
struct Geom {
  static constexpr int kRowBytes = DP * ES < 128 ? DP * ES : 128;
  static constexpr int kChunk = kRowBytes / ES;     // elements a box row
  static constexpr int kBands = DP / kChunk;
  static constexpr int kBox = kBlockN * kRowBytes;  // one band of a tile
  static constexpr int kTile = kBlockN * DP * ES;   // one K (or V) tile
  static constexpr int kStage = 2 * kTile;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kMergeFloats = 2 * kConsumers * kMaxG +
                                      kConsumers * kMaxG * DP;
  static constexpr int kSmem = 1024 + kRing + 16 * kStages + 16;
  static_assert(kBox % 1024 == 0, "tiles stay on the swizzle's atom");
  static_assert(kMergeFloats * 4 <= kRing, "the warp merge reuses the ring");
};

struct Params {
  const void* q;
  void* out;
  float* part;
  int* counter;
  int64_t q_sb, q_sh, o_sb, o_sh;
  int n, groups, d, splits, per, n_tiles;
  float scale_log2;   // log2(e) / sqrt(D)
};

// the byte offset, in a swizzled tile, of 16-byte chunk `dc` of row `row`
template <int DP, int ES>
__device__ __forceinline__ uint32_t tile_off(int row, int dc) {
  using G = Geom<DP, ES>;
  constexpr int kCpr = G::kRowBytes / 16;
  return hop::swizzle<G::kRowBytes>(
      static_cast<uint32_t>((dc / kCpr) * G::kBox + row * G::kRowBytes +
                            (dc % kCpr) * 16));
}

// exp2(x - m) with the online softmax's convention: a max of -inf
// (nothing seen) contributes nothing
__device__ __forceinline__ float exp2_sub(float x, float m) {
  return exp2f(x - (m == -INFINITY ? 0.0f : m));
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// C (16 x 8, float32) += A (16 x 16, bf16, row) B (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------- shared skeleton
// The block's barriers live past the ring: full[kStages], empty[kStages],
// then the merge's ticket flag.
struct Ring {
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  int* flag;
};

template <int DP, int ES>
__device__ __forceinline__ Ring ring_init(uint8_t* smem_raw) {
  using G = Geom<DP, ES>;
  uint8_t* smem = hop::align1024(smem_raw);
  Ring r{smem, reinterpret_cast<uint64_t*>(smem + G::kRing), nullptr,
         nullptr};
  r.empty = r.full + kStages;
  r.flag = reinterpret_cast<int*>(r.empty + kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&r.full[s], 1);
      hop::mbar_init(&r.empty[s], 1);   // the one warp that took the tile
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// The first position of tile t as loaded: t kBlockN, or n - kBlockN for
// the tile that would cross n (so nothing at or past n is read)
__device__ __forceinline__ int tile_start(int t, int n) {
  return min(t * kBlockN, n - kBlockN);
}

// The producer warp's lane 0: K and V of the block's tiles into the ring
template <int DP, int ES>
__device__ __forceinline__ void produce(const Ring& r, const CUtensorMap* k_map,
                                        const CUtensorMap* v_map, int t0,
                                        int nt, int n, int kvh, int b) {
  using G = Geom<DP, ES>;
  for (int i = 0; i < nt; ++i) {
    const int s = i % kStages;
    hop::mbar_wait(&r.empty[s], ((i / kStages) & 1) ^ 1);
    hop::mbar_expect_tx(&r.full[s], G::kStage);
    uint8_t* kt = r.ring + s * G::kStage;
    const int start = tile_start(t0 + i, n);
    for (int band = 0; band < G::kBands; ++band) {
      hop::tma_load_4d(kt + band * G::kBox, k_map, &r.full[s],
                       band * G::kChunk, kvh, start, b);
      hop::tma_load_4d(kt + G::kTile + band * G::kBox, v_map, &r.full[s],
                       band * G::kChunk, kvh, start, b);
    }
  }
}

// After every warp left its (m, l, acc) per head in the merge area
// (mw[warp][g], lw[warp][g], aw[warp][g][DP], float32, m in log2 units):
// merge the warps, then either store the output (one split) or this
// split's partial, and let the row's last block merge the splits.
template <typename T, int DP>
__device__ __forceinline__ void finish(const Params& prm, const float* merge,
                                       int* flag, int split, int kvh, int b) {
  const float* mw = merge;
  const float* lw = mw + kConsumers * kMaxG;
  const float* aw = lw + kConsumers * kMaxG;
  const int groups = prm.groups;
  const int d = prm.d;
  const int64_t row = static_cast<int64_t>(b) * gridDim.y + kvh;
  T* out = static_cast<T*>(prm.out);
  const int64_t rows_g = static_cast<int64_t>(gridDim.z) * gridDim.y *
                         prm.splits * groups;
  float* part_m = prm.part;
  float* part_l = part_m + rows_g;
  float* part_acc = part_l + rows_g;
  const int64_t prow = (row * prm.splits + split) * groups;
  for (int i = threadIdx.x; i < groups * d; i += kThreads) {
    const int g = i / d;
    const int dd = i % d;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) mx = fmaxf(mx, mw[w * kMaxG + g]);
    float lsum = 0.0f, asum = 0.0f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float e = exp2_sub(mw[w * kMaxG + g], mx);
      lsum = fmaf(lw[w * kMaxG + g], e, lsum);
      asum = fmaf(aw[(w * kMaxG + g) * DP + dd], e, asum);
    }
    if (prm.splits == 1) {
      store_out(out + b * prm.o_sb + (kvh * groups + g) * prm.o_sh + dd,
                asum / fmaxf(lsum, 1e-30f));
    } else {
      part_acc[(prow + g) * d + dd] = asum;
      if (dd == 0) {
        part_m[prow + g] = mx;
        part_l[prow + g] = lsum;
      }
    }
  }
  if (prm.splits == 1) return;
  __threadfence();   // this block's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    *flag = atomicAdd(&prm.counter[row], 1) == prm.splits - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const int64_t base = row * prm.splits * groups;
  for (int i = threadIdx.x; i < groups * d; i += kThreads) {
    const int g = i / d;
    const int dd = i % d;
    float mx = -INFINITY;
    for (int s = 0; s < prm.splits; ++s)
      mx = fmaxf(mx, __ldcg(&part_m[base + s * groups + g]));
    float lsum = 0.0f, asum = 0.0f;
    for (int s = 0; s < prm.splits; ++s) {
      const int64_t r = base + s * groups + g;
      const float e = exp2_sub(__ldcg(&part_m[r]), mx);
      lsum = fmaf(__ldcg(&part_l[r]), e, lsum);
      asum = fmaf(__ldcg(&part_acc[r * d + dd]), e, asum);
    }
    store_out(out + b * prm.o_sb + (kvh * groups + g) * prm.o_sh + dd,
              asum / fmaxf(lsum, 1e-30f));
  }
  if (threadIdx.x == 0) prm.counter[row] = 0;   // ready for the next call
}

// ------------------------------------------------------------- bfloat16
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
decode_mma_kernel(const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const Params prm) {
  using G = Geom<DP, 2>;
  extern __shared__ uint8_t smem_raw[];
  const Ring rg = ring_init<DP, 2>(smem_raw);
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = split * prm.per;
  const int nt = min(prm.per, prm.n_tiles - t0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = prm.n;
  const int groups = prm.groups;

  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
  float o[DP / 8][4];
  const int gr = lane / 4;   // fragment row (head) g; g + 8 below
  const int tq = lane % 4;
  if (warp == kConsumers) {
    if (lane == 0) produce<DP, 2>(rg, &k_map, &v_map, t0, nt, n, kvh, b);
  } else {
    // q's A fragments: rows = the G heads (zero past G), k = D (zero past
    // the real D)
    uint32_t qa[DP / 16][4];
    const bf16* qb = static_cast<const bf16*>(prm.q) + b * prm.q_sb +
                     static_cast<int64_t>(kvh) * groups * prm.q_sh;
    auto ldq = [&](int row, int col) -> uint32_t {
      if (row >= groups || col >= prm.d) return 0u;
      return *reinterpret_cast<const uint32_t*>(qb + row * prm.q_sh + col);
    };
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const int c0 = 16 * ks + 2 * tq;
      qa[ks][0] = ldq(gr, c0);
      qa[ks][1] = ldq(gr + 8, c0);
      qa[ks][2] = ldq(gr, c0 + 8);
      qa[ks][3] = ldq(gr + 8, c0 + 8);
    }
#pragma unroll
    for (int i = 0; i < DP / 8; ++i)
      o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
    const int mi = lane >> 3;   // which 8 x 8 matrix of an x4 this lane addresses
    const int mr = lane & 7;
    for (int i = warp; i < nt; i += kConsumers) {
      const int s = i % kStages;
      const int t = t0 + i;
      const int lo = t * kBlockN;          // first position counted
      const int start = tile_start(t, n);  // first position loaded
      hop::mbar_wait(&rg.full[s], (i / kStages) & 1);
      const uint32_t kt = hop::smem_u32(rg.ring + s * G::kStage);
      const uint32_t vt = kt + G::kTile;
      // S = q K^T: n-tiles of 8 positions, taken in pairs by ldmatrix.x4
      float sc[kBlockN / 8][4];
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
#pragma unroll
        for (int np = 0; np < kBlockN / 16; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, kt + tile_off<DP, 2>(16 * np + ((mi >> 1) << 3) + mr,
                                           2 * ks + (mi & 1)));
          mma_bf16(sc[2 * np], qa[ks], kb[0], kb[1]);
          mma_bf16(sc[2 * np + 1], qa[ks], kb[2], kb[3]);
        }
      }
      // mask positions below the tile's own (the shifted last tile), then
      // the online softmax of rows g (elements 0, 1) and g + 8 (2, 3)
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = start + 8 * j + 2 * tq + (e & 1);
          sc[j][e] = pos >= lo ? sc[j][e] * prm.scale_log2 : -INFINITY;
        }
        mx_a = fmaxf(mx_a, fmaxf(sc[j][0], sc[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a);
      const float mn_b = fmaxf(m_b, mx_b);
      const float alpha_a = exp2_sub(m_a, mn_a);
      const float alpha_b = exp2_sub(m_b, mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        sc[j][0] = exp2_sub(sc[j][0], mn_a);
        sc[j][1] = exp2_sub(sc[j][1], mn_a);
        sc[j][2] = exp2_sub(sc[j][2], mn_b);
        sc[j][3] = exp2_sub(sc[j][3], mn_b);
        sum_a += sc[j][0] + sc[j][1];
        sum_b += sc[j][2] + sc[j][3];
      }
      l_a = l_a * alpha_a + sum_a;   // a per-lane partial; summed at the end
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int i2 = 0; i2 < DP / 8; ++i2) {
        o[i2][0] *= alpha_a;
        o[i2][1] *= alpha_a;
        o[i2][2] *= alpha_b;
        o[i2][3] *= alpha_b;
      }
      // O += P V: P's A fragment of k-step ks2 is S's n-tiles 2 ks2 and
      // 2 ks2 + 1; V's B fragments by ldmatrix.trans, D n-tiles in pairs
#pragma unroll
      for (int ks2 = 0; ks2 < kBlockN / 16; ++ks2) {
        const uint32_t pa[4] = {
            hop::pack_bf16(sc[2 * ks2][0], sc[2 * ks2][1]),
            hop::pack_bf16(sc[2 * ks2][2], sc[2 * ks2][3]),
            hop::pack_bf16(sc[2 * ks2 + 1][0], sc[2 * ks2 + 1][1]),
            hop::pack_bf16(sc[2 * ks2 + 1][2], sc[2 * ks2 + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vt + tile_off<DP, 2>(16 * ks2 + ((mi & 1) << 3) + mr,
                                                 2 * dp + (mi >> 1)));
          mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
          if constexpr (DP == 16) {
            if (prm.d < 16) {   // D = 8: P - bf16(P) as well
              const uint32_t pr[4] = {
                  hop::pack_bf16_rest(sc[2 * ks2][0], sc[2 * ks2][1]),
                  hop::pack_bf16_rest(sc[2 * ks2][2], sc[2 * ks2][3]),
                  hop::pack_bf16_rest(sc[2 * ks2 + 1][0], sc[2 * ks2 + 1][1]),
                  hop::pack_bf16_rest(sc[2 * ks2 + 1][2],
                                      sc[2 * ks2 + 1][3])};
              mma_bf16(o[2 * dp], pr, vb[0], vb[1]);
              mma_bf16(o[2 * dp + 1], pr, vb[2], vb[3]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&rg.empty[s]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(kFull, l_a, off);
      l_b += __shfl_xor_sync(kFull, l_b, off);
    }
  }
  __syncthreads();   // every tile consumed: the ring becomes the merge area
  float* merge = reinterpret_cast<float*>(rg.ring);
  if (warp < kConsumers) {
    float* mw = merge;
    float* lw = mw + kConsumers * kMaxG;
    float* aw = lw + kConsumers * kMaxG;
    if (tq == 0) {
      mw[warp * kMaxG + gr] = m_a;
      mw[warp * kMaxG + gr + 8] = m_b;
      lw[warp * kMaxG + gr] = l_a;
      lw[warp * kMaxG + gr + 8] = l_b;
    }
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      float* ra = aw + (warp * kMaxG + gr) * DP + 8 * i + 2 * tq;
      float* rb = ra + 8 * DP;
      ra[0] = o[i][0];
      ra[1] = o[i][1];
      rb[0] = o[i][2];
      rb[1] = o[i][3];
    }
  }
  __syncthreads();
  finish<bf16, DP>(prm, merge, rg.flag, split, kvh, b);
}

// -------------------------------------------------------------- float32
template <int DP, int GB>
__global__ void __launch_bounds__(kThreads, 2)
decode_fma_kernel(const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const Params prm) {
  using G = Geom<DP, 4>;
  constexpr int kLanes = DP / 4;           // lanes a cache row, 16 B each
  constexpr int kRowGroups = 32 / kLanes;  // rows a warp takes at once
  constexpr int kRowsEach = kBlockN / kRowGroups;   // a group's rows a tile
  constexpr int kBatch = kRowsEach < 4 ? kRowsEach : 4;
  extern __shared__ uint8_t smem_raw[];
  const Ring rg = ring_init<DP, 4>(smem_raw);
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = split * prm.per;
  const int nt = min(prm.per, prm.n_tiles - t0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / kLanes;
  const int gl = lane % kLanes;
  const int n = prm.n;
  const int groups = prm.groups;

  float m[GB], l[GB], acc[GB][4];
  if (warp == kConsumers) {
    if (lane == 0) produce<DP, 4>(rg, &k_map, &v_map, t0, nt, n, kvh, b);
  } else {
    float qv[GB][4];
    const float* qb = static_cast<const float*>(prm.q) + b * prm.q_sb +
                      static_cast<int64_t>(kvh) * groups * prm.q_sh + gl * 4;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float4 x = g < groups
                           ? *reinterpret_cast<const float4*>(qb + g * prm.q_sh)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      qv[g][0] = x.x;
      qv[g][1] = x.y;
      qv[g][2] = x.z;
      qv[g][3] = x.w;
      m[g] = -INFINITY;
      l[g] = 0.0f;
      acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.0f;
    }
    for (int i = warp; i < nt; i += kConsumers) {
      const int s = i % kStages;
      const int t = t0 + i;
      const int lo = t * kBlockN;
      const int start = tile_start(t, n);
      hop::mbar_wait(&rg.full[s], (i / kStages) & 1);
      const uint8_t* kt = rg.ring + s * G::kStage;
      const uint8_t* vt = kt + G::kTile;
      for (int u0 = 0; u0 < kRowsEach; u0 += kBatch) {
        float sc[kBatch][GB];
        float vf[kBatch][4];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int row = grp + kRowGroups * (u0 + u);
          const bool ok = start + row >= lo;
          const float4 kf = *reinterpret_cast<const float4*>(
              kt + tile_off<DP, 4>(row, gl));
          const float4 vv = *reinterpret_cast<const float4*>(
              vt + tile_off<DP, 4>(row, gl));
          vf[u][0] = vv.x;
          vf[u][1] = vv.y;
          vf[u][2] = vv.z;
          vf[u][3] = vv.w;
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            if (g < groups) {
              float dot = qv[g][0] * kf.x;
              dot = fmaf(qv[g][1], kf.y, dot);
              dot = fmaf(qv[g][2], kf.z, dot);
              dot = fmaf(qv[g][3], kf.w, dot);
#pragma unroll
              for (int off = kLanes / 2; off >= 1; off >>= 1)
                dot += __shfl_xor_sync(kFull, dot, off);
              sc[u][g] = ok ? dot * prm.scale_log2 : -INFINITY;
            }
          }
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < groups) {
            float mb = sc[0][g];
#pragma unroll
            for (int u = 1; u < kBatch; ++u) mb = fmaxf(mb, sc[u][g]);
            const float mn = fmaxf(m[g], mb);
            const float alpha = exp2_sub(m[g], mn);
            float psum = 0.0f;
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] *= alpha;
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const float p = exp2_sub(sc[u][g], mn);
              psum += p;
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
            }
            l[g] = l[g] * alpha + psum;
            m[g] = mn;
          }
        }
      }
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&rg.empty[s]);
    }
    // merge the warp's row groups (lanes kLanes, 2 kLanes, ... apart)
#pragma unroll
    for (int off = kLanes; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g < groups) {
          const float mo = __shfl_xor_sync(kFull, m[g], off);
          const float lo_ = __shfl_xor_sync(kFull, l[g], off);
          const float mn = fmaxf(m[g], mo);
          const float wa = exp2_sub(m[g], mn);
          const float wb = exp2_sub(mo, mn);
          l[g] = l[g] * wa + lo_ * wb;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ao = __shfl_xor_sync(kFull, acc[g][e], off);
            acc[g][e] = acc[g][e] * wa + ao * wb;
          }
          m[g] = mn;
        }
      }
    }
  }
  __syncthreads();   // every tile consumed: the ring becomes the merge area
  float* merge = reinterpret_cast<float*>(rg.ring);
  if (warp < kConsumers && grp == 0) {
    float* mw = merge;
    float* lw = mw + kConsumers * kMaxG;
    float* aw = lw + kConsumers * kMaxG;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < groups) {
        if (gl == 0) {
          mw[warp * kMaxG + g] = m[g];
          lw[warp * kMaxG + g] = l[g];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          aw[(warp * kMaxG + g) * DP + gl * 4 + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  finish<float, DP>(prm, merge, rg.flag, split, kvh, b);
}

// ------------------------------------------------------------- launches
// The plan (kernels/decode_attention/kernel.py `DecodePlan.args`):
// threads, shared bytes, DP, G, D, KV, B, q's strides (batch, head),
// out's (batch, head), then the K and V maps (hop::kMapSpecLen each).
constexpr int kPlanHead = 11;
constexpr int kPlanLen = kPlanHead + 2 * hop::kMapSpecLen;

bool box_is(const int64_t* spec, int64_t b0, int64_t swizzle) {
  return spec[0] == 4 && spec[8] == b0 && spec[9] == 1 &&
         spec[10] == kBlockN && spec[11] == 1 && spec[12] == swizzle;
}

template <auto kernel>
int launch_kernel(int smem, const void* k, const void* v,
                  CUtensorMapDataType dtype, const int64_t* plan,
                  const Params& prm, void* stream) {
  const int64_t* k_spec = plan + kPlanHead;
  const int64_t* v_spec = k_spec + hop::kMapSpecLen;
  CUtensorMap k_map, v_map;
  int err = hop::encode_map_cached(&k_map, k, k_spec, dtype);
  if (err == 0) err = hop::encode_map_cached(&v_map, v, v_spec, dtype);
  if (err != 0) return err;
  // the shared-memory attribute, once a kernel and device (a bit a
  // device)
  static std::atomic<uint64_t> attr_set{0};
  int dev = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const uint64_t bit = 1ull << (dev & 63);
  if (smem > 48 * 1024 && !(attr_set.load() & bit)) {
    cerr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    attr_set.fetch_or(bit);
  }
  const dim3 grid(static_cast<unsigned>(prm.splits),
                  static_cast<unsigned>(plan[5]),
                  static_cast<unsigned>(plan[6]));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      k_map, v_map, prm);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q, void* out, void* part, void* counter,
                   const int64_t* plan, int64_t n, int64_t splits,
                   int64_t per) {
  Params prm;
  prm.q = q;
  prm.out = out;
  prm.part = static_cast<float*>(part);
  prm.counter = static_cast<int*>(counter);
  prm.q_sb = plan[7];
  prm.q_sh = plan[8];
  prm.o_sb = plan[9];
  prm.o_sh = plan[10];
  prm.n = static_cast<int>(n);
  prm.groups = static_cast<int>(plan[3]);
  prm.d = static_cast<int>(plan[4]);
  prm.splits = static_cast<int>(splits);
  prm.per = static_cast<int>(per);
  prm.n_tiles = static_cast<int>((n + kBlockN - 1) / kBlockN);
  prm.scale_log2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(plan[4])));
  return prm;
}

// the checks every launch shares: threads, shared bytes, the boxes, the
// split covering every tile, G, n
template <int DP, int ES>
bool plan_ok(const int64_t* plan, int64_t n, int64_t splits, int64_t per) {
  using G = Geom<DP, ES>;
  const int64_t* k_spec = plan + kPlanHead;
  const int64_t* v_spec = k_spec + hop::kMapSpecLen;
  const int64_t tiles = (n + kBlockN - 1) / kBlockN;
  return plan[0] == kThreads && plan[1] == G::kSmem && plan[2] == DP &&
         plan[3] >= 1 && plan[3] <= kMaxG && n >= 1 && n <= k_spec[3] &&
         per >= 1 && splits >= 1 && (splits - 1) * per < tiles &&
         splits * per >= tiles &&
         box_is(k_spec, G::kChunk, G::kRowBytes) &&
         box_is(v_spec, G::kChunk, G::kRowBytes);
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* part, void* counter, const int64_t* plan, int64_t n,
                int64_t splits, int64_t per, void* stream) {
  if (!plan_ok<DP, 2>(plan, n, splits, per))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_kernel<decode_mma_kernel<DP>>(Geom<DP, 2>::kSmem, k, v,
                       CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, plan,
                       make_params(q, out, part, counter, plan, n, splits,
                                   per),
                       stream);
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* part, void* counter, const int64_t* plan, int64_t n,
               int64_t splits, int64_t per, void* stream) {
  if (!plan_ok<DP, 4>(plan, n, splits, per))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm = make_params(q, out, part, counter, plan, n, splits, per);
  constexpr int kSmem = Geom<DP, 4>::kSmem;
  const auto dt = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (prm.groups <= 4)
    return launch_kernel<decode_fma_kernel<DP, 4>>(kSmem, k, v, dt, plan, prm,
                                                  stream);
  if (prm.groups <= 8)
    return launch_kernel<decode_fma_kernel<DP, 8>>(kSmem, k, v, dt, plan, prm,
                                                  stream);
  return launch_kernel<decode_fma_kernel<DP, 16>>(kSmem, k, v, dt, plan, prm,
                                                 stream);
}

}  // namespace

// plan: kPlanLen int64 (host memory), as `DecodePlan.args` lays it out;
// n = the last valid position + 1; splits x per tiles of kBlockN cover n.
// part: B x KV x splits x G x (D + 2) float32 (unused for one split);
// counter: B x KV int32, zero between calls.
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, void* out, void* part,
                                     void* counter, const int64_t* plan,
                                     int64_t plan_len, int64_t n,
                                     int64_t splits, int64_t per,
                                     void* stream) {
  if (plan_len != kPlanLen) return static_cast<int>(cudaErrorInvalidValue);
  switch (plan[2]) {
    case 16: return launch_bf16<16>(q, k, v, out, part, counter, plan, n, splits, per, stream);
    case 32: return launch_bf16<32>(q, k, v, out, part, counter, plan, n, splits, per, stream);
    case 64: return launch_bf16<64>(q, k, v, out, part, counter, plan, n, splits, per, stream);
    case 128: return launch_bf16<128>(q, k, v, out, part, counter, plan, n, splits, per, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, void* out, void* part,
                                    void* counter, const int64_t* plan,
                                    int64_t plan_len, int64_t n,
                                    int64_t splits, int64_t per,
                                    void* stream) {
  if (plan_len != kPlanLen) return static_cast<int>(cudaErrorInvalidValue);
  switch (plan[2]) {
    case 8: return launch_f32<8>(q, k, v, out, part, counter, plan, n, splits, per, stream);
    case 16: return launch_f32<16>(q, k, v, out, part, counter, plan, n, splits, per, stream);
    case 32: return launch_f32<32>(q, k, v, out, part, counter, plan, n, splits, per, stream);
    case 64: return launch_f32<64>(q, k, v, out, part, counter, plan, n, splits, per, stream);
    case 128: return launch_f32<128>(q, k, v, out, part, counter, plan, n, splits, per, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
