// Causal GQA flash attention (forward) for Hopper (sm_90a).  Replaces the
// Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py, body `_flash_kernel`).
//
// Computes, for q (B, Sq, H, D) and k, v (B, Sk, KV, D) in the model's
// layout (any strides, D contiguous), H = KV * G:
//
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(D)) v[b, j, h / G]
//
// over j <= i when causal (the reference's `qpos >= kpos`, no offset), as
// an online softmax: running max m, sum l and accumulator acc in float32,
// l floored at 1e-30, the output cast to q's type.  float32 or bfloat16;
// every product and sum is float32 (no TF32).
//
// What bounds it: operations.  At a 2048-token prompt the scores and the
// weighted sum are ~34 GFLOP per layer against ~40 MB moved.  Two kernels,
// chosen by the inputs' type:
//
//   * bfloat16 (the served model): `flash_wgmma_kernel`, warp-specialised
//     on Hopper's tensor-memory accelerator (TMA) and wgmma, for every D
//     in 16, 32, 64, 128, and D = 8 through D = 16's kernel: its boxes are
//     16 wide, and TMA fills the columns past the tensor's 8 with zeros, so
//     the k16 products see zeros there and the extra output columns are
//     never stored.  At D = 8, P V also takes what rounding P to bf16
//     drops, a second product of the bf16 remainder (hop::pack_bf16_rest
//     says why).  A block is three warpgroups (384 threads):
//       - a producer (setmaxnreg down to 24 registers), one thread of
//         which TMA-loads the block's Q tile once, then K and V tiles of
//         kBlockN = 64 positions into a 4-stage ring in shared memory,
//         each stage with a "full" and an "empty" mbarrier;
//       - two consumer warpgroups (setmaxnreg up to 240), each owning 64
//         query rows, so a block holds 128 rows and every K/V tile serves
//         both.  Per tile, S = Q K^T is D / 16 wgmma m64n64k16 with both
//         operands K-major in shared memory; the online softmax runs on
//         S's float32 accumulator fragment in registers (4 lanes a row,
//         shuffles for the max, the scale folded into exp2); P is cast to
//         bf16 in place (as the Pallas kernel casts p to v's type) into
//         A-operand registers, whose fragment layout is the accumulator's;
//         O += P V is 4 wgmma m64n{D}k16 with A from registers and V, kept
//         [position][D] as loaded, an MN-major B (no transpose pass); the
//         consumer then releases the stage on its "empty" barrier;
//       - within a consumer, tile t's softmax overlaps tile t - 1's P V:
//         S(t) and PV(t - 1) are issued together, wgmma.wait_group(1)
//         waits for S(t) only, and O is rescaled after PV(t - 1) retires;
//         across consumers, the two take turns to issue their products
//         (named barriers 1 and 2), so one's softmax runs while the
//         other's products keep the tensor cores busy.
//     Only tiles that straddle the diagonal or Sk run the mask.  What
//     holds it back: S = Q K^T at N = 64 with both operands in shared
//     memory needs ~32 FLOP a byte of shared memory, the SM's limit at
//     the tensor cores' peak; 128-position tiles, or Q held in registers,
//     would halve that but cost the registers that spilled (below);
//   * float32: `flash_attention_kernel` uses float32 FMAs on the CUDA cores
//     (no TF32, which would fail the float32 tolerance): 256 threads as
//     16 x 16, thread (ty, tx) owns query rows 4 ty .. 4 ty + 3, scores in
//     columns tx and tx + 16 of a 32-position tile, and D / 16 output
//     columns; row max and sum reduce over the 16 lanes of a half-warp.
//
// Both keep every intermediate on chip:
//
//   * one block per (q tile, kv head, batch).  Its query rows are
//     positions x the G query heads of that kv head (row r of a 64-row
//     tile is position q0 + r / G, head kvh G + r % G), so every K/V tile
//     staged in shared memory serves all G heads: the Pallas index map's
//     "no KV duplication", done on chip.  A 64-row tile holds 64 / G
//     (rounded down) positions: where G does not divide 64 (G = 3: 63
//     rows; G = 12: 60) the rows past (64 / G) G are idle and never
//     stored.  G = 1..64 (at G > 32, one position a tile).  The bf16
//     kernel's Q box is
//     (64 / G positions, G heads, a band of up to 64 elements of D) of the
//     strided (B, S, H, D) view: no copy;
//   * the block loops over K tiles up to its causal limit (fully masked
//     tiles are never loaded); the TPU's sequential "arbitrary" grid axis
//     becomes this loop;
//   * ragged edges (prompts are multiples of 8, not of the tile) load zeros
//     (TMA fills a box's out-of-bounds part with zeros) and are masked in
//     the kernel: no padding copy exists;
//   * q tiles are scheduled heaviest (latest) first, so the long causal
//     rows do not trail the grid.
//
// Where the bf16 kernel's correctness and speed hang (hopper.cuh's
// conventions): the ring's phase parity (stage t % 4 is in its (t / 4)-th
// use; the producer waits "empty" on the opposite parity, which a fresh
// barrier passes); V's MN-major descriptor (SBO = 8 rows of the box's
// row bytes, LBO = one 64-element band of D to the next); P's register
// fragment (the n8 tiles 2 k and 2 k + 1 of S make the A fragment of k16
// step k); registers: with 128-position tiles S, P and O (64 + 32 + 64
// floats at D = 128) spilled and ptxas serialised every wgmma (C7512), so
// tiles are 64 positions (S 32, P 16), with no spills and no
// serialisation in the ptxas report; a 2-stage ring left the consumers
// waiting for K/V (deeper rings of 5 and 6 stages gained nothing over 4);
// and TMA's 16-byte rule on the strided views (every stride a multiple of
// 16 B, checked by the wrapper; an encoding failure is returned as an
// error code).
//
// The served path calls it causal with Sq == Sk only.  `causal = false`
// and Sq != Sk stay because `flash_attention_pallas` takes them (its
// `causal=` and separate q and kv lengths): the wrapper stands for that
// function whole, and the card tests hold both settings against the plain
// version.
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after the launch, or hop::kEncodeError + the CUresult
// when a tensor map cannot be encoded.

#include "../../csrc/attention_io.cuh"
#include "../../csrc/hopper.cuh"

namespace {

using attn::Io;
using attn::kFull;

constexpr int kThreads = 256;
constexpr int kRows = 64;         // query rows per block (positions x G)
constexpr int kBlockK = 32;       // key positions per tile
constexpr int kPad = 4;           // floats of padding per shared row
constexpr int kMaxGroups = 64;    // H / KV: 1 .. 64

template <int D>
constexpr int smem_floats() {
  return kRows * (D + kPad) + kBlockK * (D + kPad) + kBlockK * D +
         kRows * (kBlockK + kPad);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int64_t q_sb, int64_t q_ss, int64_t q_sh,
                       int64_t k_sb, int64_t k_ss, int64_t k_sh,
                       int64_t v_sb, int64_t v_ss, int64_t v_sh,
                       int64_t o_sb, int64_t o_ss, int64_t o_sh, int sq,
                       int sk, int groups, int causal, float scale) {
  constexpr int kStride = D + kPad;          // qs / ks row stride
  constexpr int kPStride = kBlockK + kPad;   // ps row stride
  constexpr int kVec = Io<T>::kVec;
  constexpr int kVecPerRow = D / kVec;
  // output columns per thread (D = 8: one, on the threads tx < 8)
  constexpr int kCols = D < 16 ? 1 : D / 16;
  constexpr int kW = kCols < 4 ? kCols : 4;  // contiguous columns per group
  constexpr int kColGroups = kCols / kW;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kRows][kStride]
  float* ks = qs + kRows * kStride;              // [kBlockK][kStride]
  float* vs = ks + kBlockK * kStride;            // [kBlockK][D]
  float* ps = vs + kBlockK * D;                  // [kRows][kPStride]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bq = kRows / groups;                 // positions per block
  const int rows_used = bq * groups;             // rows past it are idle
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;

  // the query tile: row r is position q0 + r / G, head kvh * G + r % G
  for (int i = tid; i < kRows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    const int pos = q0 + r / groups;
    float vals[kVec];
    if (r < rows_used && pos < sq) {
      const int h = kvh * groups + r % groups;
      Io<T>::unpack(Io<T>::load(q + b * q_sb + pos * q_ss + h * q_sh + c),
                    vals);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) qs[r * kStride + c + e] = vals[e];
  }

  int pos_row[4];   // sq (never stored) for an idle row
#pragma unroll
  for (int i = 0; i < 4; ++i)
    pos_row[i] = ty * 4 + i < rows_used ? q0 + (ty * 4 + i) / groups : sq;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int q_last = min(q0 + bq, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // qs written / the previous tile fully consumed
    for (int i = tid; i < kBlockK * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const int pos = k0 + r;
      float kf[kVec], vf[kVec];
      if (pos < sk) {
        Io<T>::unpack(Io<T>::load(kb + pos * k_ss + c), kf);
        Io<T>::unpack(Io<T>::load(vb + pos * v_ss + c), vf);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ks[r * kStride + c + e] = kf[e];
        vs[r * D + c + e] = vf[e];
      }
    }
    __syncthreads();

    // scores for rows 4 ty + i, columns tx and tx + 16
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * kStride + d);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
      }
    }

    // mask, then the online softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < sk && (!causal || col <= pos_row[i]);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = attn::exp_sub(m[i], m_new);
      const float p0 = attn::exp_sub(s[i][0], m_new);
      const float p1 = attn::exp_sub(s[i][1], m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
      ps[(ty * 4 + i) * kPStride + tx] = p0;
      ps[(ty * 4 + i) * kPStride + tx + 16] = p1;
    }
    __syncthreads();

    // acc += P V over the tile; this thread's columns are
    // (g * 16 + tx) * kW + e, so a quarter-warp reads 128 contiguous bytes
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kPStride + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j + jj) * D;
        float vv[kCols];
#pragma unroll
        for (int g = 0; g < kColGroups; ++g) {
          const int col = (g * 16 + tx) * kW;
          if constexpr (D < 16) {
            vv[g] = col < D ? vrow[col] : 0.0f;
          } else if constexpr (kW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + col);
            vv[g * 4] = x.x;
            vv[g * 4 + 1] = x.y;
            vv[g * 4 + 2] = x.z;
            vv[g * 4 + 3] = x.w;
          } else {
#pragma unroll
            for (int e = 0; e < kW; ++e) vv[g * kW + e] = vrow[col + e];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pv[i].x
                        : jj == 1 ? pv[i].y
                        : jj == 2 ? pv[i].z
                                  : pv[i].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int pos = pos_row[i];
    if (pos >= sq) continue;
    const int h = kvh * groups + r % groups;
    T* orow = out + b * o_sb + pos * o_ss + h * o_sh;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < kColGroups; ++g) {
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        if (D >= 16 || tx < D)
          orow[(g * 16 + tx) * kW + e] = Io<T>::store(acc[i][g * kW + e] / denom);
      }
    }
  }
}

// ---------------------------------------------------------------- bf16
namespace wg {

using hop::bf16;

constexpr int kConsumers = 2;                   // warpgroups of 64 rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBlockRows = 64 * kConsumers;     // query rows a block
constexpr int kBlockN = 64;                     // key positions a tile
constexpr int kStages = 4;                      // the K/V ring
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared memory of one block for head dimension D: the Q tile, then the
// ring (K then V a stage), then the barriers.  A box row is kRowBytes (D
// elements up to 64, which is also the swizzle); D = 128 is two boxes.
template <int D>
struct Geom {
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kChunk = kRowBytes / 2;     // elements a box row
  static constexpr int kChunks = D / kChunk;
  static constexpr int kQBox = 64 * kRowBytes;     // one consumer's box
  static constexpr int kQBand = kBlockRows * kRowBytes;
  static constexpr int kQBytes = kBlockRows * D * 2;
  static constexpr int kKvBox = kBlockN * kRowBytes;
  static constexpr int kKvBytes = kBlockN * D * 2;  // one K (or V) tile
  static constexpr int kStageBytes = 2 * kKvBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kSmemBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

// kEven: G divides 64, so every row of a consumer's tile is used and a
// block holds 128 / G positions.  Computed so (at compile time), it keeps
// the kernel's time at Qwen3-8B's heads: the general form (rows past
// (64 / G) G idle, 2 (64 / G) positions a block), run for G = 4, was
// slower beyond the noise in a same-call A/B on the card (ptxas
// scheduled the loop differently; PERF.md).
template <int D, bool kEven>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   bf16* __restrict__ out, int64_t o_sb, int64_t o_ss,
                   int64_t o_sh, int sq, int sk, int groups, int d,
                   int causal, float scale_log2) {
  using G = Geom<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop::align1024(smem_raw);
  uint8_t* qs = smem;                    // [band][128 rows][kRowBytes]
  uint8_t* ring = smem + G::kQBytes;     // [stage][K | V][band][128][.]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + G::kBarOffset);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int per_c = 64 / groups;         // positions a consumer
  // of its 64 rows; the rest idle
  const int rows_used = kEven ? 64 : per_c * groups;
  // positions a block
  const int bq = kEven ? kBlockRows / groups : kConsumers * per_c;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int q_last = min(q0 + bq, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int n_tiles = (k_end + kBlockN - 1) / kBlockN;
  const int wg_id = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 4 * kConsumers);   // one arrival a warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg_id == 0) {
    // ------------------------------------------------------ producer
    hop::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      hop::mbar_expect_tx(q_full, kConsumers * G::kChunks * rows_used *
                                      G::kRowBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int ch = 0; ch < G::kChunks; ++ch)
          hop::tma_load_4d(qs + ch * G::kQBand + c * G::kQBox, &q_map, q_full,
                           ch * G::kChunk, kvh * groups, q0 + c * per_c, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        hop::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        hop::mbar_expect_tx(&full[s], G::kStageBytes);
        uint8_t* kt = ring + s * G::kStageBytes;
        for (int ch = 0; ch < G::kChunks; ++ch) {
          hop::tma_load_4d(kt + ch * G::kKvBox, &k_map, &full[s],
                           ch * G::kChunk, kvh, t * kBlockN, b);
          hop::tma_load_4d(kt + G::kKvBytes + ch * G::kKvBox, &v_map,
                           &full[s], ch * G::kChunk, kvh, t * kBlockN, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    hop::reg_alloc<kConsumerRegs>();
    const int c = wg_id - 1;
    const int lane = threadIdx.x % 32;
    const int gr = lane / 4;
    const int tq = lane % 4;
    const int row_a = (threadIdx.x / 32) % 4 * 16 + gr;   // and row_a + 8
    const int p0 = q0 + c * per_c;   // the consumer's first position
    // (an idle row's position is the next consumer's first: masked as
    // such, and never stored)
    const int pos_a = p0 + row_a / groups;
    const int pos_b = p0 + (row_a + 8) / groups;
    const uint8_t* q_tile = qs + c * G::kQBox;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
    float sc[kBlockN / 2];             // S of one tile, then its P
    uint32_t pa[kBlockN / 16][4];      // P as bf16 A fragments
    uint32_t pr[kBlockN / 16][4];      // D = 8: P - bf16(P), as fragments
    const bool p_rest = D == 16 && d < 16;

    // S = Q K^T of tile t (both K-major), issued and committed
    auto issue_s = [&](int t) {
      const uint8_t* kt = ring + (t % kStages) * G::kStageBytes;
      hop::fence_regs(sc);
      hop::wgmma_fence();
#pragma unroll
      for (int st = 0; st < D / 16; ++st)
        hop::Wgmma<kBlockN>::template ss<0>(
            sc, hop::desc_k_major(q_tile, st, G::kRowBytes, G::kQBand),
            hop::desc_k_major(kt, st, G::kRowBytes, G::kKvBox), st > 0);
      hop::wgmma_commit();
    };
    // O += P V of tile t (V an MN-major B, P from registers), committed
    auto issue_pv = [&](int t) {
      const uint8_t* vt =
          ring + (t % kStages) * G::kStageBytes + G::kKvBytes;
#pragma unroll
      for (int k = 0; k < kBlockN / 16; ++k) hop::fence_regs(pa[k]);
      if constexpr (D == 16) {
#pragma unroll
        for (int k = 0; k < kBlockN / 16; ++k) hop::fence_regs(pr[k]);
      }
      hop::fence_regs(o);
      hop::wgmma_fence();
#pragma unroll
      for (int st = 0; st < kBlockN / 16; ++st)
        hop::Wgmma<D>::template rs<1>(
            o, pa[st], hop::desc_mn_major(vt, st, G::kRowBytes, G::kKvBox),
            1);
      if constexpr (D == 16) {
        if (p_rest) {
#pragma unroll
          for (int st = 0; st < kBlockN / 16; ++st)
            hop::Wgmma<D>::template rs<1>(
                o, pr[st],
                hop::desc_mn_major(vt, st, G::kRowBytes, G::kKvBox), 1);
        }
      }
      hop::wgmma_commit();
    };
    // tile t's S (retired) -> its probabilities in sc, in place; returns
    // the rescale factors of rows row_a and row_a + 8 through alpha_*
    auto softmax = [&](int t, float& alpha_a, float& alpha_b) {
      const int k0 = t * kBlockN;
      // the mask, on tiles that straddle the diagonal or Sk only
      if (k0 + kBlockN > sk || (causal && k0 + kBlockN - 1 > p0)) {
#pragma unroll
        for (int i = 0; i < kBlockN / 8; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = k0 + 8 * i + 2 * tq + (j & 1);
            const int pos = j < 2 ? pos_a : pos_b;
            if (col >= sk || (causal && col > pos)) sc[4 * i + j] = -INFINITY;
          }
        }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBlockN / 8; ++i) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(attn::kFull, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(attn::kFull, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a);
      const float mn_b = fmaxf(m_b, mx_b);
      // exp((x - m) scale) = exp2(x scale log2(e) - m scale log2(e)); a
      // max of -inf (nothing seen) contributes nothing
      const float base_a = mn_a == -INFINITY ? 0.0f : mn_a * scale_log2;
      const float base_b = mn_b == -INFINITY ? 0.0f : mn_b * scale_log2;
      alpha_a = exp2f(fmaf(m_a, scale_log2, -base_a));
      alpha_b = exp2f(fmaf(m_b, scale_log2, -base_b));
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int i = 0; i < kBlockN / 8; ++i) {
        sc[4 * i] = exp2f(fmaf(sc[4 * i], scale_log2, -base_a));
        sc[4 * i + 1] = exp2f(fmaf(sc[4 * i + 1], scale_log2, -base_a));
        sc[4 * i + 2] = exp2f(fmaf(sc[4 * i + 2], scale_log2, -base_b));
        sc[4 * i + 3] = exp2f(fmaf(sc[4 * i + 3], scale_log2, -base_b));
        sum_a += sc[4 * i] + sc[4 * i + 1];
        sum_b += sc[4 * i + 2] + sc[4 * i + 3];
      }
      // l stays a per-lane partial sum (alpha is the row's): the 4 lanes
      // of a row are summed once, at the end
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
    };
    // P as bf16 A fragments: S's n8 tiles 2 k and 2 k + 1 are step k's
    auto pack_p = [&]() {
#pragma unroll
      for (int k = 0; k < kBlockN / 16; ++k) {
        pa[k][0] = hop::pack_bf16(sc[8 * k], sc[8 * k + 1]);
        pa[k][1] = hop::pack_bf16(sc[8 * k + 2], sc[8 * k + 3]);
        pa[k][2] = hop::pack_bf16(sc[8 * k + 4], sc[8 * k + 5]);
        pa[k][3] = hop::pack_bf16(sc[8 * k + 6], sc[8 * k + 7]);
        if constexpr (D == 16) {
          if (p_rest) {
            pr[k][0] = hop::pack_bf16_rest(sc[8 * k], sc[8 * k + 1]);
            pr[k][1] = hop::pack_bf16_rest(sc[8 * k + 2], sc[8 * k + 3]);
            pr[k][2] = hop::pack_bf16_rest(sc[8 * k + 4], sc[8 * k + 5]);
            pr[k][3] = hop::pack_bf16_rest(sc[8 * k + 6], sc[8 * k + 7]);
          }
        }
      }
    };

    // Tile t's softmax runs while tile t - 1's P V is on the tensor
    // cores: per tile, issue S(t) and PV(t - 1), wait for S(t) only, run
    // the softmax, then wait for PV(t - 1), release its stage, rescale O
    // and pack P(t).
    float alpha_a, alpha_b;
    // Ping-pong: the consumers take turns to issue their products (named
    // barriers 1 and 2), so one's softmax runs while the other's products
    // keep the tensor cores busy.  A consumer issues n_tiles + 1 times;
    // consumer 1 opens consumer 0's first turn and skips its own last
    // hand-over, so every bar.sync meets one bar.arrive.
    const int phases = n_tiles + 1;
    int phase = 0;
    auto turn = [&]() { hop::named_bar_sync(1 + c, 256); };
    auto hand_over = [&]() {
      if (!(c == 1 && phase == phases - 1)) hop::named_bar_arrive(2 - c, 256);
      ++phase;
    };
    if (c == 1) hop::named_bar_arrive(1, 256);
    hop::mbar_wait(q_full, 0);
    hop::mbar_wait(&full[0], 0);
    turn();
    issue_s(0);
    hand_over();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);
    softmax(0, alpha_a, alpha_b);
    pack_p();
    for (int t = 1; t < n_tiles; ++t) {
      hop::mbar_wait(&full[t % kStages], (t / kStages) & 1);
      turn();
      issue_s(t);
      issue_pv(t - 1);
      hand_over();
      hop::wgmma_wait<1>();
      hop::fence_regs(sc);
      softmax(t, alpha_a, alpha_b);
      hop::wgmma_wait<0>();
      hop::fence_regs(o);
#pragma unroll
      for (int k = 0; k < kBlockN / 16; ++k) hop::fence_regs(pa[k]);
      if constexpr (D == 16) {
#pragma unroll
        for (int k = 0; k < kBlockN / 16; ++k) hop::fence_regs(pr[k]);
      }
      if (lane == 0) hop::mbar_arrive(&empty[(t - 1) % kStages]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= alpha_a;
        o[4 * i + 1] *= alpha_a;
        o[4 * i + 2] *= alpha_b;
        o[4 * i + 3] *= alpha_b;
      }
      pack_p();
    }
    turn();
    issue_pv(n_tiles - 1);
    hand_over();
    hop::wgmma_wait<0>();
    hop::fence_regs(o);
#pragma unroll
    for (int k = 0; k < kBlockN / 16; ++k) hop::fence_regs(pa[k]);
    if constexpr (D == 16) {
#pragma unroll
      for (int k = 0; k < kBlockN / 16; ++k) hop::fence_regs(pr[k]);
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(attn::kFull, l_a, off);
      l_b += __shfl_xor_sync(attn::kFull, l_b, off);
    }
    const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
    if (pos_a < sq && row_a < rows_used) {
      bf16* orow = out + b * o_sb + pos_a * o_ss +
                   (kvh * groups + row_a % groups) * o_sh + 2 * tq;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        if (D != 16 || 8 * i < d)
          *reinterpret_cast<uint32_t*>(orow + 8 * i) =
              hop::pack_bf16(o[4 * i] * inv_a, o[4 * i + 1] * inv_a);
    }
    if (pos_b < sq && row_a + 8 < rows_used) {
      bf16* orow = out + b * o_sb + pos_b * o_ss +
                   (kvh * groups + (row_a + 8) % groups) * o_sh + 2 * tq;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        if (D != 16 || 8 * i < d)
          *reinterpret_cast<uint32_t*>(orow + 8 * i) =
              hop::pack_bf16(o[4 * i + 2] * inv_b, o[4 * i + 3] * inv_b);
    }
  }
}

// The launch plan (kernels/flash_attention/kernel.py `FlashPlan.args`):
// grid (3), threads, shared bytes, sq, sk, G, D, causal, out's strides
// (3, elements), then the Q, K and V maps (hop::kMapSpecLen values each).
// D is the tensors' (8 runs D = 16's kernel); the template D the tiles'.
constexpr int kPlanHead = 13;
constexpr int kPlanLen = kPlanHead + 3 * hop::kMapSpecLen;

bool box_is(const int64_t* spec, int64_t b0, int64_t b1, int64_t b2,
            int64_t b3, int64_t swizzle) {
  return spec[0] == 4 && spec[8] == b0 && spec[9] == b1 && spec[10] == b2 &&
         spec[11] == b3 && spec[12] == swizzle;
}

// Launch D's kernel after holding the plan to what the kernel was
// compiled for (boxes, swizzle, threads, shared bytes, grid).
template <int D, bool kEven>
int launch_g(const void* q, const void* k, const void* v, void* out,
             const int64_t* plan, void* stream) {
  using G = Geom<D>;
  const int64_t sq = plan[5], sk = plan[6], groups = plan[7];
  const int64_t* q_spec = plan + kPlanHead;
  const int64_t* k_spec = q_spec + hop::kMapSpecLen;
  const int64_t* v_spec = k_spec + hop::kMapSpecLen;
  const int64_t bq = kConsumers * (64 / groups);
  if (plan[3] != kThreads || plan[4] != G::kSmemBytes ||
      plan[0] != (sq + bq - 1) / bq ||
      !box_is(q_spec, G::kChunk, groups, 64 / groups, 1, G::kRowBytes) ||
      !box_is(k_spec, G::kChunk, 1, kBlockN, 1, G::kRowBytes) ||
      !box_is(v_spec, G::kChunk, 1, kBlockN, 1, G::kRowBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, k_map, v_map;
  int err = hop::encode_map(&q_map, q, q_spec);
  if (err == 0) err = hop::encode_map(&k_map, k, k_spec);
  if (err == 0) err = hop::encode_map(&v_map, v, v_spec);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<D, kEven>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(plan[0]),
                  static_cast<unsigned>(plan[1]),
                  static_cast<unsigned>(plan[2]));
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(plan[8])));
  flash_wgmma_kernel<D, kEven><<<grid, kThreads, G::kSmemBytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<bf16*>(out), plan[10], plan[11],
      plan[12], static_cast<int>(sq), static_cast<int>(sk),
      static_cast<int>(groups), static_cast<int>(plan[8]),
      static_cast<int>(plan[9]), scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           const int64_t* plan, void* stream) {
  return 64 % plan[7] == 0 ? launch_g<D, true>(q, k, v, out, plan, stream)
                           : launch_g<D, false>(q, k, v, out, plan, stream);
}

}  // namespace wg

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out,
             const int64_t* st, int64_t batch, int64_t sq, int64_t sk,
             int64_t kv, int64_t groups, int64_t causal, void* stream) {
  constexpr size_t smem = static_cast<size_t>(smem_floats<D>()) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t bq = kRows / groups;
  const dim3 grid(static_cast<unsigned>((sq + bq - 1) / bq),
                  static_cast<unsigned>(kv), static_cast<unsigned>(batch));
  flash_attention_kernel<T, D><<<grid, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      static_cast<int>(sq), static_cast<int>(sk), static_cast<int>(groups),
      static_cast<int>(causal), static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

// D -> the float32 kernel instantiated for it
int launch_f32(const void* q, const void* k, const void* v, void* out,
               const int64_t* strides, int64_t batch, int64_t sq, int64_t sk,
               int64_t kv, int64_t groups, int64_t d, int64_t causal,
               void* stream) {
  if (groups < 1 || groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
#define REPRO_FLASH_CASE(DIM)                                                 \
  case DIM:                                                                   \
    return launch_d<float, DIM>(q, k, v, out, strides, batch, sq, sk, kv,     \
                                groups, causal, stream);
    REPRO_FLASH_CASE(8)
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
#undef REPRO_FLASH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 int64 (host memory), in elements: q, k, v, out, each as
// (batch, position, head); the last axis (D) is contiguous.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out,
                                   const int64_t* strides, int64_t batch,
                                   int64_t sq, int64_t sk, int64_t kv,
                                   int64_t groups, int64_t d, int64_t causal,
                                   void* stream) {
  return launch_f32(q, k, v, out, strides, batch, sq, sk, kv, groups, d,
                    causal, stream);
}

// plan: wg::kPlanLen int64 (host memory), as `FlashPlan.args` lays it out.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out,
                                    const int64_t* plan, int64_t plan_len,
                                    void* stream) {
  if (plan_len != wg::kPlanLen) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t groups = plan[7];
  if (groups < 1 || groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (plan[8]) {
    case 8:   // a 16-wide band, zero past the tensor's 8 columns
    case 16: return wg::launch<16>(q, k, v, out, plan, stream);
    case 32: return wg::launch<32>(q, k, v, out, plan, stream);
    case 64: return wg::launch<64>(q, k, v, out, plan, stream);
    case 128: return wg::launch<128>(q, k, v, out, plan, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
