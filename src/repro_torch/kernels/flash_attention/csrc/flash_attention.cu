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
//   * bfloat16 (the served model): `flash_attention_mma_kernel` runs both
//     products on the tensor cores with mma.sync.m16n8k16 (bf16 in, float32
//     accumulate).  Each of 4 warps owns 16 query rows: its Q rows stay in
//     registers as A fragments, the scores of a 64-position K tile come out
//     as accumulator fragments, the online softmax runs on them in
//     registers (4 lanes per row, shuffles for max and sum), and they are
//     repacked in place as bf16 A fragments of P for the P V product (as
//     the Pallas kernel casts p to v's type); V's B fragments come from
//     shared memory by ldmatrix.trans.  A wgmma / TMA pipeline is later
//     work;
//   * float32: `flash_attention_kernel` uses float32 FMAs on the CUDA cores
//     (no TF32, which would fail the float32 tolerance): 256 threads as
//     16 x 16, thread (ty, tx) owns query rows 4 ty .. 4 ty + 3, scores in
//     columns tx and tx + 16 of a 32-position tile, and D / 16 output
//     columns; row max and sum reduce over the 16 lanes of a half-warp.
//
// Both keep every intermediate on chip:
//
//   * one block per (q tile, kv head, batch).  Its kRows query rows are
//     kRows / G positions x the G query heads of that kv head, so every
//     K/V tile staged in shared memory serves all G heads: the Pallas index
//     map's "no KV duplication", done on chip;
//   * the block loops over K tiles up to its causal limit (fully masked
//     tiles are never loaded); the TPU's sequential "arbitrary" grid axis
//     becomes this loop;
//   * ragged edges (prompts are multiples of 8, not of the tile) load zeros
//     and are masked in the kernel: no padding copy exists;
//   * q tiles are scheduled heaviest (latest) first, so the long causal
//     rows do not trail the grid.
//
// The served path calls it causal with Sq == Sk only.  `causal = false`
// and Sq != Sk stay because `flash_attention_pallas` takes them (its
// `causal=` and separate q and kv lengths): the wrapper stands for that
// function whole, and the card tests hold both settings against the plain
// version.
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after the launch.

#include <type_traits>

#include "../../csrc/attention_io.cuh"

namespace {

using attn::Io;
using attn::kFull;

constexpr int kThreads = 256;
constexpr int kRows = 64;         // query rows per block (positions x G)
constexpr int kBlockK = 32;       // key positions per tile
constexpr int kPad = 4;           // floats of padding per shared row

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
  constexpr int kCols = D / 16;              // output columns per thread
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
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;

  // the query tile: row r is position q0 + r / G, head kvh * G + r % G
  for (int i = tid; i < kRows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    const int pos = q0 + r / groups;
    float vals[kVec];
    if (pos < sq) {
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

  int pos_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pos_row[i] = q0 + (ty * 4 + i) / groups;

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
          if constexpr (kW == 4) {
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
        orow[(g * 16 + tx) * kW + e] = Io<T>::store(acc[i][g * kW + e] / denom);
      }
    }
  }
}

// ---------------------------------------------------------------- bf16
constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows = kRows
constexpr int kMmaBlockK = 64;    // key positions per tile
constexpr int kHalfPad = 8;       // bf16 of padding per shared row

using bf16 = __nv_bfloat16;

template <int D>
constexpr int mma_smem_bytes() {
  return (kRows + 2 * kMmaBlockK) * (D + kHalfPad) * 2;
}

// c += a b: one m16n8k16 product, bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two 8 x 8 bf16 matrices from shared memory, transposed: lanes 0-7 give
// the row addresses of the first, lanes 8-15 of the second
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const bf16* row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout of m16n8k16 (PTX ISA): lane = 4 gr + tq.  A (16 x 16):
// registers (row gr | gr + 8) x (cols 2 tq, 2 tq + 1 | + 8), in the order
// (gr, lo), (gr + 8, lo), (gr, hi), (gr + 8, hi).  B (16 x 8): rows
// 2 tq, 2 tq + 1 (+ 8 in the second register) of column gr.  C (16 x 8):
// c0, c1 at row gr, cols 2 tq, 2 tq + 1; c2, c3 at row gr + 8.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t o_sb, int64_t o_ss, int64_t o_sh, int sq,
                           int sk, int groups, int causal, float scale) {
  constexpr int kS = D + kHalfPad;          // shared row stride (bf16)
  constexpr int kVecs = D / 8;              // 16 B vectors per row
  constexpr int kDSteps = D / 16;           // k-steps of Q K^T
  constexpr int kSTiles = kMmaBlockK / 8;   // n-tiles of a score tile
  constexpr int kOTiles = D / 8;            // n-tiles of the output

  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);   // [kRows][kS]
  bf16* ks = qs + kRows * kS;                  // [kMmaBlockK][kS]
  bf16* vs = ks + kMmaBlockK * kS;             // [kMmaBlockK][kS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int bq = kRows / groups;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;

  for (int i = tid; i < kRows * kVecs; i += kMmaThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    const int pos = q0 + r / groups;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (pos < sq) {
      const int h = kvh * groups + r % groups;
      val = *reinterpret_cast<const uint4*>(q + b * q_sb + pos * q_ss +
                                            h * q_sh + c);
    }
    *reinterpret_cast<uint4*>(qs + r * kS + c) = val;
  }
  __syncthreads();

  const int row_a = warp * 16 + gr;   // this lane's two rows
  const int row_b = row_a + 8;
  uint32_t qa[kDSteps][4];
#pragma unroll
  for (int d = 0; d < kDSteps; ++d) {
    const bf16* p = qs + row_a * kS + d * 16 + 2 * tq;
    qa[d][0] = lds32(p);
    qa[d][1] = lds32(p + 8 * kS);
    qa[d][2] = lds32(p + 8);
    qa[d][3] = lds32(p + 8 * kS + 8);
  }

  const int pos_a = q0 + row_a / groups;
  const int pos_b = q0 + row_b / groups;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
  float o[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  const int q_last = min(q0 + bq, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;

  for (int k0 = 0; k0 < k_end; k0 += kMmaBlockK) {
    __syncthreads();  // the previous tile fully consumed
    for (int i = tid; i < kMmaBlockK * kVecs; i += kMmaThreads) {
      const int r = i / kVecs;
      const int c = (i % kVecs) * 8;
      const int pos = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (pos < sk) {
        kv = *reinterpret_cast<const uint4*>(kb + pos * k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vb + pos * v_ss + c);
      }
      *reinterpret_cast<uint4*>(ks + r * kS + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * kS + c) = vv;
    }
    __syncthreads();

    // scores of rows (row_a, row_b) x this tile
    float sc[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
      for (int d = 0; d < kDSteps; ++d) {
        const bf16* p = ks + (n * 8 + gr) * kS + d * 16 + 2 * tq;
        mma_bf16(sc[n], qa[d], lds32(p), lds32(p + 8));
      }
    }

    // mask, then the online softmax update of the two rows
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + n * 8 + 2 * tq + j;
        const bool ok_a = col < sk && (!causal || col <= pos_a);
        const bool ok_b = col < sk && (!causal || col <= pos_b);
        sc[n][j] = ok_a ? sc[n][j] * scale : -INFINITY;
        sc[n][2 + j] = ok_b ? sc[n][2 + j] * scale : -INFINITY;
        mx_a = fmaxf(mx_a, sc[n][j]);
        mx_b = fmaxf(mx_b, sc[n][2 + j]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = attn::exp_sub(m_a, mn_a);
    const float alpha_b = attn::exp_sub(m_b, mn_b);
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[n][j] = attn::exp_sub(sc[n][j], mn_a);
        sc[n][2 + j] = attn::exp_sub(sc[n][2 + j], mn_b);
        sum_a += sc[n][j];
        sum_b += sc[n][2 + j];
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sum_a += __shfl_xor_sync(kFull, sum_a, off);
      sum_b += __shfl_xor_sync(kFull, sum_b, off);
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int n = 0; n < kOTiles; ++n) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
    }

    // o += P V, 16 positions a step: two score n-tiles make one A fragment
#pragma unroll
    for (int kk = 0; kk < kSTiles / 2; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const bf16* vrow = vs + (kk * 16 + (lane & 15)) * kS;
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + n * 8);
        mma_bf16(o[n], pa, b0, b1);
      }
    }
  }

  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  if (pos_a < sq) {
    bf16* orow = out + b * o_sb + pos_a * o_ss +
                 (kvh * groups + row_a % groups) * o_sh + 2 * tq;
#pragma unroll
    for (int n = 0; n < kOTiles; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][0] * inv_a, o[n][1] * inv_a);
  }
  if (pos_b < sq) {
    bf16* orow = out + b * o_sb + pos_b * o_ss +
                 (kvh * groups + row_b % groups) * o_sh + 2 * tq;
#pragma unroll
    for (int n = 0; n < kOTiles; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][2] * inv_b, o[n][3] * inv_b);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               const int64_t* st, int64_t batch, int64_t sq, int64_t sk,
               int64_t kv, int64_t groups, int64_t causal, void* stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t bq = kRows / groups;
  const dim3 grid(static_cast<unsigned>((sq + bq - 1) / bq),
                  static_cast<unsigned>(kv), static_cast<unsigned>(batch));
  flash_attention_mma_kernel<D><<<grid, kMmaThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      static_cast<int>(sq), static_cast<int>(sk), static_cast<int>(groups),
      static_cast<int>(causal),
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

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

// D -> the kernel instantiated for it: the tensor-core kernel for
// bfloat16, the FMA kernel for float32
template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const int64_t* strides, int64_t batch, int64_t sq, int64_t sk,
           int64_t kv, int64_t groups, int64_t d, int64_t causal,
           void* stream) {
  if (groups < 1 || groups > kRows || kRows % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_CASE(DIM)                                                 \
  case DIM:                                                                   \
    if constexpr (std::is_same_v<T, bf16>)                                    \
      return launch_mma<DIM>(q, k, v, out, strides, batch, sq, sk, kv,        \
                             groups, causal, stream);                         \
    else                                                                      \
      return launch_d<T, DIM>(q, k, v, out, strides, batch, sq, sk, kv,       \
                              groups, causal, stream);
  switch (d) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_CASE
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
  return launch<float>(q, k, v, out, strides, batch, sq, sk, kv, groups, d,
                       causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out,
                                    const int64_t* strides, int64_t batch,
                                    int64_t sq, int64_t sk, int64_t kv,
                                    int64_t groups, int64_t d, int64_t causal,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, strides, batch, sq, sk, kv,
                               groups, d, causal, stream);
}
