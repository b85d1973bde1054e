// Fused xDeepFM CIN layer, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel `cin_layer_pallas`
// (src/repro/kernels/cin_fuse/kernel.py, body `_cin_kernel`).
//
// Computes, for xk (B, Hk, D), x0 (B, m, D) and W (Hk * m, O):
//
//   y[b, o, d] = sum_{h, j} (xk[b, h, d] * x0[b, j, d]) W[h * m + j, o]
//
// with each product xk * x0 rounded to the input type (as the Pallas kernel
// forms its outer product), the sum in float32, and y (B, O, D) in the
// input type.  The outer product (B, Hk, m, D) never exists in device
// memory: at B = 262,144 and Hk = 200 it would be 40.9 GB a layer.
//
// What bounds it: operations.  2 B D Hk m O FLOP (8.2 TFLOP at B =
// 262,144 for a 200 x 39 -> 200 layer) against reads of xk, x0, W and the
// write of y (1.3 GB): ~1,300 FLOP per byte, far above the H100's ~295.
// The TPU kernel keeps W (Hk m x O, 3.1 MB in bfloat16) resident in VMEM
// and walks a (B / bb, D) grid; a Hopper block has 227 KB of shared memory,
// so here the layer is an implicit GEMM instead:
//
//   rows (b, d) = B D, K = Hk m, N = O,
//   A[(b, d), (h, j)] = xk[b, h, d] x0[b, j, d]
//
//   * a block owns 64 rows and a tile of columns (104 on the tensor cores:
//     O = 200 is two tiles), and walks all of K, accumulating in float32
//     registers; its xk values (Hk a row) are staged in shared memory once;
//   * bfloat16 (the served model) runs the products on the tensor cores,
//     mma.sync.m16n8k16, bf16 in, float32 accumulate.  For one h, A's
//     columns are x0's rows scaled by xk[., h]: each warp holds its 16 rows
//     of x0 as A fragments in registers (j padded to a multiple of 16 with
//     zeros; m <= 64) and scales them by one bf16x2 multiply a register per
//     h, so A never passes through shared memory.  W's m rows of each h are
//     double-buffered in shared memory, their next h's global loads in
//     flight during this h's products, and read by ldmatrix.trans;
//   * float32 runs FMAs on the CUDA cores (TF32 would round the inputs to
//     10 bits): A's K-tiles built in shared memory from the staged x0 and
//     xk, W's tiles beside them, 4 x 4 outputs a thread;
//   * ragged edges are masked, not padded in memory: rows past B D (B
//     needs not be a multiple of the tile), K past Hk m and columns past O.
//
// No cuBLAS, no library GEMM.  A wgmma / TMA pipeline is later work.
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Stage rows r0 .. r0 + rows_tile - 1 (row = b D + d) of src (B, inner, D)
// into shared memory as dst[row][i] (stride ld); zeros past n_rows.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, T* dst,
                                           int64_t r0, int rows_tile,
                                           int64_t n_rows, int inner, int d,
                                           int ld, int tid, int threads) {
  for (int i = tid; i < rows_tile * inner; i += threads) {
    const int rr = i % rows_tile;
    const int h = i / rows_tile;
    const int64_t row = r0 + rr;
    T v = from_float<T>(0.0f);
    if (row < n_rows) {
      const int64_t b = row / d;
      v = src[(b * inner + h) * d + (row - b * d)];
    }
    dst[rr * ld + h] = v;
  }
}

// y[b, col, d] for row = b D + d
template <typename T>
__device__ __forceinline__ void store_y(T* __restrict__ y, int64_t row,
                                        int col, float v, int64_t n_rows,
                                        int n_out, int d) {
  if (row < n_rows && col < n_out) {
    const int64_t b = row / d;
    y[(b * n_out + col) * d + (row - b * d)] = from_float<T>(v);
  }
}

// ------------------------------------------------------------ FMA (float32)
constexpr int kFmaThreads = 256;  // 16 x 16, each 4 rows x 4 columns
constexpr int kFmaRows = 64;
constexpr int kFmaCols = 64;
constexpr int kFmaK = 16;

__host__ __device__ constexpr int odd(int x) { return x | 1; }

size_t fma_smem_bytes(int hk, int m) {
  return sizeof(float) * kFmaRows * (2 * kFmaK + odd(hk) + odd(m));
}

__global__ void __launch_bounds__(kFmaThreads)
cin_fma_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
               const float* __restrict__ w, float* __restrict__ y,
               int64_t n_rows, int hk, int m, int d, int n_out,
               int64_t col_tiles) {
  extern __shared__ float4 fma_smem[];
  float* a_s = reinterpret_cast<float*>(fma_smem);  // [kFmaK][kFmaRows]
  float* w_s = a_s + kFmaK * kFmaRows;              // [kFmaK][kFmaCols]
  float* xk_s = w_s + kFmaK * kFmaCols;
  const int xk_ld = odd(hk);  // odd strides: lanes on rows hit distinct banks
  const int x0_ld = odd(m);
  float* x0_s = xk_s + kFmaRows * xk_ld;

  const int64_t tile = blockIdx.x;
  const int64_t r0 = (tile / col_tiles) * kFmaRows;
  const int n0 = static_cast<int>(tile % col_tiles) * kFmaCols;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int k_total = hk * m;

  stage_rows(xk, xk_s, r0, kFmaRows, n_rows, hk, d, xk_ld, tid, kFmaThreads);
  stage_rows(x0, x0_s, r0, kFmaRows, n_rows, m, d, x0_ld, tid, kFmaThreads);

  float acc[4][4] = {};
  for (int k0 = 0; k0 < k_total; k0 += kFmaK) {
    __syncthreads();  // the previous tiles consumed; the rows staged
    for (int i = tid; i < kFmaK * kFmaRows; i += kFmaThreads) {
      const int rr = i % kFmaRows;
      const int kk = i / kFmaRows;
      const int k = k0 + kk;
      float a = 0.0f;
      if (k < k_total) {
        const int h = k / m;
        const int j = k - h * m;
        a = xk_s[rr * xk_ld + h] * x0_s[rr * x0_ld + j];
      }
      a_s[kk * kFmaRows + rr] = a;
    }
    for (int i = tid; i < kFmaK * kFmaCols; i += kFmaThreads) {
      const int nn = i % kFmaCols;
      const int kk = i / kFmaCols;
      const int k = k0 + kk;
      const int n = n0 + nn;
      w_s[kk * kFmaCols + nn] =
          (k < k_total && n < n_out) ? w[static_cast<int64_t>(k) * n_out + n]
                                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmaK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(
          a_s + kk * kFmaRows + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(
          w_s + kk * kFmaCols + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_y(y, r0 + ty * 4 + i, n0 + tx * 4 + j, acc[i][j], n_rows, n_out,
              d);
}

// ------------------------------------------------------ tensor cores (bf16)
//
// A[(b, d), (h, j)] = xk[b, h, d] x0[b, j, d]: for one h, A's columns are
// x0's rows scaled by xk[:, h].  So a warp keeps its 16 rows of x0 as
// mma A fragments in registers (j padded with zeros to 16 kSteps) and,
// for each h, scales them by its rows' xk[., h] with one bf16x2 multiply
// a register (the product rounded once, as the Pallas kernel's outer
// product is); no A tile is built in shared memory.  W's rows h m .. h m +
// m - 1 (one per j) are staged per h, double-buffered: their global loads
// are issued into registers before the products of the previous h.
constexpr int kMmaThreads = 128;          // 4 warps x 16 rows
constexpr int kMmaRows = 64;
constexpr int kMmaNTiles = 13;            // n8 tiles a warp: 104 columns
constexpr int kMmaCols = 8 * kMmaNTiles;  // O = 200 is two column tiles
constexpr int kWStride = kMmaCols + 16;   // bf16: 15 x 16 B, odd, so the
                                          // 8 rows of an ldmatrix hit
                                          // distinct banks

// 16-byte chunks of W a thread stages per h
template <int kSteps>
__host__ __device__ constexpr int mma_w_loads() {
  return (16 * kSteps * kMmaNTiles + kMmaThreads - 1) / kMmaThreads;
}

template <int kSteps>
size_t mma_smem_bytes(int hk) {
  return sizeof(bf16) * (2 * 16 * kSteps * kWStride + kMmaRows * hk);
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

// four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8 i ..
// 8 i + 7 give the row addresses of the i-th
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ... two of them: lanes 0-15 give the row addresses
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const bf16* row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// W[k, n .. n + 7] as 16 bytes, zeros past n_out.  kVec: one 16-byte load
// (n_out a multiple of 8, W 16-byte aligned), else 8 loads.
template <bool kVec>
__device__ __forceinline__ uint4 load_w_chunk(const bf16* __restrict__ w,
                                              int64_t k, int n, int n_out) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (n >= n_out) return v;
  const bf16* src = w + k * n_out + n;
  if (kVec) return *reinterpret_cast<const uint4*>(src);
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (n + j < n_out) e[j] = src[j];
  return v;
}

// x0[b, j, d] and x0[b, j + 1, d] of one row as a bf16 pair; zeros past m
// and past n_rows
__device__ __forceinline__ uint32_t x0_pair(const bf16* __restrict__ x0,
                                            int64_t row, int j, int64_t n_rows,
                                            int m, int d) {
  bf16 lo = __float2bfloat16_rn(0.0f), hi = lo;
  if (row < n_rows) {
    const int64_t b = row / d;
    const bf16* base = x0 + b * m * d + (row - b * d);
    if (j < m) lo = base[static_cast<int64_t>(j) * d];
    if (j + 1 < m) hi = base[static_cast<int64_t>(j + 1) * d];
  }
  return as_u32(__halves2bfloat162(lo, hi));
}

// Fragment layout of m16n8k16 (PTX ISA): lane = 4 gr + tq.  A (16 x 16):
// registers (row gr | gr + 8) x (cols 2 tq, 2 tq + 1 | + 8), in the order
// (gr, lo), (gr + 8, lo), (gr, hi), (gr + 8, hi).  B (16 x 8): rows
// 2 tq, 2 tq + 1 (+ 8 in the second register) of column gr.  C (16 x 8):
// c0, c1 at row gr, cols 2 tq, 2 tq + 1; c2, c3 at row gr + 8.
template <int kSteps, bool kVec>
__global__ void __launch_bounds__(kMmaThreads)
cin_mma_kernel(const bf16* __restrict__ xk, const bf16* __restrict__ x0,
               const bf16* __restrict__ w, bf16* __restrict__ y,
               int64_t n_rows, int hk, int m, int d, int n_out,
               int64_t col_tiles) {
  constexpr int kJ = 16 * kSteps;               // j padded
  constexpr int kLoads = mma_w_loads<kSteps>();
  extern __shared__ uint4 mma_smem[];
  bf16* w_s = reinterpret_cast<bf16*>(mma_smem);  // [2][kJ][kWStride]
  bf16* xk_s = w_s + 2 * kJ * kWStride;           // [kMmaRows][hk]

  const int64_t tile = blockIdx.x;
  const int64_t r0 = (tile / col_tiles) * kMmaRows;
  const int n0 = static_cast<int>(tile % col_tiles) * kMmaCols;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane / 4;
  const int tq = lane % 4;
  const int chunks = m * kMmaNTiles;            // W rows of one h, in 8s

  uint4 wreg[kLoads];
  auto load_w = [&](int h) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = tid + i * kMmaThreads;
      const int j = c / kMmaNTiles;
      wreg[i] = c < chunks
                    ? load_w_chunk<kVec>(
                          w, static_cast<int64_t>(h) * m + j,
                          n0 + (c - j * kMmaNTiles) * 8, n_out)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_w = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = tid + i * kMmaThreads;
      if (c < chunks) {
        const int j = c / kMmaNTiles;
        *reinterpret_cast<uint4*>(w_s + (buf * kJ + j) * kWStride +
                                  (c - j * kMmaNTiles) * 8) = wreg[i];
      }
    }
  };

  load_w(0);
  // the padded rows j >= m of both buffers stay zero
  for (int i = tid; i < 2 * (kJ - m) * kWStride; i += kMmaThreads) {
    const int r = i / kWStride;
    const int buf = r / (kJ - m);
    w_s[(buf * kJ + m + r % (kJ - m)) * kWStride + i % kWStride] =
        __float2bfloat16_rn(0.0f);
  }
  stage_rows(xk, xk_s, r0, kMmaRows, n_rows, hk, d, hk, tid, kMmaThreads);

  // this warp's x0 rows as A fragments, j = 16 s + 2 tq (+1, +8, +9)
  const int64_t row_a = r0 + warp * 16 + gr;
  uint32_t x0f[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int j = 16 * s + 2 * tq;
    x0f[s][0] = x0_pair(x0, row_a, j, n_rows, m, d);
    x0f[s][1] = x0_pair(x0, row_a + 8, j, n_rows, m, d);
    x0f[s][2] = x0_pair(x0, row_a, j + 8, n_rows, m, d);
    x0f[s][3] = x0_pair(x0, row_a + 8, j + 8, n_rows, m, d);
  }
  store_w(0);
  __syncthreads();

  float acc[kMmaNTiles][4];
#pragma unroll
  for (int n = 0; n < kMmaNTiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  const bf16* xk_a = xk_s + (warp * 16 + gr) * hk;
  for (int h = 0; h < hk; ++h) {
    const int buf = h & 1;
    if (h + 1 < hk) load_w(h + 1);          // in flight during the products
    const __nv_bfloat162 sa = __bfloat162bfloat162(xk_a[h]);
    const __nv_bfloat162 sb = __bfloat162bfloat162(xk_a[8 * hk + h]);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const uint32_t a[4] = {as_u32(__hmul2(as_bf2(x0f[s][0]), sa)),
                             as_u32(__hmul2(as_bf2(x0f[s][1]), sb)),
                             as_u32(__hmul2(as_bf2(x0f[s][2]), sa)),
                             as_u32(__hmul2(as_bf2(x0f[s][3]), sb))};
      const bf16* wrow = w_s + (buf * kJ + s * 16 + (lane & 15)) * kWStride;
#pragma unroll
      for (int n = 0; n + 1 < kMmaNTiles; n += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wrow + (n + (lane >> 4)) * 8);
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
      if (kMmaNTiles % 2) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, wrow + (kMmaNTiles - 1) * 8);
        mma_bf16(acc[kMmaNTiles - 1], a, b0, b1);
      }
    }
    if (h + 1 < hk) store_w(buf ^ 1);
    __syncthreads();  // buffer buf ^ 1 written; buffer buf free again
  }
#pragma unroll
  for (int n = 0; n < kMmaNTiles; ++n) {
    const int col = n0 + n * 8 + 2 * tq;
    store_y(y, row_a, col, acc[n][0], n_rows, n_out, d);
    store_y(y, row_a, col + 1, acc[n][1], n_rows, n_out, d);
    store_y(y, row_a + 8, col, acc[n][2], n_rows, n_out, d);
    store_y(y, row_a + 8, col + 1, acc[n][3], n_rows, n_out, d);
  }
}

// The grid: one block per (row tile, column tile), column tiles fastest
// so that the blocks of one row tile run together and share its rows in L2.
template <typename T, typename Kernel>
int launch_tiles(Kernel kernel, size_t smem, int threads, int rows_tile,
                 int cols_tile, const void* xk, const void* x0, const void* w,
                 void* y, int64_t batch, int64_t hk, int64_t m, int64_t d,
                 int64_t n_out, void* stream) {
  const int64_t n_rows = batch * d;
  if (n_rows == 0 || n_out == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t col_tiles = (n_out + cols_tile - 1) / cols_tile;
  const int64_t blocks = (n_rows + rows_tile - 1) / rows_tile * col_tiles;
  kernel<<<static_cast<unsigned>(blocks), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xk), static_cast<const T*>(x0),
      static_cast<const T*>(w), static_cast<T*>(y), n_rows,
      static_cast<int>(hk), static_cast<int>(m), static_cast<int>(d),
      static_cast<int>(n_out), col_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xk (batch, hk, d), x0 (batch, m, d), w (hk * m, n_out) and y (batch,
// n_out, d), all contiguous and of one type.
extern "C" int cin_layer_f32(const void* xk, const void* x0, const void* w,
                             void* y, int64_t batch, int64_t hk, int64_t m,
                             int64_t d, int64_t n_out, void* stream) {
  return launch_tiles<float>(cin_fma_kernel,
                             fma_smem_bytes(static_cast<int>(hk),
                                            static_cast<int>(m)),
                             kFmaThreads, kFmaRows, kFmaCols, xk, x0, w, y,
                             batch, hk, m, d, n_out, stream);
}

extern "C" int cin_layer_bf16(const void* xk, const void* x0, const void* w,
                              void* y, int64_t batch, int64_t hk, int64_t m,
                              int64_t d, int64_t n_out, void* stream) {
  const bool vec = n_out % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
#define REPRO_CIN_CASE(STEPS)                                                \
  case STEPS:                                                                \
    return launch_tiles<bf16>(                                               \
        vec ? cin_mma_kernel<STEPS, true> : cin_mma_kernel<STEPS, false>,    \
        mma_smem_bytes<STEPS>(static_cast<int>(hk)), kMmaThreads, kMmaRows,  \
        kMmaCols, xk, x0, w, y, batch, hk, m, d, n_out, stream);
  switch ((m + 15) / 16) {
    REPRO_CIN_CASE(1)
    REPRO_CIN_CASE(2)
    REPRO_CIN_CASE(3)
    REPRO_CIN_CASE(4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_CIN_CASE
}
