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
//   * bfloat16 (the served model): `cin_wgmma_kernel`, warp-specialised
//     on TMA and wgmma.  A block is three warpgroups: a producer (one
//     thread of which streams W) and two consumers of 64 rows each, so a
//     block owns 128 rows and all of N (a column tile of it past 200) and
//     walks K one h at a time:
//       - A from registers.  For one h, A's columns are x0's rows scaled
//         by xk[., h]: each warp keeps its 16 rows of x0 as wgmma A
//         fragments (j padded with zeros to kSteps k16 steps: m = 39 is
//         48, 19 % of the products wasted on padding) and scales them by
//         its rows' xk[., h] with one bf16x2 multiply a register (the
//         product rounded once, as the Pallas kernel's outer product is),
//         so A never passes through shared memory.  xk[., h] is read two
//         h ahead into registers (each value its own register: packing
//         the two rows' values into one bf16x2 as they load made the
//         thread wait for the loads at once, and serve_bulk slower,
//         though it removed the 12 bytes that N = 200 spills).  wgmma
//         reads A registers asynchronously,
//         so h and h + 1 use two register sets, and a set is rewritten
//         only after wgmma.wait_group(1) has retired the products that
//         read it, on every path through the loop (an odd tail inside the
//         loop made ptxas serialise every wgmma, C7513);
//       - W as an MN-major B, streamed: the producer TMA-loads W's m rows
//         of the next h (a box of 16 kSteps rows, rows j >= m filled with
//         zeros by the map's bounds on the (Hk, m, O) view, in bands of 64
//         columns) into a 4-stage ring of full/empty mbarriers.  Every
//         block reads the same W, so it stays in L2;
//       - one wgmma m64nNk16 covers all of N (N = 200 for O = 200: the
//         column count only has to be a multiple of 8), so each A fragment
//         is scaled once per h.  N is instantiated for 16, 32, 64, 128 and
//         200 (O rounded up to the next of them); a wider O runs in column
//         tiles of 128, columns past O masked at the store.  (At N = 256
//         the accumulator and both A sets spilled and ptxas serialised the
//         wgmma pipeline, C7512);
//       - two consumers, not three: every block reads all of W from L2,
//         so more rows a block would cut that traffic, but ptxas
//         allocates registers against the launch bound (65536 / 512 = 128
//         a thread at three consumers, whatever setmaxnreg later grants),
//         and m64n200's 100 accumulators do not fit (C7602);
//       - split K for small B: when the 128-row tiles would not fill the
//         SMs, the grid splits h across blocks; each block writes float32
//         partials and a second pass sums them in a fixed order and
//         rounds to bfloat16 (no atomics: deterministic);
//   * float32 runs FMAs on the CUDA cores (TF32 would round the inputs to
//     10 bits): A's K-tiles built in shared memory from the staged x0 and
//     xk, W's tiles beside them, 4 x 4 outputs a thread;
//   * ragged edges are masked, not padded in memory: rows past B D (B
//     needs not be a multiple of the tile), j past m and columns past O.
//     W itself is read through TMA, which needs rows of a multiple of 16
//     bytes: for O not a multiple of 8 the wrapper hands the kernel a
//     zero-padded copy (its plan's `pad_w`; not the served shape).
//
// No cuBLAS, no library GEMM.
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after its launches, or hop::kEncodeError + the
// CUresult when W's tensor map cannot be encoded.

#include "../../csrc/hopper.cuh"

namespace {

using hop::bf16;

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
namespace wg {

using hop::bf16;

constexpr int kConsumers = 2;                  // warpgroups of 64 rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBlockRows = 64 * kConsumers;
constexpr int kStages = 4;                     // the W ring
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
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

// Block (x, y, z): rows 128 x .. 128 x + 127, columns N y .., h in
// [z h_per_split, min(hk, (z + 1) h_per_split)).  y (partial == nullptr)
// or partial[z] (float32, y's layout) is written.  The W ring's stage
// holds N / kBand boxes of (16 kSteps rows, kBand columns); a box row is
// kRowBytes, which is also the swizzle.
template <int N, int kSteps>
__global__ void __launch_bounds__(kThreads, 1)
cin_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                 const bf16* __restrict__ xk, const bf16* __restrict__ x0,
                 bf16* __restrict__ y, float* __restrict__ partial,
                 int64_t n_rows, int hk, int m, int d, int n_out,
                 int h_per_split) {
  constexpr int kBand = N < 64 ? N : 64;
  constexpr int kRowBytes = 2 * kBand;
  constexpr int kBoxes = (N + kBand - 1) / kBand;
  constexpr int kBoxBytes = 16 * kSteps * kRowBytes;
  constexpr int kStageBytes = kBoxes * kBoxBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hop::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kBlockRows;
  const int n0 = blockIdx.y * N;
  const int h_lo = blockIdx.z * h_per_split;
  const int n_h = min(hk, h_lo + h_per_split) - h_lo;
  const int wg_id = threadIdx.x / 128;

  if (threadIdx.x == 0) {
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
      for (int i = 0; i < n_h; ++i) {
        const int s = i % kStages;
        hop::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        hop::mbar_expect_tx(&full[s], kStageBytes);
        for (int c = 0; c < kBoxes; ++c)
          hop::tma_load_3d(ring + s * kStageBytes + c * kBoxBytes, &w_map,
                           &full[s], n0 + c * kBand, 0, h_lo + i);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    hop::reg_alloc<kConsumerRegs>();
    const int lane = threadIdx.x % 32;
    const int gr = lane / 4;
    const int tq = lane % 4;
    const int64_t row_a =
        r0 + (wg_id - 1) * 64 + (threadIdx.x / 32) % 4 * 16 + gr;
    const int64_t row_b = row_a + 8;

    // this warp's x0 rows as A fragments, j = 16 s + 2 tq (+1, +8, +9)
    uint32_t x0f[kSteps][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int j = 16 * s + 2 * tq;
      x0f[s][0] = x0_pair(x0, row_a, j, n_rows, m, d);
      x0f[s][1] = x0_pair(x0, row_b, j, n_rows, m, d);
      x0f[s][2] = x0_pair(x0, row_a, j + 8, n_rows, m, d);
      x0f[s][3] = x0_pair(x0, row_b, j + 8, n_rows, m, d);
    }
    // xk[b, h, d] of the two rows is xk_*[h d]; rows past n_rows read 0
    const int64_t hd = static_cast<int64_t>(hk) * d;
    const bf16* xk_a = row_a < n_rows
                           ? xk + row_a / d * hd + row_a % d : nullptr;
    const bf16* xk_b = row_b < n_rows
                           ? xk + row_b / d * hd + row_b % d : nullptr;
    const bf16 zero = __float2bfloat16_rn(0.0f);
    auto load_xk = [&](int h, bf16 (&v)[2]) {
      const int64_t off = static_cast<int64_t>(h) * d;
      v[0] = xk_a ? xk_a[off] : zero;
      v[1] = xk_b ? xk_b[off] : zero;
    };
    bf16 xv[2][2];              // xk of h (even / odd), read two h ahead
    load_xk(h_lo, xv[0]);
    if (n_h > 1) load_xk(h_lo + 1, xv[1]);

    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
    uint32_t a[2][kSteps][4];   // the scaled fragments of h (even / odd)

    // one h: scale, read xk two ahead, wait for W, issue its products,
    // then retire the previous h's and release its stage
    auto step = [&](int i, uint32_t (&as)[kSteps][4], bf16 (&xs)[2],
                    uint32_t (&prev)[kSteps][4]) {
      const __nv_bfloat162 sa = __bfloat162bfloat162(xs[0]);
      const __nv_bfloat162 sb = __bfloat162bfloat162(xs[1]);
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        as[s][0] = as_u32(__hmul2(as_bf2(x0f[s][0]), sa));
        as[s][1] = as_u32(__hmul2(as_bf2(x0f[s][1]), sb));
        as[s][2] = as_u32(__hmul2(as_bf2(x0f[s][2]), sa));
        as[s][3] = as_u32(__hmul2(as_bf2(x0f[s][3]), sb));
      }
      if (i + 2 < n_h) load_xk(h_lo + i + 2, xs);
      const int st = i % kStages;
      const uint8_t* tile = ring + st * kStageBytes;
      hop::mbar_wait(&full[st], (i / kStages) & 1);
      // the scaled fragments are computed here, not sunk past the fence
#pragma unroll
      for (int s = 0; s < kSteps; ++s) hop::fence_regs(as[s]);
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        hop::Wgmma<N>::template rs<1>(
            acc, as[s], hop::desc_mn_major(tile, s, kRowBytes, kBoxBytes), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
#pragma unroll
      for (int s = 0; s < kSteps; ++s) hop::fence_regs(prev[s]);
      if (i > 0 && lane == 0) hop::mbar_arrive(&empty[(i - 1) % kStages]);
    };
    // pairs, then the odd h: on every path a set is rewritten only after
    // the wait that retires the products reading it
    int i = 0;
    for (; i + 1 < n_h; i += 2) {
      step(i, a[0], xv[0], a[1]);
      step(i + 1, a[1], xv[1], a[0]);
    }
    if (i < n_h) step(i, a[0], xv[0], a[1]);
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);

    // y[b, col, d] (or the split's float32 partial) for row = b D + d
    const int64_t plane = n_rows * n_out;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = half ? row_b : row_a;
      if (row >= n_rows) continue;
      const int64_t base = row / d * n_out * d + row % d;
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * i + 2 * tq + e;
          if (col >= n_out) continue;
          const float v = acc[4 * i + 2 * half + e];
          if (partial)
            partial[blockIdx.z * plane + base + static_cast<int64_t>(col) * d] = v;
          else
            y[base + static_cast<int64_t>(col) * d] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

// y = the float32 partials of the splits summed in split order, rounded
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
cin_split_sum_kernel(const float* __restrict__ partial, bf16* __restrict__ y,
                     int64_t plane, int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kReduceThreads) +
                   threadIdx.x;
       i < plane; i += static_cast<int64_t>(gridDim.x) * kReduceThreads) {
    float v = 0.0f;
    for (int s = 0; s < splits; ++s) v += partial[s * plane + i];
    y[i] = __float2bfloat16_rn(v);
  }
}

// The launch plan (kernels/cin_fuse/kernel.py `CinPlan.args`): grid (3),
// threads, shared bytes, N, kSteps, h a split, stages, B, Hk, m, D, O,
// then W's map (hop::kMapSpecLen values).
constexpr int kPlanHead = 14;
constexpr int kPlanLen = kPlanHead + hop::kMapSpecLen;

template <int N, int kSteps>
constexpr int smem_bytes() {
  constexpr int band = N < 64 ? N : 64;
  return 1024 + kStages * ((N + band - 1) / band) * 16 * kSteps * 2 * band +
         16 * kStages;
}

template <int N, int kSteps>
int launch(const void* xk, const void* x0, const void* w, void* y,
           void* partial, const int64_t* plan, void* stream) {
  constexpr int band = N < 64 ? N : 64;
  constexpr int smem = smem_bytes<N, kSteps>();
  const int64_t* w_spec = plan + kPlanHead;
  const int64_t batch = plan[9], hk = plan[10], m = plan[11], d = plan[12];
  const int64_t n_out = plan[13];
  const int64_t n_rows = batch * d;
  const int64_t splits = plan[2], h_split = plan[7];
  if (plan[3] != kThreads || plan[4] != smem || plan[5] != N ||
      plan[8] != kStages ||
      plan[0] != (n_rows + kBlockRows - 1) / kBlockRows ||
      plan[1] != (n_out + N - 1) / N || h_split < 1 ||
      (splits - 1) * h_split >= hk || splits * h_split < hk ||
      (splits > 1) != (partial != nullptr) || w_spec[0] != 3 ||
      w_spec[8] != band || w_spec[9] != 16 * kSteps || w_spec[10] != 1 ||
      w_spec[12] != 2 * band || w_spec[2] != m || w_spec[3] != hk)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap w_map;
  const int err = hop::encode_map(&w_map, w, w_spec);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      cin_wgmma_kernel<N, kSteps>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(plan[0]),
                  static_cast<unsigned>(plan[1]),
                  static_cast<unsigned>(splits));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cin_wgmma_kernel<N, kSteps><<<grid, kThreads, smem, s>>>(
      w_map, static_cast<const bf16*>(xk), static_cast<const bf16*>(x0),
      static_cast<bf16*>(y), static_cast<float*>(partial), n_rows,
      static_cast<int>(hk), static_cast<int>(m), static_cast<int>(d),
      static_cast<int>(n_out), static_cast<int>(h_split));
  if (splits > 1) {
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
    const int64_t plane = n_rows * n_out;
    const int64_t blocks = (plane + kReduceThreads - 1) / kReduceThreads;
    cin_split_sum_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                           kReduceThreads, 0, s>>>(
        static_cast<const float*>(partial), static_cast<bf16*>(y), plane,
        static_cast<int>(splits));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_n(const void* xk, const void* x0, const void* w, void* y,
             void* partial, const int64_t* plan, void* stream) {
  switch (plan[6]) {
    case 1: return launch<N, 1>(xk, x0, w, y, partial, plan, stream);
    case 2: return launch<N, 2>(xk, x0, w, y, partial, plan, stream);
    case 3: return launch<N, 3>(xk, x0, w, y, partial, plan, stream);
    case 4: return launch<N, 4>(xk, x0, w, y, partial, plan, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace wg

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

// bfloat16, the same layouts; w may be a copy whose rows are padded to the
// plan's O (a multiple of 8).  partial: (splits, batch, n_out, d) float32
// when the plan splits K, else null.  plan: wg::kPlanLen int64 (host
// memory), as `CinPlan.args` lays it out.
extern "C" int cin_layer_bf16(const void* xk, const void* x0, const void* w,
                              void* y, void* partial, const int64_t* plan,
                              int64_t plan_len, void* stream) {
  if (plan_len != wg::kPlanLen) return static_cast<int>(cudaErrorInvalidValue);
  if (plan[9] * plan[12] == 0 || plan[13] == 0) return 0;
  switch (plan[5]) {
    case 16: return wg::launch_n<16>(xk, x0, w, y, partial, plan, stream);
    case 32: return wg::launch_n<32>(xk, x0, w, y, partial, plan, stream);
    case 64: return wg::launch_n<64>(xk, x0, w, y, partial, plan, stream);
    case 128: return wg::launch_n<128>(xk, x0, w, y, partial, plan, stream);
    case 200: return wg::launch_n<200>(xk, x0, w, y, partial, plan, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
