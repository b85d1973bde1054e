// One-tile check of hopper.cuh on the card: C (64 x N, float32) = A B for
// A (64 x K) and B in bfloat16, through the same TMA loads, descriptors
// and wgmma products the kernels use.  A comes through TMA into shared
// memory (K-major, the "ss" product) or from device memory straight into
// A-fragment registers (the "rs" product); B through TMA either K-major
// (stored N x K) or MN-major (stored K x N).  A descriptor, swizzle or
// fragment-layout bug then fails this check (tests/test_torch_gpu.py,
// chip_smoke.py phases 8 and 14) before it reaches a kernel.
//
// Plain C interface (bound with ctypes by kernels/hopper.py): the entry
// point returns cudaGetLastError() after its launch, or
// hop::kEncodeError + the CUresult when a tensor map cannot be encoded.

#include "hopper.cuh"

namespace {

using hop::bf16;

constexpr int kThreads = 128;   // one warpgroup

template <int N>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const __grid_constant__ CUtensorMap a_map,
            const __grid_constant__ CUtensorMap b_map,
            const bf16* __restrict__ a, float* __restrict__ c, int k,
            int b_mn_major, int a_in_regs, int a_row_bytes, int a_box_bytes,
            int a_region, int b_row_bytes, int b_box_bytes, int b_boxes,
            uint32_t tx_bytes) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = hop::align1024(smem_raw);
  uint8_t* b_s = a_s + a_region;
  uint64_t* bar = reinterpret_cast<uint64_t*>(b_s + b_boxes * b_box_bytes);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  if (tid == 0) {
    hop::mbar_init(bar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hop::mbar_expect_tx(bar, tx_bytes);
    const int a_chunk = a_row_bytes / 2;
    if (!a_in_regs)
      for (int i = 0; i * a_chunk < k; ++i)
        hop::tma_load_2d(a_s + i * a_box_bytes, &a_map, bar, i * a_chunk, 0);
    const int b_chunk = b_row_bytes / 2;
    for (int i = 0; i < b_boxes; ++i)
      hop::tma_load_2d(b_s + i * b_box_bytes, &b_map, bar, i * b_chunk, 0);
  }
  hop::mbar_wait(bar, 0);

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  uint32_t frag[8][4];
  if (a_in_regs) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int r = warp * 16 + g, col = s * 16 + 2 * t;
      if (s * 16 < k) {
        frag[s][0] = *reinterpret_cast<const uint32_t*>(a + r * k + col);
        frag[s][1] = *reinterpret_cast<const uint32_t*>(a + (r + 8) * k + col);
        frag[s][2] = *reinterpret_cast<const uint32_t*>(a + r * k + col + 8);
        frag[s][3] =
            *reinterpret_cast<const uint32_t*>(a + (r + 8) * k + col + 8);
      }
    }
  }
  hop::wgmma_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (s * 16 >= k) break;
    const uint64_t db =
        b_mn_major ? hop::desc_mn_major(b_s, s, b_row_bytes, b_box_bytes)
                   : hop::desc_k_major(b_s, s, b_row_bytes, b_box_bytes);
    if (a_in_regs) {
      if (b_mn_major)
        hop::Wgmma<N>::template rs<1>(acc, frag[s], db, 1);
      else
        hop::Wgmma<N>::template rs<0>(acc, frag[s], db, 1);
    } else {
      const uint64_t da = hop::desc_k_major(a_s, s, a_row_bytes, a_box_bytes);
      if (b_mn_major)
        hop::Wgmma<N>::template ss<1>(acc, da, db, 1);
      else
        hop::Wgmma<N>::template ss<0>(acc, da, db, 1);
    }
  }
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);
  if (a_in_regs) hop::fence_regs(frag[0]);

#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int r = warp * 16 + g, col = 8 * i + 2 * t;
    c[r * N + col] = acc[4 * i];
    c[r * N + col + 1] = acc[4 * i + 1];
    c[(r + 8) * N + col] = acc[4 * i + 2];
    c[(r + 8) * N + col + 1] = acc[4 * i + 3];
  }
}

template <int N>
int launch(const void* a, const void* b, void* c, const int64_t* a_spec,
           const int64_t* b_spec, int64_t k, int64_t b_mn_major,
           int64_t a_in_regs, void* stream) {
  CUtensorMap a_map, b_map;
  int err = hop::encode_map(&a_map, a, a_spec);
  if (err == 0) err = hop::encode_map(&b_map, b, b_spec);
  if (err != 0) return err;
  // a box is (inner, rows): inner * 2 bytes a row
  const int a_row_bytes = static_cast<int>(a_spec[8]) * 2;
  const int a_box_bytes = static_cast<int>(hop::box_bytes(a_spec));
  const int a_boxes = static_cast<int>(k) * 2 / a_row_bytes;
  const int a_region = (a_boxes * a_box_bytes + 1023) / 1024 * 1024;
  const int b_row_bytes = static_cast<int>(b_spec[8]) * 2;
  const int b_box_bytes = static_cast<int>(hop::box_bytes(b_spec));
  const int b_inner = static_cast<int>(b_mn_major ? N : k);
  const int b_boxes = (b_inner * 2 + b_row_bytes - 1) / b_row_bytes;
  const uint32_t tx = static_cast<uint32_t>(
      (a_in_regs ? 0 : a_boxes * a_box_bytes) + b_boxes * b_box_bytes);
  const size_t smem = 1024 + a_region + b_boxes * b_box_bytes + 16;
  cudaError_t e = cudaFuncSetAttribute(
      tile_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  tile_kernel<N><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a_map, b_map, static_cast<const bf16*>(a), static_cast<float*>(c),
      static_cast<int>(k), static_cast<int>(b_mn_major),
      static_cast<int>(a_in_regs), a_row_bytes, a_box_bytes, a_region,
      b_row_bytes, b_box_bytes, b_boxes, tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (64, k) and, K-major, b (n, k) or, MN-major, b (k, n): row-major bf16;
// c (64, n) float32.  a_spec / b_spec: the 2-d maps (hop::kMapSpecLen
// values each) of kernels/hopper.py `tile_plan`.  k in 16, 32, 64, 128.
extern "C" int hopper_tile_bf16(const void* a, const void* b, void* c,
                                const int64_t* a_spec, const int64_t* b_spec,
                                int64_t n, int64_t k, int64_t b_mn_major,
                                int64_t a_in_regs, void* stream) {
  if (k % 16 != 0 || k < 16 || k > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
#define REPRO_TILE_CASE(N)                                                   \
  case N:                                                                    \
    return launch<N>(a, b, c, a_spec, b_spec, k, b_mn_major, a_in_regs,      \
                     stream);
    REPRO_TILE_CASE(16)
    REPRO_TILE_CASE(32)
    REPRO_TILE_CASE(64)
    REPRO_TILE_CASE(128)
    REPRO_TILE_CASE(200)
#undef REPRO_TILE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
