// EmbeddingBag (multi-hot gather + masked mean), for Hopper (sm_90a).
// Replaces the Pallas TPU kernel `embedding_bag_pallas`
// (src/repro/kernels/embedding_bag/kernel.py, body `_bag_kernel`).
//
// Computes, for a table (R, D), ids (BF, M) and a mask (BF, M):
//
//   out[i, :] = sum_{j : mask[i, j]} table[ids[i, j], :] / max(count_i, 1)
//
// with the sum in float32 and one rounding to the table's type at the end,
// as the Pallas kernel does.  The TPU kernel takes per-bag counts and sums
// the first count_i ids; this one takes the mask itself, so it computes
// that function for the data pipeline's prefix masks and the model op's
// (`repro.models.recsys.embedding_bag`) for any mask.  A masked entry's id
// is never read, and its row never gathered.  A valid id outside [0, R)
// makes its bag NaN (jnp.take's fill), never an out-of-bounds read.
//
// What bounds it: memory.  A bag reads its M mask bytes, the ids of its
// valid entries and their rows, and writes D values: at xDeepFM's D = 10
// in bfloat16 a row is 20 bytes, 4-byte aligned only.  The design:
//
//   * one lane per output element: the D lanes of a bag walk its M
//     entries together (mask and id loads are broadcasts within the lane
//     group) and each gathers its own element of every valid row, so a
//     row is read by neighbouring lanes in one or two 32-byte sectors and
//     no load is wider than an element (no alignment demand on D);
//   * consecutive bags in consecutive lane groups, so the output is
//     written once, fully coalesced;
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const I* __restrict__ ids,
                     const uint8_t* __restrict__ mask, T* __restrict__ out,
                     int64_t n_bags, int bag, int dim, int64_t rows) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_bags * dim) return;
  const int64_t b = i / dim;
  const int d = static_cast<int>(i - b * dim);
  const uint8_t* mk = mask + b * bag;
  const I* id = ids + b * bag;
  float acc = 0.0f;
  int count = 0;
  for (int j = 0; j < bag; ++j) {
    if (mk[j]) {
      const int64_t row = static_cast<int64_t>(id[j]);
      ++count;
      acc += (row >= 0 && row < rows) ? to_float(table[row * dim + d]) : NAN;
    }
  }
  out[i] = from_float<T>(acc / static_cast<float>(count > 0 ? count : 1));
}

template <typename T, typename I>
int launch_typed(const void* table, const void* ids, const void* mask,
                 void* out, int64_t n_bags, int64_t bag, int64_t dim,
                 int64_t rows, void* stream) {
  const int64_t n = n_bags * dim;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  embedding_bag_kernel<T, I><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const I*>(ids),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), n_bags,
      static_cast<int>(bag), static_cast<int>(dim), rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* table, const void* ids, const void* mask, void* out,
           int64_t n_bags, int64_t bag, int64_t dim, int64_t rows,
           int64_t id_bytes, void* stream) {
  if (n_bags * dim == 0) return 0;
  if (id_bytes == 4)
    return launch_typed<T, int32_t>(table, ids, mask, out, n_bags, bag, dim,
                                    rows, stream);
  if (id_bytes == 8)
    return launch_typed<T, int64_t>(table, ids, mask, out, n_bags, bag, dim,
                                    rows, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// table (rows, dim) contiguous; ids (n_bags, bag) int32 or int64
// (id_bytes 4 or 8) and mask (n_bags, bag) one byte each, contiguous;
// out (n_bags, dim) contiguous, in the table's type.
extern "C" int embedding_bag_f32(const void* table, const void* ids,
                                 const void* mask, void* out, int64_t n_bags,
                                 int64_t bag, int64_t dim, int64_t rows,
                                 int64_t id_bytes, void* stream) {
  return launch<float>(table, ids, mask, out, n_bags, bag, dim, rows,
                       id_bytes, stream);
}

extern "C" int embedding_bag_bf16(const void* table, const void* ids,
                                  const void* mask, void* out,
                                  int64_t n_bags, int64_t bag, int64_t dim,
                                  int64_t rows, int64_t id_bytes,
                                  void* stream) {
  return launch<__nv_bfloat16>(table, ids, mask, out, n_bags, bag, dim, rows,
                               id_bytes, stream);
}
