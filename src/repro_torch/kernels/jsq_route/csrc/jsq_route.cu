// Join-shortest-queue routing of one chunk of queries, for Hopper (sm_90a).
// Replaces no Pallas kernel: the reference runs this recurrence as a
// `lax.scan` (`_jsq_route`, src/repro/core/simulator.py:541), which in
// plain PyTorch is ~8 small launches per query, 4096 queries per chunk.
//
// State: the fluid backlog tracker w (r, p) per scenario, each replica
// server's remaining seconds of work at the previous arrival.  Per query i:
//
//   w      = max(w - gap_i, 0)
//   choice = argmin_k max_j w[k][j]          (first index on ties)
//   w[choice][j] += live_i * services[j][i]
//
// What bounds it: the serial chain of n dependent steps, not bytes.  The
// bytes (services (S, p, n) read once, the rest small) take ~0.03 ms at
// full width; each step is a drain, r warp reductions and an argmin.  The
// design keeps the chain short:
//
//   * one block of one warp per scenario, so a step needs no barrier;
//   * r is a template parameter (1..kMaxR, dispatched at launch), so the
//     per-replica loops unroll with no branch, and the server loop has
//     the same trip count on every lane (a predicated body), so no step
//     diverges;
//   * the (r, p) tracker lives in shared memory, lane l owning servers
//     j = l, l + 32, ...; per server the r replicas' loads are issued
//     together, the r per-replica maxima reduce together (5 butterfly
//     rounds of r independent shuffles), and every lane then holds the
//     argmin;
//   * services are staged kTile queries at a time into shared memory by
//     cp.async, double-buffered: the next tile's copies are in flight
//     while this tile's kTile steps run, so no step waits on device
//     memory.  Tiles are padded to kTile + 1 columns so a step's reads of
//     one column hit distinct banks.  Gaps and live ride in registers
//     (the next tile's prefetched likewise) and are broadcast by shuffle.
//
// The deposit is rounded as the plain version rounds it (a product, then
// a sum; no fused multiply-add), so kernel and loop choose alike.
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after the launch.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kStride = kTile + 1;
constexpr int kMaxR = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul_rn(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ double mul_rn(double x, double y) {
  return __dmul_rn(x, y);
}
__device__ __forceinline__ float add_rn(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ double add_rn(double x, double y) {
  return __dadd_rn(x, y);
}

// Queue this lane's copies of one services tile (cols queries from
// column `base`) into `buf`, as one cp.async group.
template <typename T>
__device__ __forceinline__ void stage(T* buf, const T* s_rows, int p,
                                      int64_t n, int64_t base, int lane) {
  if (base < n && lane < n - base) {
    for (int j = 0; j < p; ++j) {
      __pipeline_memcpy_async(&buf[j * kStride + lane],
                              &s_rows[j * n + base + lane], sizeof(T));
    }
  }
  __pipeline_commit();
}

template <typename T, int R>
__global__ void __launch_bounds__(32)
jsq_route_kernel(const T* __restrict__ w_in, const T* __restrict__ gaps,
                 const T* __restrict__ services, const T* __restrict__ live,
                 int64_t* __restrict__ choice, T* __restrict__ w_out, int p,
                 int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* w = reinterpret_cast<T*>(smem);  // (R, p)
  T* svc = w + R * p;                 // 2 x (p, kStride)

  const int64_t s = blockIdx.x;
  const int lane = threadIdx.x;
  const int rp = R * p;
  const int buf_len = p * kStride;
  const int per_lane = (p + 31) / 32;  // the same on every lane
  const T* g_row = gaps + s * n;
  const T* l_row = live + s * n;
  const T* s_rows = services + s * static_cast<int64_t>(p) * n;
  int64_t* c_row = choice + s * n;

  for (int i = lane; i < rp; i += 32) w[i] = w_in[s * rp + i];
  stage(svc, s_rows, p, n, 0, lane);
  T next_gap = lane < n ? g_row[lane] : T(0);
  T next_live = lane < n ? l_row[lane] : T(0);

  for (int64_t base = 0, it = 0; base < n; base += kTile, ++it) {
    const int cols = static_cast<int>(n - base < kTile ? n - base : kTile);
    const T* cur = svc + (it & 1) * buf_len;
    const T my_gap = next_gap;
    const T my_live = next_live;
    // the next tile: copies in flight while this one runs
    stage(svc + ((it + 1) & 1) * buf_len, s_rows, p, n, base + kTile, lane);
    const int64_t ahead = base + kTile + lane;
    next_gap = ahead < n ? g_row[ahead] : T(0);
    next_live = ahead < n ? l_row[ahead] : T(0);
    __pipeline_wait_prior(1);  // this tile's group has landed
    __syncwarp();

    for (int t = 0; t < cols; ++t) {
      const T gap = __shfl_sync(kFull, my_gap, t);
      const T lv = __shfl_sync(kFull, my_live, t);

      // drain; each lane's partial max of every replica
      T m[R];
#pragma unroll
      for (int k = 0; k < R; ++k) m[k] = T(0);
      for (int q = 0; q < per_lane; ++q) {
        const int j = q * 32 + lane;
        if (j < p) {
          T v[R];
#pragma unroll
          for (int k = 0; k < R; ++k) v[k] = w[k * p + j];
#pragma unroll
          for (int k = 0; k < R; ++k) {
            v[k] = v[k] - gap;
            v[k] = v[k] > T(0) ? v[k] : T(0);
            w[k * p + j] = v[k];
            m[k] = m[k] > v[k] ? m[k] : v[k];
          }
        }
      }
      // the R maxima over p, reduced together
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const T o = __shfl_xor_sync(kFull, m[k], off);
          m[k] = m[k] > o ? m[k] : o;
        }
      }
      // argmin over replicas, first index on ties
      int best = 0;
      T best_m = m[0];
#pragma unroll
      for (int k = 1; k < R; ++k) {
        if (m[k] < best_m) {
          best = k;
          best_m = m[k];
        }
      }
      if (lane == 0) c_row[base + t] = best;
      T* wb = w + best * p;
#pragma unroll 4
      for (int q = 0; q < per_lane; ++q) {
        const int j = q * 32 + lane;
        if (j < p) wb[j] = add_rn(wb[j], mul_rn(lv, cur[j * kStride + t]));
      }
    }
    __syncwarp();  // every lane is done with `cur` before it is restaged
  }
  __pipeline_wait_prior(0);
  for (int i = lane; i < rp; i += 32) w_out[s * rp + i] = w[i];
}

template <typename T, int R>
int launch_r(const void* w_in, const void* gaps, const void* services,
             const void* live, void* choice, void* w_out, int64_t scenarios,
             int64_t p, int64_t n, void* stream) {
  const size_t smem =
      static_cast<size_t>(R * p + 2 * p * kStride) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        jsq_route_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  jsq_route_kernel<T, R><<<dim3(static_cast<unsigned>(scenarios)), 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w_in), static_cast<const T*>(gaps),
      static_cast<const T*>(services), static_cast<const T*>(live),
      static_cast<int64_t*>(choice), static_cast<T*>(w_out),
      static_cast<int>(p), n);
  return static_cast<int>(cudaGetLastError());
}

// r -> the kernel instantiated for it
template <typename T, int R = 1>
int launch(const void* w_in, const void* gaps, const void* services,
           const void* live, void* choice, void* w_out, int64_t scenarios,
           int64_t r, int64_t p, int64_t n, void* stream) {
  if constexpr (R > kMaxR) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (r == R) {
      return launch_r<T, R>(w_in, gaps, services, live, choice, w_out,
                            scenarios, p, n, stream);
    }
    return launch<T, R + 1>(w_in, gaps, services, live, choice, w_out,
                            scenarios, r, p, n, stream);
  }
}

}  // namespace

extern "C" int jsq_route_f32(const void* w_in, const void* gaps,
                             const void* services, const void* live,
                             void* choice, void* w_out, int64_t scenarios,
                             int64_t r, int64_t p, int64_t n, void* stream) {
  return launch<float>(w_in, gaps, services, live, choice, w_out, scenarios,
                       r, p, n, stream);
}

extern "C" int jsq_route_f64(const void* w_in, const void* gaps,
                             const void* services, const void* live,
                             void* choice, void* w_out, int64_t scenarios,
                             int64_t r, int64_t p, int64_t n, void* stream) {
  return launch<double>(w_in, gaps, services, live, choice, w_out,
                        scenarios, r, p, n, stream);
}
