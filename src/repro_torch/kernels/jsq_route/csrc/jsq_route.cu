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
// What bounds it: the serial chain of n dependent steps, not bytes (the
// bytes take ~0.03 ms at full width).  The design shortens the step:
//
//   * one carried maximum per replica.  Rounding is monotone, so
//     max_j max(fl(w_kj - g), 0) = max(fl(M_k - g), 0) bit for bit, where
//     M_k = max_j w_kj.  Every lane drains the r scalars M_k with no
//     communication and takes the argmin over them; the deposit changes
//     only the chosen replica, so the step needs one cross-lane max (its
//     new M) instead of r.  Each lane's maxima of every replica after a
//     deposit (L_k) are computed before the choice is known, off the
//     chain, so the chain is: drain M, argmin, select L_best, one warp
//     max;
//   * the tracker in registers (`jsq_reg_kernel`): a warp holds one
//     scenario, lane l the servers j = l, l + 32, ... of every replica
//     (PER of them, a template bucket, as is KC >= r); replicas past r
//     carry M = +inf, so they are never chosen.  Where KC x PER passes
//     the register budget (float64 doubles it), `jsq_smem_kernel` runs
//     the same algorithm with the tracker in shared memory.  32 lanes a
//     scenario beat 16 and 8 on the card (PERF.md): fewer lanes hold
//     more servers each, and the step's instructions, not the chain's
//     latency alone, decide;
//   * the warp max is `redux.sync` (signed) on a float32's bits with the
//     magnitude bits of a negative value flipped, which orders them as
//     the floats (two integer instructions each way); float64 takes five
//     xor shuffles;
//   * the step is short in instructions: a server past p deposits -inf,
//     so each replica's local max is a tree of maxima with no predicate;
//     the argmin and the select of L_best are trees; the choices wait in
//     shared memory, stored to device memory once a tile; the
//     step loop is unrolled by two;
//   * services, gaps and live are staged `tile` queries at a time into
//     shared memory by cp.async, double-buffered: the next tile's copies
//     are in flight while this tile's steps run, so no step waits on
//     device memory.  Tiles are padded to tile + 1 columns so a step's
//     reads of one column hit distinct banks.
//
// The deposit is rounded as the plain version rounds it (a product, then
// a sum; no fused multiply-add), so kernel and loop choose alike.
//
// Masks (the `MASKED` instances; the unmasked ones are the code above,
// unchanged): per query, the autoscaler's active count n_act and the
// fault injector's up mask (one int32 of bits a query, bit k replica k)
// take replicas out of the argmin by setting their drained maximum to
// +inf there; the trackers keep draining.  The argmin over the active
// replicas alone is the fault-free choice: a query with no active
// replica up takes it (`unavail`), and one whose fault-free choice is
// down and moves is a `spill`.  Both masks are staged with the tile, off
// the chain.
//
// Past 16 replicas (`jsq_wide_kernel`, r <= 256): a lane can no longer
// carry every replica's maximum.  Lane l carries those of replicas l,
// l + 32, ... (RPL = ceil(r / 32) of them), drains them, takes a
// lane-local argmin and then a 5-step xor-shuffle argmin over (value,
// index), first index on ties; the tracker (r, p) lies in shared memory,
// lane l the servers l, l + 32, ... of every replica.  Only the chosen
// replica's maximum after the deposit is computed (one warp max), and the
// drain of the tracker skips the replicas whose carried maximum is 0
// before the step (a ballot a group of 32): every server of such a
// replica is 0 already, and draining leaves it so; kDrain busy
// replicas' servers are loaded before any is stored back.  The up mask is
// ceil(r / 32) int32 words a query (word q, bit b: replica 32 q + b).
// The same products, sums and drains in the same order: the same bits.
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after the launch.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegBudget = 64;   // 32-bit registers a lane gives the tracker

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

template <typename T>
__device__ __forceinline__ T max0(T x) {
  return x > T(0) ? x : T(0);
}

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return a > b ? a : b;
}

// A float32's bits as a signed key in the floats' order (and back: the
// map is its own inverse): a negative value's magnitude bits flipped
__device__ __forceinline__ int order_key(int b) {
  return b ^ ((b >> 31) & 0x7fffffff);
}

// The max over the warp, which must be converged (see jsq_smem_kernel).
// float32: one redux.sync over the order keys; float64: xor shuffles.
__device__ __forceinline__ float warp_max(float x) {
  return __int_as_float(
      order_key(__reduce_max_sync(kFull, order_key(__float_as_int(x)))));
}

__device__ __forceinline__ double warp_max(double x) {
  for (int off = 16; off > 0; off >>= 1)
    x = tmax(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// Queue the warp's copies of a tile (up to `tile` queries from column
// `base`): services rows 0..p-1, then the gaps and live rows, each row
// `tile + 1` wide; one cp.async group.
template <typename T>
__device__ __forceinline__ void stage(T* buf, const T* s_rows, const T* g_row,
                                      const T* l_row, int p, int64_t n,
                                      int64_t base, int tile, int lane) {
  const int stride = tile + 1;
  const int64_t left = n - base;
  const int cols = left < tile ? static_cast<int>(left) : tile;
  for (int c = lane; c < cols; c += 32) {
    for (int j = 0; j < p; ++j)
      __pipeline_memcpy_async(&buf[j * stride + c], &s_rows[j * n + base + c],
                              sizeof(T));
    __pipeline_memcpy_async(&buf[p * stride + c], &g_row[base + c],
                            sizeof(T));
    __pipeline_memcpy_async(&buf[(p + 1) * stride + c], &l_row[base + c],
                            sizeof(T));
  }
  __pipeline_commit();
}

// Queue the copies of a tile's masks (active counts, then up bits, each
// row `tile` wide) into the group that `stage` commits next.
__device__ __forceinline__ void stage_masks(int* buf, const int* a_row,
                                            const int* b_row, int64_t n,
                                            int64_t base, int tile,
                                            int lane) {
  const int64_t left = n - base;
  const int cols = left < tile ? static_cast<int>(left) : tile;
  for (int c = lane; c < cols; c += 32) {
    __pipeline_memcpy_async(&buf[c], &a_row[base + c], sizeof(int));
    __pipeline_memcpy_async(&buf[tile + c], &b_row[base + c], sizeof(int));
  }
}

// The argmin over KC (a power of two) carried maxima, first index on
// ties: a tree whose right branch wins only when strictly less
template <typename T, int KC>
__device__ __forceinline__ int argmin_first(const T (&d)[KC]) {
  T v[KC];
  int idx[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    v[k] = d[k];
    idx[k] = k;
  }
#pragma unroll
  for (int half = KC / 2; half >= 1; half /= 2) {
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const bool right = v[2 * k + 1] < v[2 * k];
      idx[k] = right ? idx[2 * k + 1] : idx[2 * k];
      v[k] = right ? v[2 * k + 1] : v[2 * k];
    }
  }
  return idx[0];
}

// The masked choice of one query from the drained maxima d: the argmin
// over the active replicas that are up, else (none is) over the active
// replicas.  Returns the choice | spill << 8 | unavail << 9.
template <typename T, int KC>
__device__ __forceinline__ int masked_choice(const T (&d)[KC], int act,
                                             int bits) {
  T da[KC], du[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const bool a = k < act;
    da[k] = a ? d[k] : T(INFINITY);
    du[k] = (a && ((bits >> k) & 1)) ? d[k] : T(INFINITY);
  }
  const int raw = argmin_first(da);
  const bool any_up = (bits & ((1 << act) - 1)) != 0;
  const int best = any_up ? argmin_first(du) : raw;
  const int spill = any_up && !((bits >> raw) & 1);
  return best | (spill << 8) | (static_cast<int>(!any_up) << 9);
}

// x[k] for a runtime k < KC (a power of two): a tree of selects on its bits
template <typename T, int KC>
__device__ __forceinline__ T select_at(const T (&x)[KC], int k) {
  T v[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) v[i] = x[i];
#pragma unroll
  for (int half = KC / 2, bit = 1; half >= 1; half /= 2, bit *= 2) {
#pragma unroll
    for (int i = 0; i < half; ++i)
      v[i] = (k & bit) ? v[2 * i + 1] : v[2 * i];
  }
  return v[0];
}

// The max of PER values, as a tree
template <typename T, int PER>
__device__ __forceinline__ T tree_max(const T (&x)[PER]) {
  T v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = x[i];
#pragma unroll
  for (int half = PER / 2; half >= 1; half /= 2) {
#pragma unroll
    for (int i = 0; i < half; ++i) v[i] = tmax(v[2 * i], v[2 * i + 1]);
  }
  return v[0];
}

template <typename T, int KC, int PER, bool MASKED>
__global__ void __launch_bounds__(32)
jsq_reg_kernel(const T* __restrict__ w_in, const T* __restrict__ gaps,
               const T* __restrict__ services, const T* __restrict__ live,
               const int* __restrict__ n_act, const int* __restrict__ up_bits,
               int64_t* __restrict__ choice, T* __restrict__ w_out,
               bool* __restrict__ spill, bool* __restrict__ unavail, int r,
               int p, int64_t n, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int64_t s = blockIdx.x;
  const int stride = tile + 1;
  const int buf_len = (p + 2) * stride;
  T* bufs = reinterpret_cast<T*>(smem);
  // the tile's choices (and flags), stored once a tile; then the masks
  int* cbuf = reinterpret_cast<int*>(bufs + 2 * buf_len);
  int* mbufs = cbuf + tile;   // MASKED: 2 x (n_act, bits), tile each
  const T* g_row = gaps + s * n;
  const T* l_row = live + s * n;
  const T* s_rows = services + s * static_cast<int64_t>(p) * n;
  int64_t* c_row = choice + s * n;
  const int64_t rp = static_cast<int64_t>(r) * p;

  bool valid[PER];
  int off[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = lane + 32 * q;
    valid[q] = j < p;
    off[q] = (valid[q] ? j : 0) * stride;
  }
  T w[KC][PER];
  T m[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    T loc = -INFINITY;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      w[k][q] = (k < r && valid[q]) ? w_in[s * rp + k * p + lane + 32 * q]
                                    : T(0);
      if (valid[q]) loc = tmax(loc, w[k][q]);
    }
    m[k] = warp_max(loc);
    if (k >= r) m[k] = INFINITY;
  }

  if constexpr (MASKED)
    stage_masks(mbufs, n_act + s * n, up_bits + s * n, n, 0, tile, lane);
  stage(bufs, s_rows, g_row, l_row, p, n, 0, tile, lane);
  for (int64_t base = 0, it = 0; base < n; base += tile, ++it) {
    const int cols = static_cast<int>(n - base < tile ? n - base : tile);
    const T* cur = bufs + (it & 1) * buf_len;
    const int* mcur = mbufs + (it & 1) * 2 * tile;
    // the next tile: copies in flight while this one runs
    if constexpr (MASKED)
      stage_masks(mbufs + ((it + 1) & 1) * 2 * tile, n_act + s * n,
                  up_bits + s * n, n, base + tile, tile, lane);
    stage(bufs + ((it + 1) & 1) * buf_len, s_rows, g_row, l_row, p, n,
          base + tile, tile, lane);
    __pipeline_wait_prior(1);   // this tile's group has landed
    __syncwarp();
    const T* cg = cur + p * stride;
    const T* cl = cg + stride;
#pragma unroll 2
    for (int t = 0; t < cols; ++t) {
      const T gap = cg[t];
      const T lv = cl[t];
      // off the chain: drain every server, and each replica's local max
      // as it would be after a deposit of this query (a server past p
      // deposits -inf: it never counts, and its next drain resets it)
      T dep[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q)
        dep[q] = valid[q] ? mul_rn(lv, cur[off[q] + t]) : T(-INFINITY);
      T cand[KC][PER];
      T lmax[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) {
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          w[k][q] = max0(w[k][q] - gap);
          cand[k][q] = add_rn(w[k][q], dep[q]);
        }
        lmax[k] = tree_max(cand[k]);
      }
      // the chain: drain the carried maxima, choose, one warp max
      T d[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) d[k] = max0(m[k] - gap);
      int best, flags = 0;
      if constexpr (MASKED) {
        flags = masked_choice(d, mcur[t], mcur[tile + t]);
        best = flags & 0xff;
      } else {
        best = argmin_first(d);
      }
      const T mx = warp_max(select_at(lmax, best));
#pragma unroll
      for (int k = 0; k < KC; ++k) {
#pragma unroll
        for (int q = 0; q < PER; ++q)
          if (k == best) w[k][q] = cand[k][q];
        m[k] = k == best ? mx : d[k];
      }
      if (lane == 0) cbuf[t] = MASKED ? flags : best;
    }
    __syncwarp();   // every lane is done with `cur` before it is restaged
    for (int t = lane; t < cols; t += 32) {
      if constexpr (MASKED) {
        const int c = cbuf[t];
        c_row[base + t] = c & 0xff;
        spill[s * n + base + t] = (c >> 8) & 1;
        unavail[s * n + base + t] = (c >> 9) & 1;
      } else {
        c_row[base + t] = cbuf[t];
      }
    }
  }
  __pipeline_wait_prior(0);
#pragma unroll
  for (int k = 0; k < KC; ++k) {
#pragma unroll
    for (int q = 0; q < PER; ++q)
      if (k < r && valid[q]) w_out[s * rp + k * p + lane + 32 * q] = w[k][q];
  }
}

// The same algorithm with the tracker (r, p) in shared memory, for
// shapes whose tracker passes the register budget: lane l the servers
// l, l + 32, ... (`per` of them).  Its server loops diverge where p is
// not a multiple of 32; the warp max needs the whole warp, so a
// __syncwarp() closes them (ptxas already reconverges there with a
// BSYNC, and the sync compiles to nothing; PERF.md).
template <typename T, int KC, bool MASKED>
__global__ void __launch_bounds__(32)
jsq_smem_kernel(const T* __restrict__ w_in, const T* __restrict__ gaps,
                const T* __restrict__ services, const T* __restrict__ live,
                const int* __restrict__ n_act,
                const int* __restrict__ up_bits, int64_t* __restrict__ choice,
                T* __restrict__ w_out, bool* __restrict__ spill,
                bool* __restrict__ unavail, int r, int p, int64_t n, int per,
                int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t s = blockIdx.x;
  const int lane = threadIdx.x;
  const int stride = tile + 1;
  const int buf_len = (p + 2) * stride;
  const int rp = r * p;
  T* ws = reinterpret_cast<T*>(smem);   // (r, p)
  T* bufs = ws + rp;                    // 2 x (p + 2, tile + 1)
  int* mbufs = reinterpret_cast<int*>(bufs + 2 * buf_len);  // MASKED
  const T* g_row = gaps + s * n;
  const T* l_row = live + s * n;
  const T* s_rows = services + s * static_cast<int64_t>(p) * n;
  int64_t* c_row = choice + s * n;

  T m[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    T loc = -INFINITY;
    if (k < r) {
      for (int j = lane; j < p; j += 32) {
        ws[k * p + j] = w_in[s * rp + k * p + j];
        loc = tmax(loc, ws[k * p + j]);
      }
    }
    __syncwarp();
    m[k] = warp_max(loc);
    if (k >= r) m[k] = INFINITY;
  }

  if constexpr (MASKED)
    stage_masks(mbufs, n_act + s * n, up_bits + s * n, n, 0, tile, lane);
  stage(bufs, s_rows, g_row, l_row, p, n, 0, tile, lane);
  for (int64_t base = 0, it = 0; base < n; base += tile, ++it) {
    const int cols = static_cast<int>(n - base < tile ? n - base : tile);
    const T* cur = bufs + (it & 1) * buf_len;
    const int* mcur = mbufs + (it & 1) * 2 * tile;
    if constexpr (MASKED)
      stage_masks(mbufs + ((it + 1) & 1) * 2 * tile, n_act + s * n,
                  up_bits + s * n, n, base + tile, tile, lane);
    stage(bufs + ((it + 1) & 1) * buf_len, s_rows, g_row, l_row, p, n,
          base + tile, tile, lane);
    __pipeline_wait_prior(1);
    __syncwarp();
    const T* cg = cur + p * stride;
    const T* cl = cg + stride;
    for (int t = 0; t < cols; ++t) {
      const T gap = cg[t];
      const T lv = cl[t];
      T lmax[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) lmax[k] = -INFINITY;
      for (int q = 0; q < per; ++q) {
        const int j = lane + 32 * q;
        if (j < p) {
          const T dep = mul_rn(lv, cur[j * stride + t]);
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            if (k < r) {
              const T v = max0(ws[k * p + j] - gap);
              ws[k * p + j] = v;
              lmax[k] = tmax(lmax[k], add_rn(v, dep));
            }
          }
        }
      }
      T d[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) d[k] = max0(m[k] - gap);
      int best, flags = 0;
      if constexpr (MASKED) {
        flags = masked_choice(d, mcur[t], mcur[tile + t]);
        best = flags & 0xff;
      } else {
        best = argmin_first(d);
      }
      T loc = lmax[0];
#pragma unroll
      for (int k = 1; k < KC; ++k)
        if (k == best) loc = lmax[k];
      __syncwarp();
      const T mx = warp_max(loc);
#pragma unroll
      for (int k = 0; k < KC; ++k) m[k] = k == best ? mx : d[k];
      if (lane == 0) {
        c_row[base + t] = best;
        if constexpr (MASKED) {
          spill[s * n + base + t] = (flags >> 8) & 1;
          unavail[s * n + base + t] = (flags >> 9) & 1;
        }
      }
      T* wb = ws + best * p;
      for (int q = 0; q < per; ++q) {
        const int j = lane + 32 * q;
        if (j < p) wb[j] = add_rn(wb[j], mul_rn(lv, cur[j * stride + t]));
      }
    }
    __syncwarp();
  }
  __pipeline_wait_prior(0);
  for (int i = lane; i < rp; i += 32) w_out[s * rp + i] = ws[i];
}

// The wide instance (r > 16): lane l carries the maxima of replicas
// l + 32 q, q < rpl (kMaxRpl = 8: r <= 256); the tracker (r, p) in
// shared memory.  MASKED stages an active count and `rpl` words of up
// bits a query with each tile.
constexpr int kMaxRpl = 8;
constexpr int kDrain = 4;     // busy replicas drained at a time

// The (value, index) argmin over the warp, first index on ties; every
// lane returns the winner's index
template <typename T>
__device__ __forceinline__ int warp_argmin(T v, int i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
  return i;
}

// The lane-local argmin over the replicas a lane carries (ascending
// indices: strict less keeps the first), then the warp's
template <typename T>
__device__ __forceinline__ int wide_argmin(const T (&d)[kMaxRpl], int rpl,
                                           int lane) {
  T v = d[0];
  int idx = lane;
#pragma unroll
  for (int q = 1; q < kMaxRpl; ++q)
    if (q < rpl && d[q] < v) {
      v = d[q];
      idx = lane + 32 * q;
    }
  return warp_argmin(v, idx);
}

// Queue the copies of a tile's masks: the active counts (`tile` ints),
// then `words` up words a query (`tile * words` ints)
__device__ __forceinline__ void stage_masks_wide(int* buf, const int* a_row,
                                                 const int* b_row,
                                                 int64_t n, int64_t base,
                                                 int tile, int words,
                                                 int lane) {
  const int64_t left = n - base;
  const int cols = left < tile ? static_cast<int>(left) : tile;
  for (int c = lane; c < cols; c += 32)
    __pipeline_memcpy_async(&buf[c], &a_row[base + c], sizeof(int));
  for (int c = lane; c < cols * words; c += 32)
    __pipeline_memcpy_async(&buf[tile + c], &b_row[base * words + c],
                            sizeof(int));
}

template <typename T, bool MASKED>
__global__ void __launch_bounds__(32)
jsq_wide_kernel(const T* __restrict__ w_in, const T* __restrict__ gaps,
                const T* __restrict__ services, const T* __restrict__ live,
                const int* __restrict__ n_act,
                const int* __restrict__ up_bits, int64_t* __restrict__ choice,
                T* __restrict__ w_out, bool* __restrict__ spill,
                bool* __restrict__ unavail, int r, int p, int64_t n,
                int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t s = blockIdx.x;
  const int lane = threadIdx.x;
  const int stride = tile + 1;
  const int buf_len = (p + 2) * stride;
  const int rp = r * p;
  const int rpl = (r + 31) / 32;            // replicas a lane carries
  const int mlen = tile * (1 + rpl);        // a tile's mask ints
  T* ws = reinterpret_cast<T*>(smem);       // (r, p)
  T* bufs = ws + rp;                        // 2 x (p + 2, tile + 1)
  int* mbufs = reinterpret_cast<int*>(bufs + 2 * buf_len);  // MASKED
  const T* g_row = gaps + s * n;
  const T* l_row = live + s * n;
  const T* s_rows = services + s * static_cast<int64_t>(p) * n;
  int64_t* c_row = choice + s * n;
  const int* a_row = MASKED ? n_act + s * n : nullptr;
  const int* b_row = MASKED ? up_bits + s * n * rpl : nullptr;

  // the tracker clamped at 0 as it lands: the first drain clamps it
  // anyway, and the skip of idle replicas needs no negative server
  for (int i = lane; i < rp; i += 32) ws[i] = max0(w_in[s * rp + i]);
  __syncwarp();
  T m[kMaxRpl];
#pragma unroll
  for (int q = 0; q < kMaxRpl; ++q) {
    const int k = lane + 32 * q;
    T loc = -INFINITY;
    if (q < rpl && k < r)
      for (int j = 0; j < p; ++j) loc = tmax(loc, ws[k * p + j]);
    m[q] = (q < rpl && k < r) ? loc : T(INFINITY);
  }

  if constexpr (MASKED)
    stage_masks_wide(mbufs, a_row, b_row, n, 0, tile, rpl, lane);
  stage(bufs, s_rows, g_row, l_row, p, n, 0, tile, lane);
  for (int64_t base = 0, it = 0; base < n; base += tile, ++it) {
    const int cols = static_cast<int>(n - base < tile ? n - base : tile);
    const T* cur = bufs + (it & 1) * buf_len;
    const int* mcur = mbufs + (it & 1) * mlen;
    if constexpr (MASKED)
      stage_masks_wide(mbufs + ((it + 1) & 1) * mlen, a_row, b_row, n,
                       base + tile, tile, rpl, lane);
    stage(bufs + ((it + 1) & 1) * buf_len, s_rows, g_row, l_row, p, n,
          base + tile, tile, lane);
    __pipeline_wait_prior(1);
    __syncwarp();
    const T* cg = cur + p * stride;
    const T* cl = cg + stride;
    for (int t = 0; t < cols; ++t) {
      const T gap = cg[t];
      const T lv = cl[t];
      // the replicas with work before the drain: a ballot a group
      unsigned busy[kMaxRpl];
      T d[kMaxRpl];
#pragma unroll
      for (int q = 0; q < kMaxRpl; ++q) {
        busy[q] = __ballot_sync(kFull, q < rpl && lane + 32 * q < r &&
                                           m[q] > T(0));
        d[q] = max0(m[q] - gap);
      }
      // drain the tracker of every busy replica (an idle one is all 0),
      // kDrain replicas x 4 servers a lane at a time: every load before
      // any store, so that the loads are in flight together
#pragma unroll
      for (int q = 0; q < kMaxRpl; ++q) {
        for (unsigned b = busy[q]; b != 0u;) {
          int rows[kDrain];
#pragma unroll
          for (int u = 0; u < kDrain; ++u) {
            rows[u] = b != 0u ? (32 * q + __ffs(b) - 1) * p : -1;
            b &= b - 1u;
          }
          for (int j0 = lane; j0 < p; j0 += 128) {
            T v[kDrain][4];
#pragma unroll
            for (int u = 0; u < kDrain; ++u)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                v[u][c] = rows[u] >= 0 && j0 + 32 * c < p
                              ? ws[rows[u] + j0 + 32 * c]
                              : T(0);
#pragma unroll
            for (int u = 0; u < kDrain; ++u)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (rows[u] >= 0 && j0 + 32 * c < p)
                  ws[rows[u] + j0 + 32 * c] = max0(v[u][c] - gap);
          }
        }
      }
      int best;
      int flags = 0;
      if constexpr (MASKED) {
        const int act = mcur[t];
        const int* words = mcur + tile + t * rpl;
        T da[kMaxRpl], du[kMaxRpl];
        bool mine_up = false;
#pragma unroll
        for (int q = 0; q < kMaxRpl; ++q) {
          const int k = lane + 32 * q;
          const bool a = q < rpl && k < act;
          const bool u = a && ((words[q < rpl ? q : 0] >> lane) & 1);
          da[q] = a ? d[q] : T(INFINITY);
          du[q] = u ? d[q] : T(INFINITY);
          mine_up |= u;
        }
        const int raw = wide_argmin(da, rpl, lane);
        const bool any_up = __any_sync(kFull, mine_up);
        best = any_up ? wide_argmin(du, rpl, lane) : raw;
        const bool raw_up = (words[raw >> 5] >> (raw & 31)) & 1;
        flags = (static_cast<int>(any_up && !raw_up) << 8) |
                (static_cast<int>(!any_up) << 9);
      } else {
        best = wide_argmin(d, rpl, lane);
      }
      // the deposit on the chosen replica, and its new maximum
      T* wb = ws + best * p;
      T loc = -INFINITY;
      for (int j = lane; j < p; j += 32) {
        const T v = add_rn(wb[j], mul_rn(lv, cur[j * stride + t]));
        wb[j] = v;
        loc = tmax(loc, v);
      }
      __syncwarp();
      const T mx = warp_max(loc);
#pragma unroll
      for (int q = 0; q < kMaxRpl; ++q)
        m[q] = lane + 32 * q == best ? mx : d[q];
      if (lane == 0) {
        c_row[base + t] = best;
        if constexpr (MASKED) {
          spill[s * n + base + t] = (flags >> 8) & 1;
          unavail[s * n + base + t] = (flags >> 9) & 1;
        }
      }
    }
    __syncwarp();
  }
  __pipeline_wait_prior(0);
  __syncwarp();
  for (int i = lane; i < rp; i += 32) w_out[s * rp + i] = ws[i];
}

// The launch plan (kernels/jsq_route/kernel.py `JsqPlan.args`): variant
// (0 registers, 1 shared, 2 wide), KC, PER, tile, shared bytes, masked
// (0 / 1).  A block is one warp, one scenario.
constexpr int kPlanLen = 6;

template <typename Kernel>
int set_smem(Kernel kernel, int64_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// The pointers of one launch: inputs, masks (null unless masked),
// outputs, flags (null unless masked)
struct Args {
  const void* w_in;
  const void* gaps;
  const void* services;
  const void* live;
  const void* n_act;
  const void* up_bits;
  void* choice;
  void* w_out;
  void* spill;
  void* unavail;
};

template <typename T, int KC, int PER, bool MASKED>
int launch_reg(const Args& a, int64_t scenarios, int64_t r, int64_t p,
               int64_t n, const int64_t* plan, void* stream) {
  if constexpr (KC * PER * static_cast<int>(sizeof(T) / 4) > kRegBudget) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const int err = set_smem(jsq_reg_kernel<T, KC, PER, MASKED>, plan[4]);
    if (err != 0) return err;
    jsq_reg_kernel<T, KC, PER, MASKED>
        <<<dim3(static_cast<unsigned>(scenarios)), 32, plan[4],
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(a.w_in), static_cast<const T*>(a.gaps),
            static_cast<const T*>(a.services), static_cast<const T*>(a.live),
            static_cast<const int*>(a.n_act),
            static_cast<const int*>(a.up_bits),
            static_cast<int64_t*>(a.choice), static_cast<T*>(a.w_out),
            static_cast<bool*>(a.spill), static_cast<bool*>(a.unavail),
            static_cast<int>(r), static_cast<int>(p), n,
            static_cast<int>(plan[3]));
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int KC, bool MASKED>
int launch_smem(const Args& a, int64_t scenarios, int64_t r, int64_t p,
                int64_t n, const int64_t* plan, void* stream) {
  const int err = set_smem(jsq_smem_kernel<T, KC, MASKED>, plan[4]);
  if (err != 0) return err;
  jsq_smem_kernel<T, KC, MASKED><<<dim3(static_cast<unsigned>(scenarios)),
                                   32, plan[4],
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a.w_in), static_cast<const T*>(a.gaps),
      static_cast<const T*>(a.services), static_cast<const T*>(a.live),
      static_cast<const int*>(a.n_act), static_cast<const int*>(a.up_bits),
      static_cast<int64_t*>(a.choice), static_cast<T*>(a.w_out),
      static_cast<bool*>(a.spill), static_cast<bool*>(a.unavail),
      static_cast<int>(r), static_cast<int>(p), n, static_cast<int>(plan[2]),
      static_cast<int>(plan[3]));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KC, bool MASKED>
int launch_kc(const Args& a, int64_t scenarios, int64_t r, int64_t p,
              int64_t n, const int64_t* plan, void* stream) {
  if (plan[0] == 1)
    return launch_smem<T, KC, MASKED>(a, scenarios, r, p, n, plan, stream);
  switch (plan[2]) {
#define REPRO_JSQ_PER(PER)                                                  \
  case PER:                                                                 \
    return launch_reg<T, KC, PER, MASKED>(a, scenarios, r, p, n, plan,     \
                                          stream);
    REPRO_JSQ_PER(1)
    REPRO_JSQ_PER(2)
    REPRO_JSQ_PER(4)
    REPRO_JSQ_PER(8)
    REPRO_JSQ_PER(16)
#undef REPRO_JSQ_PER
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool MASKED>
int launch_masked(const Args& a, int64_t scenarios, int64_t r, int64_t p,
                  int64_t n, const int64_t* plan, void* stream) {
  switch (plan[1]) {
#define REPRO_JSQ_KC(KC)                                                   \
  case KC:                                                                 \
    return launch_kc<T, KC, MASKED>(a, scenarios, r, p, n, plan, stream);
    REPRO_JSQ_KC(2)
    REPRO_JSQ_KC(4)
    REPRO_JSQ_KC(8)
    REPRO_JSQ_KC(16)
#undef REPRO_JSQ_KC
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool MASKED>
int launch_wide(const Args& a, int64_t scenarios, int64_t r, int64_t p,
                int64_t n, const int64_t* plan, void* stream) {
  if (r > 32 * kMaxRpl) return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_smem(jsq_wide_kernel<T, MASKED>, plan[4]);
  if (err != 0) return err;
  jsq_wide_kernel<T, MASKED><<<dim3(static_cast<unsigned>(scenarios)), 32,
                               plan[4], static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a.w_in), static_cast<const T*>(a.gaps),
      static_cast<const T*>(a.services), static_cast<const T*>(a.live),
      static_cast<const int*>(a.n_act), static_cast<const int*>(a.up_bits),
      static_cast<int64_t*>(a.choice), static_cast<T*>(a.w_out),
      static_cast<bool*>(a.spill), static_cast<bool*>(a.unavail),
      static_cast<int>(r), static_cast<int>(p), n, static_cast<int>(plan[3]));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, int64_t scenarios, int64_t r, int64_t p, int64_t n,
           const int64_t* plan, int64_t plan_len, void* stream) {
  if (plan_len != kPlanLen || r < 1 || r > plan[1] || plan[3] < 1 ||
      32 * plan[2] < p || scenarios > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (plan[0] == 2) {
    if (plan[5] == 0)
      return launch_wide<T, false>(a, scenarios, r, p, n, plan, stream);
    if (!a.n_act || !a.up_bits || !a.spill || !a.unavail)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_wide<T, true>(a, scenarios, r, p, n, plan, stream);
  }
  if (plan[5] != 0) {
    if (!a.n_act || !a.up_bits || !a.spill || !a.unavail)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_masked<T, true>(a, scenarios, r, p, n, plan, stream);
  }
  return launch_masked<T, false>(a, scenarios, r, p, n, plan, stream);
}

}  // namespace

// plan: kPlanLen int64 (host memory), as `JsqPlan.args` lays it out.
// n_act, up_bits, spill and unavail are null unless the plan is masked.
extern "C" int jsq_route_f32(const void* w_in, const void* gaps,
                             const void* services, const void* live,
                             const void* n_act, const void* up_bits,
                             void* choice, void* w_out, void* spill,
                             void* unavail, int64_t scenarios, int64_t r,
                             int64_t p, int64_t n, const int64_t* plan,
                             int64_t plan_len, void* stream) {
  const Args a{w_in,    gaps,   services, live,  n_act,
               up_bits, choice, w_out,    spill, unavail};
  return launch<float>(a, scenarios, r, p, n, plan, plan_len, stream);
}

extern "C" int jsq_route_f64(const void* w_in, const void* gaps,
                             const void* services, const void* live,
                             const void* n_act, const void* up_bits,
                             void* choice, void* w_out, void* spill,
                             void* unavail, int64_t scenarios, int64_t r,
                             int64_t p, int64_t n, const int64_t* plan,
                             int64_t plan_len, void* stream) {
  const Args a{w_in,    gaps,   services, live,  n_act,
               up_bits, choice, w_out,    spill, unavail};
  return launch<double>(a, scenarios, r, p, n, plan, plan_len, stream);
}
