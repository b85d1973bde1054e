// The fleet scan of one chunk of queries, for Hopper (sm_90a): the
// replica-up mask and the autoscaler's active replica count.
// Replaces no Pallas kernel: the reference runs both recurrences as
// per-query `lax.scan`s (`fault_scan`, src/repro/core/faults.py:168, and
// `autoscale_scan`, src/repro/launch/elastic.py:164), which in plain
// PyTorch are ~25 small launches a query, 4096 queries a chunk.
//
// Per scenario and query i (gap_i, arrival time t_i):
//
//   up[i][j]  = chain_j(i) && no outage window of replica j holds t_i
//   chain_j   = chain_j ? u[i][j] >= 1 - exp(-gap/MTBF)
//                       : u[i][j] <  1 - exp(-gap/MTTR)
//   upf       = max(popc(up[i]) / r, 1 / max_r)   (or an explicit upf)
//   backlog, t_epoch, w_epoch, stab, n: the HPA controller's step
//   n_act[i]  = n after the step
//
// What bounds it: the serial chain of n dependent controller steps (a
// division, a ceil and a handful of selects each), not bytes.  The
// design keeps everything else off that chain:
//
//   * one warp a scenario, four warps a block; lane j < r carries replica
//     j's chain state, so the up count is one __ballot_sync + __popc, and
//     the uniforms u[i][0..r) are one coalesced row;
//   * the controller's five-value state runs in every lane from the same
//     values (no shuffle, no broadcast);
//   * a tile's inputs (32 queries: gaps, arrival times, demands, explicit
//     up fractions, uniforms) are staged into the warp's shared memory by
//     cp.async, double-buffered, so no step waits on device memory;
//   * lane t keeps query t's count, stored once a tile.
//
// Rounding: nvcc contracts a*b+c into an FMA by default, and the plain
// loop rounds the product and the sum apart.  Every product, quotient
// and sum of the recurrences is written with the _rn intrinsics (never
// contracted), in the reference's order of operations, so that a
// decision at an interval boundary falls alike in kernel and loop.
// exp/expf are the CUDA math library's, as PyTorch's on the card.
//
// Plain C interface (bound with ctypes): the entry points return
// cudaGetLastError() after the launch.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;        // warps (scenarios) a block
constexpr int kTile = 32;        // queries a staged tile
constexpr int kMaxWindows = 32;  // outage windows a launch takes
constexpr int kMaxReplicas = 16; // lanes that carry a replica
constexpr int kRows = 4;         // gaps, times, demand, upf; then u

// Everything about the spec, by value (the iargs / fargs of the entry)
struct Params {
  int windows, mtbf_on, policy_on, upf_mode;  // upf: 0 none, 1 mask, 2 input
  int p, lo, hi, step_up, step_down, stab_n, trigger_on;
  int rep[kMaxWindows];
  double mtbf, mttr, target, interval, trigger;
  double start[kMaxWindows], end[kMaxWindows];
};

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
__device__ __forceinline__ float sub_rn(float x, float y) {
  return __fsub_rn(x, y);
}
__device__ __forceinline__ double sub_rn(double x, double y) {
  return __dsub_rn(x, y);
}
__device__ __forceinline__ float div_rn(float x, float y) {
  return __fdiv_rn(x, y);
}
__device__ __forceinline__ double div_rn(double x, double y) {
  return __ddiv_rn(x, y);
}
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float ceil_(float x) { return ceilf(x); }
__device__ __forceinline__ double ceil_(double x) { return ceil(x); }

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return a > b ? a : b;
}

// The warp's copies of a tile (queries base .. base + cols): row 0 the
// gaps, 1 the arrival times, 2 the demands, 3 the explicit up fractions,
// then the uniforms, r a query; absent inputs are skipped.  One group.
template <typename T>
__device__ __forceinline__ void stage(T* buf, const T* g_row, const T* t_row,
                                      const T* d_row, const T* f_row,
                                      const T* u_row, int r, int64_t n,
                                      int64_t base, int lane) {
  const int64_t left = n - base;
  const int cols = left < kTile ? static_cast<int>(left) : kTile;
  if (lane < cols) {
    __pipeline_memcpy_async(&buf[lane], &g_row[base + lane], sizeof(T));
    if (t_row)
      __pipeline_memcpy_async(&buf[kTile + lane], &t_row[base + lane],
                              sizeof(T));
    if (d_row)
      __pipeline_memcpy_async(&buf[2 * kTile + lane], &d_row[base + lane],
                              sizeof(T));
    if (f_row)
      __pipeline_memcpy_async(&buf[3 * kTile + lane], &f_row[base + lane],
                              sizeof(T));
  }
  if (u_row) {
    for (int k = lane; k < cols * r; k += 32)
      __pipeline_memcpy_async(&buf[kRows * kTile + k], &u_row[base * r + k],
                              sizeof(T));
  }
  __pipeline_commit();
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fleet_scan_kernel(const Params P, const T* __restrict__ gaps,
                  const T* __restrict__ t_arr, const T* __restrict__ u,
                  const T* __restrict__ demand, const T* __restrict__ upf_in,
                  const int* __restrict__ chain_in,
                  const int* __restrict__ n_in, const T* __restrict__ te_in,
                  const T* __restrict__ we_in,
                  const int* __restrict__ stab_in,
                  const T* __restrict__ bk_in, bool* __restrict__ up_out,
                  int* __restrict__ n_act, int* __restrict__ chain_out,
                  int* __restrict__ n_out, T* __restrict__ te_out,
                  T* __restrict__ we_out, int* __restrict__ stab_out,
                  T* __restrict__ bk_out, int64_t scenarios, int64_t n,
                  int r, int64_t n_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (s >= scenarios) return;   // the whole warp leaves together
  const int buf_len = (kRows + r) * kTile;
  T* bufs = reinterpret_cast<T*>(smem) + warp * 2 * buf_len;
  const bool mine = lane < r;
  const bool outage = P.windows > 0 || P.mtbf_on;

  const T* g_row = gaps + s * n;
  const T* t_row = P.windows > 0 ? t_arr + s * n : nullptr;
  const T* d_row = P.policy_on ? demand + s * n : nullptr;
  const T* f_row = P.upf_mode == 2 ? upf_in + s * n : nullptr;
  const T* u_row = P.mtbf_on ? u + s * n * r : nullptr;

  int chain = (P.mtbf_on && mine) ? chain_in[s * r + lane] : 1;
  int na = 0, stab = 0;
  T te = T(0), we = T(0), bk = T(0);
  if (P.policy_on) {
    na = n_in[s];
    te = te_in[s];
    we = we_in[s];
    stab = stab_in[s];
    bk = bk_in[s];
  }
  // the spec's constants in T, each rounded once as the plain loop's
  // Python scalars are
  const T mtbf = T(P.mtbf), mttr = T(P.mttr);
  const T interval = T(P.interval), target = T(P.target);
  const T trig = T(P.trigger), pf = T(P.p), hi_f = T(P.hi);
  const T floor_upf = T(1.0 / P.hi), tiny = T(1e-30);
  const T rf = T(r);

  stage(bufs, g_row, t_row, d_row, f_row, u_row, r, n, 0, lane);
  for (int64_t base = 0, it = 0; base < n; base += kTile, ++it) {
    const int cols = static_cast<int>(n - base < kTile ? n - base : kTile);
    const T* cur = bufs + (it & 1) * buf_len;
    // the next tile: copies in flight while this one runs
    stage(bufs + ((it + 1) & 1) * buf_len, g_row, t_row, d_row, f_row, u_row,
          r, n, base + kTile, lane);
    __pipeline_wait_prior(1);   // this tile's group has landed
    __syncwarp();
    int my_count = 0;
    for (int t = 0; t < cols; ++t) {
      const int64_t i = base + t;
      const T gap = cur[t];
      bool up = true;
      if (outage) {
        if (P.mtbf_on) {
          const T uq = mine ? cur[kRows * kTile + t * r + lane] : T(0);
          const T p_fail = T(1) - exp_(div_rn(-gap, mtbf));
          const T p_fix = T(1) - exp_(div_rn(-gap, mttr));
          chain = chain > 0 ? (uq >= p_fail) : (uq < p_fix);
          up = chain > 0;
        }
        if (P.windows > 0) {
          const T tq = cur[kTile + t];
          for (int w = 0; w < P.windows; ++w)
            if (P.rep[w] == lane && tq >= T(P.start[w]) && tq < T(P.end[w]))
              up = false;
        }
        if (mine) up_out[(s * n + i) * r + lane] = up;
      }
      if (!P.policy_on) continue;
      const bool valid = i < n_valid;
      const T gv = valid ? gap : T(0);
      const T dv = valid ? cur[2 * kTile + t] : T(0);
      const T cap = mul_rn(T(na), pf);     // server-seconds per second
      if (P.upf_mode != 0) {
        T upf = P.upf_mode == 1
                    ? div_rn(T(__popc(__ballot_sync(kFull, mine && up))), rf)
                    : cur[3 * kTile + t];
        upf = tmax(upf, floor_upf);
        bk = add_rn(tmax(sub_rn(bk, mul_rn(mul_rn(cap, upf), gv)), T(0)),
                    dv);
        te = add_rn(te, gv);
        we = add_rn(we, div_rn(dv, upf));
      } else {
        bk = add_rn(tmax(sub_rn(bk, mul_rn(cap, gv)), T(0)), dv);
        te = add_rn(te, gv);
        we = add_rn(we, dv);
      }
      const bool decide = te >= interval;
      T x = div_rn(we, tmax(mul_rn(mul_rn(pf, te), target), tiny));
      x = x < hi_f ? x : hi_f;             // ceil(min(x, hi)): no overflow
      int desired = static_cast<int>(ceil_(x));
      if (P.trigger_on && bk > mul_rn(cap, trig))
        desired = max(desired, na + P.step_up);
      desired = min(max(desired, P.lo), P.hi);
      const bool want_up = desired > na;
      const bool want_dn = desired < na;
      const int n_up = min(na + P.step_up, desired);
      int st_next = want_dn ? stab + 1 : 0;
      const bool fire_dn = want_dn && st_next >= P.stab_n;
      const int n_next =
          want_up ? n_up : (fire_dn ? max(na - P.step_down, desired) : na);
      st_next = fire_dn ? 0 : st_next;
      if (decide) {
        na = n_next;
        stab = st_next;
        te = T(0);
        we = T(0);
      }
      if (lane == t) my_count = na;
    }
    __syncwarp();   // every lane is done with `cur` before it is restaged
    if (P.policy_on && lane < cols) n_act[s * n + base + lane] = my_count;
  }
  __pipeline_wait_prior(0);
  if (P.mtbf_on && mine) chain_out[s * r + lane] = chain;
  if (P.policy_on && lane == 0) {
    n_out[s] = na;
    te_out[s] = te;
    we_out[s] = we;
    stab_out[s] = stab;
    bk_out[s] = bk;
  }
}

// iargs: windows, mtbf_on, policy_on, upf_mode, p, lo, hi, step_up,
// step_down, stab_n, trigger_on, then the windows' replicas;
// fargs: mtbf, mttr, target, interval, trigger, then the windows' starts,
// then their ends.  Both in host memory.
constexpr int kIargs = 11;
constexpr int kFargs = 5;

template <typename T>
int launch(const void* gaps, const void* t_arr, const void* u,
           const void* demand, const void* upf_in, const void* chain_in,
           const void* n_in, const void* te_in, const void* we_in,
           const void* stab_in, const void* bk_in, void* up_out, void* n_act,
           void* chain_out, void* n_out, void* te_out, void* we_out,
           void* stab_out, void* bk_out, int64_t scenarios, int64_t n,
           int64_t r, int64_t n_valid, const int64_t* iargs, int64_t n_i,
           const double* fargs, int64_t n_f, void* stream) {
  if (n_i < kIargs || n_f < kFargs) return cudaErrorInvalidValue;
  Params P{};
  P.windows = static_cast<int>(iargs[0]);
  P.mtbf_on = static_cast<int>(iargs[1]);
  P.policy_on = static_cast<int>(iargs[2]);
  P.upf_mode = static_cast<int>(iargs[3]);
  P.p = static_cast<int>(iargs[4]);
  P.lo = static_cast<int>(iargs[5]);
  P.hi = static_cast<int>(iargs[6]);
  P.step_up = static_cast<int>(iargs[7]);
  P.step_down = static_cast<int>(iargs[8]);
  P.stab_n = static_cast<int>(iargs[9]);
  P.trigger_on = static_cast<int>(iargs[10]);
  if (P.windows < 0 || P.windows > kMaxWindows ||
      n_i != kIargs + P.windows || n_f != kFargs + 2 * P.windows || r < 1 ||
      r > kMaxReplicas || (P.policy_on && P.hi < 1) ||
      (P.upf_mode == 1 && !(P.windows > 0 || P.mtbf_on)))
    return cudaErrorInvalidValue;
  P.mtbf = fargs[0];
  P.mttr = fargs[1];
  P.target = fargs[2];
  P.interval = fargs[3];
  P.trigger = fargs[4];
  for (int w = 0; w < P.windows; ++w) {
    P.rep[w] = static_cast<int>(iargs[kIargs + w]);
    P.start[w] = fargs[kFargs + w];
    P.end[w] = fargs[kFargs + P.windows + w];
  }
  if (scenarios == 0) return 0;
  const int64_t blocks = (scenarios + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kWarps) * 2 * (kRows + r) * kTile *
                      sizeof(T);
  fleet_scan_kernel<T><<<dim3(static_cast<unsigned>(blocks)), kWarps * 32,
                         smem, static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const T*>(gaps), static_cast<const T*>(t_arr),
      static_cast<const T*>(u), static_cast<const T*>(demand),
      static_cast<const T*>(upf_in), static_cast<const int*>(chain_in),
      static_cast<const int*>(n_in), static_cast<const T*>(te_in),
      static_cast<const T*>(we_in), static_cast<const int*>(stab_in),
      static_cast<const T*>(bk_in), static_cast<bool*>(up_out),
      static_cast<int*>(n_act), static_cast<int*>(chain_out),
      static_cast<int*>(n_out), static_cast<T*>(te_out),
      static_cast<T*>(we_out), static_cast<int*>(stab_out),
      static_cast<T*>(bk_out), scenarios, n, static_cast<int>(r), n_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The entry points: pointers (null where the spec does not need them),
// shapes, the spec's iargs / fargs in host memory, the stream.
extern "C" int fleet_scan_f32(
    const void* gaps, const void* t_arr, const void* u, const void* demand,
    const void* upf_in, const void* chain_in, const void* n_in,
    const void* te_in, const void* we_in, const void* stab_in,
    const void* bk_in, void* up_out, void* n_act, void* chain_out,
    void* n_out, void* te_out, void* we_out, void* stab_out, void* bk_out,
    int64_t scenarios, int64_t n, int64_t r, int64_t n_valid,
    const int64_t* iargs, int64_t n_i, const double* fargs, int64_t n_f,
    void* stream) {
  return launch<float>(gaps, t_arr, u, demand, upf_in, chain_in, n_in, te_in,
                       we_in, stab_in, bk_in, up_out, n_act, chain_out, n_out,
                       te_out, we_out, stab_out, bk_out, scenarios, n, r,
                       n_valid, iargs, n_i, fargs, n_f, stream);
}

extern "C" int fleet_scan_f64(
    const void* gaps, const void* t_arr, const void* u, const void* demand,
    const void* upf_in, const void* chain_in, const void* n_in,
    const void* te_in, const void* we_in, const void* stab_in,
    const void* bk_in, void* up_out, void* n_act, void* chain_out,
    void* n_out, void* te_out, void* we_out, void* stab_out, void* bk_out,
    int64_t scenarios, int64_t n, int64_t r, int64_t n_valid,
    const int64_t* iargs, int64_t n_i, const double* fargs, int64_t n_f,
    void* stream) {
  return launch<double>(gaps, t_arr, u, demand, upf_in, chain_in, n_in,
                        te_in, we_in, stab_in, bk_in, up_out, n_act,
                        chain_out, n_out, te_out, we_out, stab_out, bk_out,
                        scenarios, n, r, n_valid, iargs, n_i, fargs, n_f,
                        stream);
}
