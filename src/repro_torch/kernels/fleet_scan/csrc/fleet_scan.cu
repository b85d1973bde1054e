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
//   backlog   = max(backlog - cap * upf * gap, 0) + demand
//   t_epoch  += gap,  w_epoch += demand / upf
//   at t_epoch >= interval: the HPA decision (n, stab), epochs reset
//   n_act[i]  = n after the step
//
// What bounds it: the serial chain of n dependent controller steps, not
// bytes (0.003 ms of traffic a (64, 4096) chunk).  Of a step only the
// backlog's sub, max and add (and the epochs' adds) depend on the step
// before; everything else is taken off that chain:
//
//   * the off-chain terms, a tile of 32 queries at a time, lane t for
//     query t: the chain's two probabilities (a division and an exp each),
//     the query's window-down bits (window bounds converted to T once a
//     launch, on the host), the up count (one popc), upf, demand / upf;
//   * the MTBF/MTTR chain as a warp scan of 2-state maps: per replica,
//     query i's step maps {0,1} -> {0,1} with f(1) = u >= p_fail and
//     f(0) = u < p_fix.  The r replicas' f(0) and f(1) bits pack into two
//     r-bit words, and composition is bitwise,
//       (g o f)(x) = (f(x) & g(1)) | (~f(x) & g(0)),
//     associative and exact, so a 5-step __shfl_up_sync scan gives each
//     query's chain state from the tile's carry: no serial step remains in
//     the mask.  The tile's up bytes (32 x r) leave in r coalesced stores;
//   * the controller's serial step keeps the backlog, the epochs and the
//     decide test.  The division, ceil, trigger and selects of a decision
//     run only inside a warp-uniform `if (decide)`: their results were
//     only ever used there.  The steps' operands come from the staged
//     tile in shared memory, and kBatch steps run as one branch-free
//     batch: if no step of it reaches the decision interval (t_epoch
//     depends on nothing else), its results stand; else it runs again
//     step by step.
//
// Block shape: one scenario a block, three warps in a pipeline.  The
// mask warp runs tile j's MTBF/MTTR chain, the tile warp finishes tile
// j - 1 (windows, up bytes, the controller's operands) and the chain
// warp runs tile j - 2's controller steps, all at once; two-slot rings
// in shared memory hand the tiles on, one __syncthreads() a round.  Each
// warp fetches its inputs kAhead tiles ahead into registers.  Why it
// suits Hopper: each stage is a chain of dependent operations that one
// warp cannot hide (an FP32 add or max waits ~4 cycles on the one
// before, a shuffle, a division or an exp tens of cycles), so the
// stages go to three warps, one on each of three of the SM's four
// schedulers; the rings take 1.3 KB (float32) or 2.3 KB (float64) of
// shared memory, so nothing limits the blocks an SM holds: a 64-scenario
// slab spreads over 64 of the 132 SMs (four scenarios a block before
// spread it over 16), and a slab of several hundred scenarios puts
// several pipelines on each SM to hide each other.
//
// Rounding: nvcc contracts a*b+c into an FMA by default, and the plain
// loop rounds the product and the sum apart.  Every product, quotient
// and sum of the recurrences is written with the _rn intrinsics (never
// contracted), in the reference's order of operations, so that a
// decision at an interval boundary falls alike in kernel and loop: the
// kernel performs the plain loop's operations in its order and equals it
// bit for bit.  exp/expf are the CUDA math library's, as PyTorch's on the
// card; 1 - exp is rounded after the exp, as PyTorch's two kernels do.
//
// Plain C interface (bound with ctypes): the entry points return
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;        // queries a tile: one a lane
constexpr int kMaxWindows = 32;  // outage windows a launch takes
constexpr int kMaxReplicas = 16; // replicas: bits of a lane's words
constexpr int kBatch = 16;       // chain steps run without a branch
constexpr int kAhead = 2;        // tiles of inputs in flight ahead

// Everything about the spec, by value; the float constants already in T,
// each rounded once from the host's double as the plain loop's Python
// scalars are
template <typename T>
struct Params {
  int windows, mtbf_on, policy_on, upf_mode;  // upf: 0 none, 1 mask, 2 input
  int p, lo, hi, step_up, step_down, stab_n, trigger_on;
  int rep[kMaxWindows];
  T mtbf, mttr, target, interval, trigger, pf, hi_f, floor_upf;
  T start[kMaxWindows], end[kMaxWindows];
};

// A controller step's operands: gap and demand (zero past n_valid), the
// up fraction (floored) and demand / upf (demand itself without one)
template <typename T>
struct alignas(4 * sizeof(T)) Step {
  T gv, dv, upf, q;
};

// A query's inputs, fetched kAhead tiles ahead: the mask warp's (the
// gap and r uniforms) and the tile warp's (the gap, arrival time, demand
// and explicit up fraction)
template <typename T>
struct MaskIn {
  T gap;
  T u[kMaxReplicas];
};

template <typename T>
struct TileIn {
  T gap, tq, dem, uf;
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

// max(x, 0) in one instruction.  It equals x > 0 ? x : 0 but for the
// sign of a zero, which the backlog's next add (of a demand >= +0)
// removes: -0 + d = +0 + d.
__device__ __forceinline__ float max0(float x) { return fmaxf(x, 0.0f); }
__device__ __forceinline__ double max0(double x) { return fmax(x, 0.0); }

__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

__device__ __forceinline__ void load16(const double* p, double* o) {
  const double2 x = __ldcs(reinterpret_cast<const double2*>(p));
  o[0] = x.x;
  o[1] = x.y;
}

// The mask warp: the MTBF/MTTR chain of its lane's query, a tile at a
// time, and the chain's packed state (bit j: replica j up) between tiles.
template <typename T>
struct MaskWarp {
  const T *g_row, *u_row;
  int64_t n;
  int r, lane;
  unsigned rmask;
  bool u_vec;        // 16-byte loads of a query's r uniforms
  unsigned chain;
  MaskIn<T> ahead[kAhead];   // tiles k + 1 .. k + kAhead's inputs

  __device__ __forceinline__ void fetch(int64_t tile, MaskIn<T>& x) const {
    const int64_t i = tile * kTile + lane;
    x.gap = T(0);
    if (i >= n) return;
    x.gap = __ldcs(g_row + i);
    const T* up = u_row + i * r;
    constexpr int kVec = 16 / sizeof(T);
    if (u_vec) {
#pragma unroll
      for (int j = 0; j < kMaxReplicas; j += kVec)
        if (j < r) load16(up + j, x.u + j);
    } else {
#pragma unroll
      for (int j = 0; j < kMaxReplicas; ++j)
        if (j < r) x.u[j] = __ldcs(up + j);
    }
  }

  // The query's step of each replica's chain as two words of bits: f1
  // (an up replica stays up), f0 (a down one is repaired); the bits of
  // up to kR replicas, OR-ed as a tree
  template <int kR>
  __device__ __forceinline__ void maps(const MaskIn<T>& x, T p_fail,
                                       T p_fix, unsigned& f0,
                                       unsigned& f1) const {
    unsigned b1[kR], b0[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      b1[j] = j < r && x.u[j] >= p_fail ? 1u << j : 0u;
      b0[j] = j < r && x.u[j] < p_fix ? 1u << j : 0u;
    }
#pragma unroll
    for (int w = 1; w < kR; w <<= 1) {
#pragma unroll
      for (int j = 0; j + w < kR; j += 2 * w) {
        b1[j] |= b1[j + w];
        b0[j] |= b0[j + w];
      }
    }
    f1 = b1[0];
    f0 = b0[0];
  }

  // Tile `tile`'s chain states (bits of the replicas up) into `states`,
  // the chain advanced past it; tile + kAhead's inputs fetched
  __device__ __forceinline__ void tile(const Params<T>& P, int64_t tile,
                                       unsigned* states) {
    const MaskIn<T> x = ahead[0];
#pragma unroll
    for (int a = 0; a + 1 < kAhead; ++a) ahead[a] = ahead[a + 1];
    if ((tile + kAhead) * kTile < n) fetch(tile + kAhead, ahead[kAhead - 1]);
    // this query's map of each replica's state: f1 (from up), f0 (from
    // down); past the end of the chunk the identity
    unsigned f1 = rmask, f0 = 0;
    if (tile * kTile + lane < n) {
      const T p_fail = sub_rn(T(1), exp_(div_rn(-x.gap, P.mtbf)));
      const T p_fix = sub_rn(T(1), exp_(div_rn(-x.gap, P.mttr)));
      if (r <= 4)
        maps<4>(x, p_fail, p_fix, f0, f1);
      else
        maps<kMaxReplicas>(x, p_fail, p_fix, f0, f1);
    }
    // inclusive scan: lane t's map becomes query t's after every earlier
    // query's of the tile (the earlier map applied first)
#pragma unroll
    for (int off = 1; off < kTile; off <<= 1) {
      const unsigned g0 = __shfl_up_sync(kFull, f0, off);
      const unsigned g1 = __shfl_up_sync(kFull, f1, off);
      if (lane >= off) {
        const unsigned h0 = (g0 & f1) | (~g0 & f0);
        const unsigned h1 = (g1 & f1) | (~g1 & f0);
        f0 = h0;
        f1 = h1;
      }
    }
    const unsigned state = ((chain & f1) | (~chain & f0)) & rmask;
    chain = __shfl_sync(kFull, state, kTile - 1);
    states[lane] = state;
  }
};

// The tile warp: its lane's query's window bits, the up mask (with the
// mask warp's chain states), the up bytes and the controller's operands,
// a tile at a time.
template <typename T>
struct TileWarp {
  const T *g_row, *t_row, *d_row, *f_row;
  bool* up_row;      // the scenario's up bytes, null without a mask
  int64_t n, n_valid;
  int r, lane;
  unsigned rmask;
  bool up_words;     // 4-byte stores of a query's up bytes
  TileIn<T> ahead[kAhead];   // tiles k + 1 .. k + kAhead's inputs

  __device__ __forceinline__ void fetch(int64_t tile, TileIn<T>& x) const {
    const int64_t i = tile * kTile + lane;
    x.gap = x.tq = x.dem = x.uf = T(0);
    if (i >= n) return;
    x.gap = __ldcs(g_row + i);
    if (t_row) x.tq = __ldcs(t_row + i);
    if (d_row) x.dem = __ldcs(d_row + i);
    if (f_row) x.uf = __ldcs(f_row + i);
  }

  // Tile `tile`: the up bytes stored (the chain's states from `states`,
  // null without the chain), the operands into `steps` (null without a
  // policy); tile + kAhead's inputs fetched
  __device__ __forceinline__ void tile(const Params<T>& P, int64_t tile,
                                       const unsigned* states,
                                       Step<T>* steps) {
    const TileIn<T> x = ahead[0];
#pragma unroll
    for (int a = 0; a + 1 < kAhead; ++a) ahead[a] = ahead[a + 1];
    const int64_t base = tile * kTile;
    if (base + kAhead * kTile < n) fetch(tile + kAhead, ahead[kAhead - 1]);
    const int64_t i = base + lane;
    const bool in = i < n;
    const int cols = static_cast<int>(n - base < kTile ? n - base : kTile);
    unsigned up = states ? states[lane] : rmask;
    if (P.windows > 0 && in) {
      for (int w = 0; w < P.windows; ++w)
        if (x.tq >= P.start[w] && x.tq < P.end[w]) up &= ~(1u << P.rep[w]);
    }
    if (up_row) {
      bool* out = up_row + base * r;
      if (up_words) {
        // r a multiple of 4: lane t's r bytes are r / 4 words, each four
        // of its bits spread one to a byte
        uint32_t* w = reinterpret_cast<uint32_t*>(out + lane * r);
#pragma unroll
        for (int j = 0; j < kMaxReplicas / 4; ++j)
          if (4 * j < r && in)
            w[j] = (((up >> (4 * j)) & 0xfu) * 0x00204081u) & 0x01010101u;
      } else {
        // the tile's cols x r bytes, 32 consecutive bytes a store; byte k
        // is query k / r's replica k % r ((k + 0.5) / r is exact enough
        // for k < 512, r <= 16: floor lies 0.5 / r from either side).
        // Every round runs (the shuffle needs the whole warp), predicated
        // on r, so that the rounds' latencies overlap
        const int bytes = cols * r;
        const float inv_r = 1.0f / static_cast<float>(r);
#pragma unroll
        for (int j = 0; j < kMaxReplicas; ++j) {
          const int k = j * kTile + lane;
          const int q = static_cast<int>(
              __fmul_rn(static_cast<float>(k) + 0.5f, inv_r));
          const unsigned bits = __shfl_sync(kFull, up, q & (kTile - 1));
          if (j < r && k < bytes) out[k] = (bits >> (k - q * r)) & 1u;
        }
      }
    }
    if (steps) {
      const bool valid = i < n_valid;
      Step<T> s;
      s.gv = valid ? x.gap : T(0);
      s.dv = valid ? x.dem : T(0);
      s.upf = T(1);
      s.q = s.dv;
      if (P.upf_mode != 0) {
        const T upf = P.upf_mode == 1
                          ? div_rn(T(__popc(up)), T(r))
                          : x.uf;
        s.upf = tmax(upf, P.floor_upf);
        s.q = div_rn(s.dv, s.upf);
      }
      steps[lane] = s;
    }
  }
};

// The chain warp: the controller's state, in every lane alike
template <typename T>
struct ChainWarp {
  int na, stab;
  T te, we, bk, cap;

  __device__ __forceinline__ void decide(const Params<T>& P) {
    const T tiny = T(1e-30);
    T x = div_rn(we, tmax(mul_rn(mul_rn(P.pf, te), P.target), tiny));
    x = x < P.hi_f ? x : P.hi_f;         // ceil(min(x, hi)): no overflow
    int desired = static_cast<int>(ceil_(x));
    if (P.trigger_on && bk > mul_rn(cap, P.trigger))
      desired = max(desired, na + P.step_up);
    desired = min(max(desired, P.lo), P.hi);
    const bool want_up = desired > na;
    const bool want_dn = desired < na;
    const int n_up = min(na + P.step_up, desired);
    int st_next = want_dn ? stab + 1 : 0;
    const bool fire_dn = want_dn && st_next >= P.stab_n;
    na = want_up ? n_up : (fire_dn ? max(na - P.step_down, desired) : na);
    stab = fire_dn ? 0 : st_next;
    te = T(0);
    we = T(0);
    cap = mul_rn(T(na), P.pf);           // server-seconds per second
  }

  // One controller step from its operands, before the decide test
  template <bool kUpf>
  __device__ __forceinline__ void step(const Step<T>& o, T& bk_, T& te_,
                                       T& we_) const {
    const T m = kUpf ? mul_rn(mul_rn(cap, o.upf), o.gv) : mul_rn(cap, o.gv);
    bk_ = add_rn(max0(sub_rn(bk_, m)), o.dv);
    te_ = add_rn(te_, o.gv);
    we_ = add_rn(we_, o.q);
  }

  // Steps b0 .. b0 + kBatch of `steps` without a branch (past `left`
  // steps, identity steps: no gap, demand or work, which leave every
  // value as it is); true, and nothing changed, if a step's t_epoch
  // reached the interval (t_epoch depends on nothing else, so none
  // before it decided), else the three chains advanced.
  template <bool kUpf, bool kPad>
  __device__ __forceinline__ bool attempt(const Params<T>& P,
                                          const Step<T>* steps, int b0,
                                          int left) {
    T bk1 = bk, te1 = te, we1 = we;
    bool hit = false;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      Step<T> o;
      if (!kPad || b < left) {
        o = steps[b0 + b];
      } else {
        o.gv = o.dv = o.upf = o.q = T(0);
      }
      step<kUpf>(o, bk1, te1, we1);
      hit |= te1 >= P.interval;
    }
    if (!hit) {
      bk = bk1;
      te = te1;
      we = we1;
    }
    return hit;
  }

  // The tile's steps t0 .. t0 + nb; `count` is lane t's n after step t.
  // A branch-free attempt first; where it finds a decision, the steps up
  // to it run one by one, the decision is taken, and the rest of the
  // batch starts again from there: the same operations either way.
  template <bool kUpf>
  __device__ __forceinline__ void batch(const Params<T>& P,
                                        const Step<T>* steps, int t0,
                                        int nb, int lane, int& count) {
    int b = 0;
    bool hit = nb == kBatch ? attempt<kUpf, false>(P, steps + t0, 0, nb)
                            : attempt<kUpf, true>(P, steps + t0, 0, nb);
    while (hit) {
#pragma unroll 1
      for (;; ++b) {                     // a decision lies ahead
        step<kUpf>(steps[t0 + b], bk, te, we);
        if (te >= P.interval) break;     // the same in every lane
      }
      decide(P);
      if (lane >= t0 + b) count = na;
      if (++b >= nb) return;
      hit = attempt<kUpf, true>(P, steps + t0, b, nb - b);
    }
  }

  template <bool kUpf>
  __device__ __forceinline__ int tile(const Params<T>& P,
                                      const Step<T>* steps, int cols,
                                      int lane) {
    int count = na;
#pragma unroll 1
    for (int t0 = 0; t0 < cols; t0 += kBatch)
      batch<kUpf>(P, steps, t0, min(kBatch, cols - t0), lane, count);
    return count;
  }
};

// One block a scenario, three warps: the mask warp (0), the tile warp
// (1) and the chain warp (2, with a policy).  In round j the mask warp
// runs tile j's chain, the tile warp finishes tile j - 1, the chain warp
// runs tile j - 2's controller steps; two-slot rings in shared memory
// hand tiles on, one __syncthreads() a round.
template <typename T, bool kUpf>
__global__ void __launch_bounds__(3 * kTile)
fleet_scan_kernel(const __grid_constant__ Params<T> P,
                  const T* __restrict__ gaps,
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
                  T* __restrict__ bk_out, int64_t n, int r,
                  int64_t n_valid) {
  __shared__ unsigned states[2][kTile];
  __shared__ Step<T> steps[2][kTile];
  const int64_t s = blockIdx.x;
  const int lane = threadIdx.x & (kTile - 1);
  const int role = threadIdx.x / kTile;
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t rounds = tiles + (P.policy_on ? 2 : 1);
  const unsigned rmask = (1u << r) - 1u;

  if (role == 2) {                       // the chain warp
    ChainWarp<T> c;
    c.na = n_in[s];
    c.te = te_in[s];
    c.we = we_in[s];
    c.stab = stab_in[s];
    c.bk = bk_in[s];
    c.cap = mul_rn(T(c.na), P.pf);
    for (int64_t j = 0; j < rounds; ++j) {
      const int64_t k = j - 2;
      if (k >= 0) {
        const int64_t base = k * kTile;
        const int cols =
            static_cast<int>(n - base < kTile ? n - base : kTile);
        const int count = c.template tile<kUpf>(P, steps[k & 1], cols, lane);
        if (lane < cols) n_act[s * n + base + lane] = count;
      }
      __syncthreads();
    }
    if (lane == 0) {
      n_out[s] = c.na;
      te_out[s] = c.te;
      we_out[s] = c.we;
      stab_out[s] = c.stab;
      bk_out[s] = c.bk;
    }
    return;
  }

  if (role == 1) {                       // the tile warp
    TileWarp<T> w;
    w.g_row = gaps + s * n;
    w.t_row = P.windows > 0 ? t_arr + s * n : nullptr;
    w.d_row = P.policy_on ? demand + s * n : nullptr;
    w.f_row = P.upf_mode == 2 ? upf_in + s * n : nullptr;
    w.up_row = (P.windows > 0 || P.mtbf_on) ? up_out + s * n * r : nullptr;
    w.n = n;
    w.n_valid = n_valid;
    w.r = r;
    w.lane = lane;
    w.rmask = rmask;
    w.up_words =
        r % 4 == 0 && (reinterpret_cast<uintptr_t>(up_out) & 3u) == 0;
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
      if (a < tiles) w.fetch(a, w.ahead[a]);
    for (int64_t j = 0; j < rounds; ++j) {
      const int64_t k = j - 1;
      if (k >= 0 && k < tiles)
        w.tile(P, k, P.mtbf_on ? states[k & 1] : nullptr,
               P.policy_on ? steps[k & 1] : nullptr);
      __syncthreads();
    }
    return;
  }

  MaskWarp<T> m;                         // the mask warp
  m.g_row = gaps + s * n;
  m.u_row = P.mtbf_on ? u + s * n * r : nullptr;
  m.n = n;
  m.r = r;
  m.lane = lane;
  m.rmask = rmask;
  m.u_vec = (r * sizeof(T)) % 16 == 0 &&
            (reinterpret_cast<uintptr_t>(u) & 15u) == 0;
  m.chain = 0;
  if (P.mtbf_on) {
    const int c = lane < r ? chain_in[s * r + lane] : 0;
    m.chain = __ballot_sync(kFull, c > 0) & rmask;
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
      if (a < tiles) m.fetch(a, m.ahead[a]);
  }
  for (int64_t j = 0; j < rounds; ++j) {
    if (P.mtbf_on && j < tiles) m.tile(P, j, states[j & 1]);
    __syncthreads();
  }
  // the chain's state after the chunk (an empty chunk leaves it as given)
  if (P.mtbf_on && lane < r)
    chain_out[s * r + lane] =
        tiles > 0 ? static_cast<int>((m.chain >> lane) & 1u)
                  : chain_in[s * r + lane];
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
  Params<T> P{};
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
  P.mtbf = static_cast<T>(fargs[0]);
  P.mttr = static_cast<T>(fargs[1]);
  P.target = static_cast<T>(fargs[2]);
  P.interval = static_cast<T>(fargs[3]);
  P.trigger = static_cast<T>(fargs[4]);
  P.pf = static_cast<T>(P.p);
  P.hi_f = static_cast<T>(P.hi);
  P.floor_upf = static_cast<T>(P.hi >= 1 ? 1.0 / P.hi : 1.0);
  for (int w = 0; w < P.windows; ++w) {
    P.rep[w] = static_cast<int>(iargs[kIargs + w]);
    if (P.rep[w] < 0 || P.rep[w] >= r) return cudaErrorInvalidValue;
    P.start[w] = static_cast<T>(fargs[kFargs + w]);
    P.end[w] = static_cast<T>(fargs[kFargs + P.windows + w]);
  }
  if (scenarios == 0) return 0;
  if (scenarios > 0x7fffffff) return cudaErrorInvalidValue;
  const int threads = P.policy_on ? 3 * kTile : 2 * kTile;
  const dim3 grid(static_cast<unsigned>(scenarios));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = P.upf_mode != 0 ? fleet_scan_kernel<T, true>
                                : fleet_scan_kernel<T, false>;
  kernel<<<grid, threads, 0, st>>>(
      P, static_cast<const T*>(gaps), static_cast<const T*>(t_arr),
      static_cast<const T*>(u), static_cast<const T*>(demand),
      static_cast<const T*>(upf_in), static_cast<const int*>(chain_in),
      static_cast<const int*>(n_in), static_cast<const T*>(te_in),
      static_cast<const T*>(we_in), static_cast<const int*>(stab_in),
      static_cast<const T*>(bk_in), static_cast<bool*>(up_out),
      static_cast<int*>(n_act), static_cast<int*>(chain_out),
      static_cast<int*>(n_out), static_cast<T*>(te_out),
      static_cast<T*>(we_out), static_cast<int*>(stab_out),
      static_cast<T*>(bk_out), n, static_cast<int>(r), n_valid);
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
