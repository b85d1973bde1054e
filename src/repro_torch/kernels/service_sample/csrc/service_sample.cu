// Service times of one chunk, for Hopper (sm_90a): the simulator's
// "cache" and "exponential" service draws in one pass, with torch's own
// Philox variates made in registers and never stored.
// Replaces no Pallas kernel: the reference draws its services with
// `jax.random` and scales them in XLA ops
// (`sample_service_times_batch`, src/repro/core/simulator.py); the plain
// port (`ref.service_times_ref`) is four torch draws, three broadcast
// products, a compare, an add and a `where`.
//
// What it computes, per element e of the (S, p, n) output (scenario
// s = e / (p n)):
//
//   cache:        u_hit < hit[s] ? e_hit s_hit[s]
//                                : e_miss s_miss[s] + e_disk s_disk[s]
//   exponential:  e_0 s_mean[s]
//
// with each product and the sum rounded apart (__fmul_rn / __fadd_rn: the
// plain path's separate kernels contract nothing), and each variate the
// value torch gives for element e of a (S, p, n) float32 draw from a CUDA
// generator freshly seeded with that stream's seed: `torch.rand` for
// u_hit, `Tensor.exponential_` for the e's.
//
// Torch's layout (ATen/native/cuda/DistributionTemplates.h,
// `distribution_nullary_kernel` and `calc_execution_policy`; the
// transforms in `uniform_kernel`, `exponential_kernel` and
// ATen/core/TransformationHelper.h `transformation::exponential`):
//
//   * blocks of 256 threads, grid = min(SMs x (threads an SM / 256),
//     ceil(numel / 256)) (the wrapper computes it); T = 256 x grid;
//   * thread t runs Philox4x32-10 on subsequence t from the Philox offset
//     the launch was given (4 c: 0 for a fresh `manual_seed` draw in one
//     launch), so its k-th `curand_uniform4` is the block
//     Philox(counter (c + k, t, 0), key (seed lo, seed hi)), the c + k in
//     the low 64 bits, and word ii of it lands on element t + 4Tk + T ii;
//   * a word w becomes u = w 2^-32 + 2^-33 in (0, 1] (curand's uniform;
//     the product is exact, so one rounding whether or not it is fused);
//     `torch.rand` returns u == 1 ? 0 : u, `exponential_` returns
//     u >= 1 - eps/2 ? eps/2 : -__logf(u) (eps = FLT_EPSILON; `at::log`
//     of a float is the fast `__logf` on the card, ATen/NumericUtils.h).
//
// Torch draws a tensor in one launch only while its byte offsets fit 32
// bits (numel <= 2^29 in float32).  A larger draw it halves, first half
// first, until each piece fits, and launches each piece at its own Philox
// offset; the wrapper (`kernel.draw_launches`) computes the same pieces
// and offsets and launches this kernel once a piece, at its first element
// ``start`` and counter base c.
//
// What bounds it: instruction issue, not bytes.  The only traffic is one
// 4-byte store an element (0.125 ms for 256 x 100 x 4,096 at 3.35 TB/s)
// and the (S,) fields, which stay in L1; against that, one Philox4x32-10
// block an element in cache mode (four streams, four words a block: ten
// rounds of two 32-bit wide multiplies and xors) and one or two `__logf`s.
// The design takes that at face value: no variate is written, each
// thread walks its elements in torch's order holding only the four keys,
// the scenario index steps by T without a division, a scenario's fields
// are reloaded only when it changes, and a lane computes one `__logf` on
// a hit and two on a miss (the hit branch's variate and the miss
// branch's first share one call).  A warp's stores are 32 consecutive
// floats.
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // torch's block_size_bound
constexpr int kWords = 4;       // one Philox block: four elements
constexpr uint32_t kM0 = 0xD2511F53u;   // Philox4x32 multipliers
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;   // Philox4x32 key increments
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr float kTwoPow32Inv = 2.3283064365386963e-10f;   // 2^-32
constexpr float kHalfEps = 5.9604644775390625e-08f;       // FLT_EPSILON/2

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k.x += kW0;
      k.y += kW1;
    }
    // one 32 x 32 -> 64-bit product gives both halves
    const uint64_t p0 = static_cast<uint64_t>(kM0) * c.x;
    const uint64_t p1 = static_cast<uint64_t>(kM1) * c.z;
    c = make_uint4(static_cast<uint32_t>(p1 >> 32) ^ c.y ^ k.x,
                   static_cast<uint32_t>(p1),
                   static_cast<uint32_t>(p0 >> 32) ^ c.w ^ k.y,
                   static_cast<uint32_t>(p0));
  }
  return c;
}

__device__ __forceinline__ uint32_t word(const uint4& w, int ii) {
  return ii == 0 ? w.x : ii == 1 ? w.y : ii == 2 ? w.z : w.w;
}

// curand's uniform of one word, in (0, 1]
__device__ __forceinline__ float uniform(uint32_t w) {
  return __fadd_rn(__fmul_rn(__uint2float_rn(w), kTwoPow32Inv),
                   kTwoPow32Inv / 2.0f);
}

// torch.rand: curand's (0, 1] reversed to [0, 1)
__device__ __forceinline__ float reverse_bound(float u) {
  return u == 1.0f ? 0.0f : u;
}

// Tensor.exponential_ with rate 1
__device__ __forceinline__ float unit_exponential(float u) {
  return u >= 1.0f - kHalfEps ? kHalfEps : -__logf(u);
}

// The scenario of element e = first + T j, stepped from j to j + 1
// without a division (per_scenario <= 2^31, so rem + step_r fits).
struct Scenario {
  uint32_t s, rem, step_q, step_r, per;
  __device__ Scenario(uint64_t first, uint32_t T, uint32_t per_scenario)
      : s(static_cast<uint32_t>(first / per_scenario)),
        rem(static_cast<uint32_t>(first % per_scenario)),
        step_q(T / per_scenario), step_r(T % per_scenario),
        per(per_scenario) {}
  __device__ __forceinline__ void advance() {
    s += step_q;
    rem += step_r;
    if (rem >= per) {
      rem -= per;
      ++s;
    }
  }
};

// kCache: f0..f3 = hit, s_hit, s_miss, s_disk and four streams;
// otherwise f0 = s_mean and one stream.
template <bool kCache>
__global__ void __launch_bounds__(kThreads, 4)
service_sample_kernel(float* __restrict__ out, const float* __restrict__ f0,
                      const float* __restrict__ f1,
                      const float* __restrict__ f2,
                      const float* __restrict__ f3, uint2 k0, uint2 k1,
                      uint2 k2, uint2 k3, uint64_t counter_base,
                      uint64_t start, uint32_t numel,
                      uint32_t per_scenario) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t T = gridDim.x * kThreads;
  Scenario pos(start + t, T, per_scenario);
  uint32_t held = 0xFFFFFFFFu;
  float h = 0.0f, a = 0.0f, b = 0.0f, c = 0.0f;
  uint32_t call = 0;
  for (uint32_t base = t; base < numel; base += kWords * T, ++call) {
    const uint64_t at = counter_base + call;
    const uint4 ctr = make_uint4(static_cast<uint32_t>(at),
                                 static_cast<uint32_t>(at >> 32), t, 0u);
    const uint4 w0 = philox4x32_10(ctr, k0);
    uint4 w1, w2, w3;
    if (kCache) {
      w1 = philox4x32_10(ctr, k1);
      w2 = philox4x32_10(ctr, k2);
      w3 = philox4x32_10(ctr, k3);
    }
#pragma unroll
    for (int ii = 0; ii < kWords; ++ii) {
      const uint32_t e = base + static_cast<uint32_t>(ii) * T;
      if (e < numel) {
        if (pos.s != held) {
          held = pos.s;
          a = __ldg(f0 + held);
          if (kCache) {
            h = a;
            a = __ldg(f1 + held);
            b = __ldg(f2 + held);
            c = __ldg(f3 + held);
          }
        }
        float v;
        if (kCache) {
          const bool is_hit = reverse_bound(uniform(word(w0, ii))) < h;
          const float e1 =
              unit_exponential(uniform(word(is_hit ? w1 : w2, ii)));
          if (is_hit) {
            v = __fmul_rn(e1, a);
          } else {
            v = __fadd_rn(
                __fmul_rn(e1, b),
                __fmul_rn(unit_exponential(uniform(word(w3, ii))), c));
          }
        } else {
          v = __fmul_rn(unit_exponential(uniform(word(w0, ii))), a);
        }
        out[e] = v;
      }
      pos.advance();
    }
  }
}

// Philox's key: the seed's low word, then its high word
uint2 key_of(uint64_t seed) {
  return make_uint2(static_cast<uint32_t>(seed),
                    static_cast<uint32_t>(seed >> 32));
}

// One piece of a draw: elements [start, start + numel) of out, from
// Philox counter base counter_base.
template <bool kCache>
int launch(void* out, const void* f0, const void* f1, const void* f2,
           const void* f3, uint64_t s0, uint64_t s1, uint64_t s2,
           uint64_t s3, uint64_t counter_base, int64_t start, int64_t numel,
           int64_t per_scenario, int64_t grid, void* stream) {
  service_sample_kernel<kCache>
      <<<dim3(static_cast<unsigned>(grid)), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<float*>(out) + start, static_cast<const float*>(f0),
          static_cast<const float*>(f1), static_cast<const float*>(f2),
          static_cast<const float*>(f3), key_of(s0), key_of(s1),
          key_of(s2), key_of(s3), counter_base,
          static_cast<uint64_t>(start), static_cast<uint32_t>(numel),
          static_cast<uint32_t>(per_scenario));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (S, p, n) float32; hit, s_hit, s_miss, s_disk (S,) float32; the
// seeds of the hit uniform and the hit, miss and disk exponentials; the
// piece's counter base, first element and length.
extern "C" int service_sample_cache_f32(
    void* out, const void* hit, const void* s_hit, const void* s_miss,
    const void* s_disk, uint64_t seed_hit_u, uint64_t seed_hit_e,
    uint64_t seed_miss_e, uint64_t seed_disk_e, uint64_t counter_base,
    int64_t start, int64_t numel, int64_t per_scenario, int64_t grid,
    void* stream) {
  return launch<true>(out, hit, s_hit, s_miss, s_disk, seed_hit_u,
                      seed_hit_e, seed_miss_e, seed_disk_e, counter_base,
                      start, numel, per_scenario, grid, stream);
}

// out (S, p, n) float32; s_mean (S,) float32; the exponential's seed; the
// piece's counter base, first element and length.
extern "C" int service_sample_exp_f32(void* out, const void* s_mean,
                                      uint64_t seed, uint64_t counter_base,
                                      int64_t start, int64_t numel,
                                      int64_t per_scenario, int64_t grid,
                                      void* stream) {
  return launch<false>(out, s_mean, nullptr, nullptr, nullptr, seed, 0, 0,
                       0, counter_base, start, numel, per_scenario, grid,
                       stream);
}
