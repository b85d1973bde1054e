// One-token GQA decode attention against a KV cache, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention/kernel.py, body `_decode_kernel`).
//
// Computes, for q (B, 1, H, D) and one layer's cache k, v (B, S, KV, D) in
// the model's layout (any strides, D contiguous), H = KV * G, and `n` =
// the last valid position + 1:
//
//   out[b, h] = sum_{j < n} softmax_j(q[b, h] . k[b, j, h / G] / sqrt(D)) v[b, j, h / G]
//
// with m, l and acc in float32, l floored at 1e-30, the output cast to q's
// type.  float32 or bfloat16; no TF32 anywhere.
//
// What bounds it: memory.  K and V for positions < n are read once (at
// B = 8, H = 32, KV = 8, D = 128 and n = 2101, 69 MB: ~20 us at 3.35 TB/s)
// against ~2 FLOP per byte.  Positions >= n are never read.  The design:
//
//   * flash-decoding: one block per (split, kv head, batch); a split is a
//     run of `chunk` consecutive positions, so B x KV x splits blocks fill
//     the card even at B x KV = 64 (the TPU kernel's one sequential pass per
//     (b, kv) row would occupy under half of the 132 SMs);
//   * inside a block, a group of kLanes lanes holds one cache row: each lane
//     loads 16 B of K and of V (a 256 B bfloat16 row at D = 128 is 16
//     lanes), so a warp reads whole contiguous rows.  Each group walks its
//     own positions in batches of kUnroll rows with a running (m, l, acc)
//     for all G heads of the kv head: the q . k partial dots reduced across
//     the group by shuffles, one softmax update a batch, and the next
//     batch's loads in flight during this batch's arithmetic;
//   * the block merges its groups in shared memory and writes one partial
//     (m, l, acc[D]) per head to a float32 scratch the wrapper allocates;
//   * `decode_combine_kernel`, launched next on the same stream by the same
//     entry point, merges the splits and writes the output.
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after the two launches.

#include "../../csrc/attention_io.cuh"

namespace {

using attn::Io;
using attn::kFull;

constexpr int kThreads = 128;
constexpr int kUnroll = 4;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc,
                    int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                    int n, int chunk, float scale) {
  constexpr int kVec = Io<T>::kVec;
  constexpr int kLanes = D / kVec;             // lanes per cache row
  constexpr int kGroups = kThreads / kLanes;   // rows in flight per block
  static_assert(kLanes >= 1 && kLanes <= 32 && 32 % kLanes == 0,
                "a cache row must fit one warp");
  __shared__ float sm_m[kGroups][G];
  __shared__ float sm_l[kGroups][G];
  __shared__ float sm_acc[kGroups][G][D];

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int grp = tid / kLanes;
  const int lane = tid % kLanes;
  const int s0 = split * chunk;
  const int s1 = min(n, s0 + chunk);

  float qv[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g)
    Io<T>::unpack(Io<T>::load(q + b * q_sb + (kvh * G + g) * q_sh +
                              lane * kVec),
                  qv[g]);

  float m[G], l[G], acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.0f;
  }

  const T* kb = k + b * k_sb + kvh * k_sh + lane * kVec;
  const T* vb = v + b * v_sb + kvh * v_sh + lane * kVec;
  constexpr int kStep = kGroups * kUnroll;   // rows a block takes per batch
  using Raw = typename Io<T>::Raw;
  Raw kr[kUnroll], vr[kUnroll], kn[kUnroll], vn[kUnroll];
  auto load = [&](int base, Raw (&kd)[kUnroll], Raw (&vd)[kUnroll]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * kGroups + grp;
      if (pos < s1) {
        kd[u] = Io<T>::load(kb + pos * k_ss);
        vd[u] = Io<T>::load(vb + pos * v_ss);
      }
    }
  };
  load(s0, kr, vr);

  // The trip count is uniform over the block, so every lane of a warp
  // reaches the shuffles; rows past s1 are masked, never loaded.  The next
  // batch's rows are in flight while this batch is computed, and the
  // online softmax is updated once a batch (one rescale of acc), not once
  // a row.
  for (int base = s0; base < s1; base += kStep) {
    if (base + kStep < s1) load(base + kStep, kn, vn);
    float sc[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = base + u * kGroups + grp < s1;
      float kf[kVec];
      Io<T>::unpack(kr[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qv[g][e], kf[e], dot);
#pragma unroll
        for (int off = kLanes / 2; off >= 1; off >>= 1)
          dot += __shfl_xor_sync(kFull, dot, off);
        sc[u][g] = valid ? dot * scale : -INFINITY;
      }
    }
    // sc becomes the batch's probabilities p = exp(s - m_new)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mb = sc[0][g];
#pragma unroll
      for (int u = 1; u < kUnroll; ++u) mb = fmaxf(mb, sc[u][g]);
      const float m_new = fmaxf(m[g], mb);
      const float alpha = attn::exp_sub(m[g], m_new);
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        sc[u][g] = attn::exp_sub(sc[u][g], m_new);
        psum += sc[u][g];
      }
      l[g] = l[g] * alpha + psum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * kGroups + grp >= s1) continue;
      float vf[kVec];
      Io<T>::unpack(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[g][e] = fmaf(sc[u][g], vf[e], acc[g][e]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
    }
  }

  // merge the block's groups; a group that saw no position holds m = -inf
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[grp][g] = m[g];
      sm_l[grp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) sm_acc[grp][g][lane * kVec + e] = acc[g][e];
  }
  __syncthreads();
  const int64_t row0 =
      ((static_cast<int64_t>(b) * gridDim.y + kvh) * gridDim.x + split) * G;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float mx = -INFINITY;
#pragma unroll 4
    for (int r = 0; r < kGroups; ++r) mx = fmaxf(mx, sm_m[r][g]);
    float lsum = 0.0f, asum = 0.0f;
#pragma unroll 4
    for (int r = 0; r < kGroups; ++r) {
      const float w = attn::exp_sub(sm_m[r][g], mx);
      lsum = fmaf(sm_l[r][g], w, lsum);
      asum = fmaf(sm_acc[r][g][d], w, asum);
    }
    part_acc[(row0 + g) * D + d] = asum;
    if (d == 0) {
      part_m[row0 + g] = mx;
      part_l[row0 + g] = lsum;
    }
  }
}

// merges the splits of one (kv head, batch): out = sum_s w_s acc_s /
// max(sum_s w_s l_s, 1e-30), w_s = exp(m_s - max_s m_s)
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out,
                      int64_t o_sb, int64_t o_sh, int splits) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t row0 = (static_cast<int64_t>(b) * gridDim.x + kvh) * splits;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float mx = -INFINITY;
#pragma unroll 8
    for (int s = 0; s < splits; ++s)
      mx = fmaxf(mx, part_m[(row0 + s) * G + g]);
    float lsum = 0.0f, asum = 0.0f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const int64_t r = (row0 + s) * G + g;
      const float w = attn::exp_sub(part_m[r], mx);
      lsum = fmaf(part_l[r], w, lsum);
      asum = fmaf(part_acc[r * D + d], w, asum);
    }
    out[b * o_sb + (kvh * G + g) * o_sh + d] =
        Io<T>::store(asum / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D, int G>
int launch_dg(const void* q, const void* k, const void* v, void* out,
              void* part, const int64_t* st, int64_t batch, int64_t kv,
              int64_t n, int64_t chunk, int64_t splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows = batch * kv * splits * G;
  float* part_m = static_cast<float*>(part);
  float* part_l = part_m + rows;
  float* part_acc = part_l + rows;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  decode_split_kernel<T, D, G>
      <<<dim3(static_cast<unsigned>(splits), static_cast<unsigned>(kv),
              static_cast<unsigned>(batch)),
         kThreads, 0, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), part_m, part_l, part_acc,
                           st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                           st[7], static_cast<int>(n), static_cast<int>(chunk),
                           scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T, D, G>
      <<<dim3(static_cast<unsigned>(kv), static_cast<unsigned>(batch)),
         kThreads, 0, s>>>(part_m, part_l, part_acc, static_cast<T*>(out),
                           st[8], st[9], static_cast<int>(splits));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out,
             void* part, const int64_t* st, int64_t batch, int64_t kv,
             int64_t groups, int64_t n, int64_t chunk, int64_t splits,
             void* stream) {
  switch (groups) {
    case 1:
      return launch_dg<T, D, 1>(q, k, v, out, part, st, batch, kv, n, chunk,
                                splits, stream);
    case 2:
      return launch_dg<T, D, 2>(q, k, v, out, part, st, batch, kv, n, chunk,
                                splits, stream);
    case 4:
      return launch_dg<T, D, 4>(q, k, v, out, part, st, batch, kv, n, chunk,
                                splits, stream);
    case 8:
      return launch_dg<T, D, 8>(q, k, v, out, part, st, batch, kv, n, chunk,
                                splits, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           void* part, const int64_t* st, int64_t batch, int64_t kv,
           int64_t groups, int64_t d, int64_t n, int64_t chunk,
           int64_t splits, void* stream) {
  switch (d) {
    case 16:
      return launch_d<T, 16>(q, k, v, out, part, st, batch, kv, groups, n,
                             chunk, splits, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, out, part, st, batch, kv, groups, n,
                             chunk, splits, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, out, part, st, batch, kv, groups, n,
                             chunk, splits, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, out, part, st, batch, kv, groups, n,
                              chunk, splits, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 10 int64 (host memory), in elements: q (batch, head), k and v
// (batch, position, head), out (batch, head); the last axis (D) is
// contiguous.  part: batch x kv x splits x groups x (D + 2) float32.
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, void* out, void* part,
                                    const int64_t* strides, int64_t batch,
                                    int64_t kv, int64_t groups, int64_t d,
                                    int64_t n, int64_t chunk, int64_t splits,
                                    void* stream) {
  return launch<float>(q, k, v, out, part, strides, batch, kv, groups, d, n,
                       chunk, splits, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, void* out, void* part,
                                     const int64_t* strides, int64_t batch,
                                     int64_t kv, int64_t groups, int64_t d,
                                     int64_t n, int64_t chunk,
                                     int64_t splits, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, part, strides, batch, kv, groups,
                               d, n, chunk, splits, stream);
}
