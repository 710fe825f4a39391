// Fused latent chain, forward: every (layer, modality) block of the HealNet
// fusion loop in one launch, one block per batch element.
//
// Replaces: healnet_tpu/ops/fused_chain.py::_fwd_kernel (the Pallas kernel
// launched by _fwd_call). Forward only, as there. Per layer l and modality
// m (site = l * M + m), on the latent x (lc x ld, f32 throughout):
//   y = LN1(x); q = round_T(y @ wq)                       (lc x inner)
//   s = q K^T * scale + (mask - 1) * 1e30 on the K columns of the merged KV
//       at offsets[l]; p = exp(s - max) * mask; probs = p / max(sum p, 1e-30)
//   pd = round_T(keep ? probs * f32(1 / (1 - rate)) : 0), keep from the
//       coordinate hash over (batch index, query, key) with seeds[l, m]
//   av = pd @ V (f32 sums); u = LeakyReLU_0.01(av @ wout + bout)
//   x += presence[b, m] * u
//   g = LN2(x) @ w0 + b0; h = g[:, :F] * act(g[:, F:]) @ w2 + b2
//   x += presence[b, m] * (h * ff_keep[b, site])   (ff_keep when given)
// and the output is round_T(x), once, at the end. LN is the chain's own:
// var = E[x^2] - mu^2, eps 1e-5. T is the KV and latent dtype (bf16 or f32).
//
// Bound on an H100 SXM at the brca row (b = 8, lc = 17, ld = 126, inner =
// 63, KV (8, 4096, 252) bf16): 20 MB of inputs, about 6 us at 3.35 TB/s,
// against 0.5 GFLOP. The design is the TPU kernel's grid: one block per
// batch element, so 8 of 132 SMs work and the kernel is bound by one SM's
// f32 FMA rate and latency: on an H100 SXM (700 W) it takes about 1.7 ms at
// brca, some 280 times its bound (chip_smoke.py, phase 11; PERF.md has the
// phase breakdown of scripts/profile_chain_phases.py). What the design does
// inside the block:
//   - the latent, its LayerNorm, q, the attention output and the FF hidden
//     state (lc x 2F f32, 68.5 KB at brca) live in shared memory (122 KB at
//     brca, set above the 48 KB default); weights stream from L2;
//   - the softmax over the keys does not fit in shared memory (lc x 4096 f32
//     is 278 KB), so it takes two passes over 128-key tiles: the first keeps
//     each row's max and sum (online, in f32), the second recomputes the
//     scores with the same code, forms the normalized probability, drops
//     it, rounds it to T and accumulates @V in f32 registers. No bf16 value
//     is rescaled after rounding, so the result stays on the reference's;
//   - K and V rows arrive as column slices of the merged KV at any element
//     offset (27, 54, 63, 126, ...: not 4- or 16-byte aligned), so a tile is
//     loaded element by element into a padded f32 tile (odd multiple of 4
//     floats a row, conflict-free float4 reads). One block per SM hides
//     memory latency only with many loads in flight, so each thread issues
//     all its loads of a tile (17 at brca) before its first store;
//   - the latent-side products (q, out, the FF) are one routine: a thread
//     owns one output column for 9 rows and walks K, reading a weight once
//     per 9 FMAs, 8 weights in flight; when there are fewer items than
//     threads, K is split and the partial sums are added in a fixed order
//     (deterministic).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_dropout.cuh"

namespace {

constexpr int kThreads = 512;  // 256 (more registers a thread) measured slower
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLc = 32;
constexpr int kTile = 128;                       // keys per tile
constexpr int kScoreGroups = kThreads / kTile;   // row groups of the score step
constexpr int kMaxScoreRows = kMaxLc / kScoreGroups;  // rows per thread there
constexpr int kDLanes = 64;                      // value columns per row group
constexpr int kAvGroups = kThreads / kDLanes;    // row groups of the @V step
constexpr int kMaxAvRows = kMaxLc / kAvGroups;
constexpr int kMaxAvChunks = 2;                  // inner <= 128
constexpr int kRB = 9;                           // rows per item of the products
constexpr int kMaxSplit = 8;
constexpr int kMaxMod = 4;
constexpr int kMaxDepth = 16;
constexpr int kMaxInner = kDLanes * kMaxAvChunks;
constexpr int kUnroll = 8;                        // weights in flight per product item
constexpr float kNegBig = 1e30f;
constexpr float kSeluAlpha = 1.6732632423543772f;
constexpr float kSeluScale = 1.0507009873554805f;
constexpr float kInvSqrt2 = 0.7071067811865476f;

// weight bundle order (WEIGHT_FIELDS), each f32 and stacked over (L, M)
enum { kLn1S, kLn1B, kWq, kWout, kBout, kLn2S, kLn2B, kW0, kB0, kW2, kB2, kFields };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

struct Params {
  const void* x0;  // (B, lc, ld) T
  void* out;       // (B, lc, ld) T
  const void* kv[kMaxMod];  // (B, t_m, F_m) T, unit stride on the columns
  long long kv_sb[kMaxMod], kv_st[kMaxMod];
  int tokens[kMaxMod];
  const float* mask[kMaxMod];  // (B, t_m) f32 or null
  long long mask_sb[kMaxMod];
  const float* ffk;        // (B, L * M, lc, ld) f32 or null
  const float* presence;   // (B, M) f32
  const long long* seeds;  // (L, M) 32-bit patterns held in int64
  const float* w[kFields];
  int offsets[kMaxDepth];
  int depth, n_mod, lc, ld, inner, mult, gelu;
  float scale;
  int dropout;
  uint32_t threshold;
  float keep_scale;
};

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// row pitch of the key/value tiles: a multiple of 4 floats whose quarter is
// odd, so the float4 reads of 8 neighbouring rows hit 32 different banks
__host__ __device__ inline int key_pitch(int inner) {
  const int kp = align4(inner);
  return ((kp / 4) % 2 == 0) ? kp + 4 : kp;
}

// K splits of a product with n columns over lc rows
__host__ __device__ inline int gemm_split(int n, int k, int lc) {
  const int groups = (lc + kRB - 1) / kRB;
  int s = kThreads / (n * groups);
  s = s < 1 ? 1 : (s > kMaxSplit ? kMaxSplit : s);
  return s > k ? k : s;
}

struct Layout {  // offsets in floats into the dynamic shared memory
  int kp, xs, ys, qs, avs, ms, ls, mk, part, r, total;
};

__host__ __device__ inline Layout make_layout(int lc, int ld, int inner, int mult) {
  Layout L;
  L.kp = key_pitch(inner);
  const int f = mult * ld;
  const int dims[4][2] = {{ld, inner}, {inner, ld}, {ld, 2 * f}, {f, ld}};  // (K, N)
  int part = 0;
  for (int g = 0; g < 4; ++g) {
    const int s = gemm_split(dims[g][1], dims[g][0], lc);
    if (s > 1 && s * lc * dims[g][1] > part) part = s * lc * dims[g][1];
  }
  int o = 0;
  L.xs = o;
  o = align4(o + lc * ld);
  L.ys = o;
  o = align4(o + lc * ld);
  L.qs = o;
  o += lc * L.kp;
  L.avs = o;
  o += lc * L.kp;
  L.ms = o;
  o = align4(o + lc);
  L.ls = o;
  o = align4(o + lc);
  L.mk = o;
  o += kTile;
  L.part = o;
  o = align4(o + part);
  L.r = o;
  const int hidden = lc * 2 * f;
  const int tiles = 2 * kTile * L.kp + lc * kTile;
  o += hidden > tiles ? hidden : tiles;
  L.total = o;
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float activation(float g, int gelu) {
  if (gelu) return 0.5f * g * (1.f + erff(g * kInvSqrt2));
  return kSeluScale * (g > 0.f ? g : kSeluAlpha * expm1f(g));
}

// y = (x - mu) * rsqrt(E[x^2] - mu^2 + 1e-5) * s + b, one warp per row
__device__ void layer_norm(const float* x, const float* __restrict__ s,
                           const float* __restrict__ bias, float* y, int lc, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < lc; i += kWarps) {
    const float* xr = x + i * ld;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < ld; c += 32) {
      const float v = xr[c];
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float mu = s1 / ld;
    const float inv = rsqrtf(s2 / ld - mu * mu + 1e-5f);
    for (int c = lane; c < ld; c += 32) y[i * ld + c] = (xr[c] - mu) * inv * s[c] + bias[c];
  }
}

// out[i, n] = sum_k A[i, k] W[k, n] (+ bias[n]) for i < lc, n < N; A in
// shared memory (row pitch ap), W (K, N) row-major in global memory. Ends
// with the block synchronised when K is split, not otherwise.
__device__ void gemm(const float* A, int ap, int K, const float* __restrict__ W,
                     const float* __restrict__ bias, int N, float* out, int op, int lc,
                     float* part) {
  const int groups = (lc + kRB - 1) / kRB;
  const int S = gemm_split(N, K, lc);
  const int kc = (K + S - 1) / S;
  const int items = N * groups * S;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int n = it % N, rest = it / N;
    const int g = rest % groups, s = rest / groups;
    const int i0 = g * kRB, k0 = s * kc, k1 = min(K, k0 + kc);
    float acc[kRB];
#pragma unroll
    for (int r = 0; r < kRB; ++r) acc[r] = 0.f;
    int k = k0;
    for (; k + kUnroll <= k1; k += kUnroll) {  // the loads first: kUnroll in flight
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(W + (size_t)(k + u) * N + n);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int r = 0; r < kRB; ++r)
          if (i0 + r < lc) acc[r] = fmaf(A[(i0 + r) * ap + k + u], w[u], acc[r]);
    }
    for (; k < k1; ++k) {
      const float w = __ldg(W + (size_t)k * N + n);
#pragma unroll
      for (int r = 0; r < kRB; ++r)
        if (i0 + r < lc) acc[r] = fmaf(A[(i0 + r) * ap + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      if (i0 + r >= lc) break;
      if (S == 1) {
        out[(i0 + r) * op + n] = bias ? acc[r] + bias[n] : acc[r];
      } else {
        part[(s * lc + i0 + r) * N + n] = acc[r];
      }
    }
  }
  if (S > 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < lc * N; i += kThreads) {
      const int r = i / N, n = i - r * N;
      float v = 0.f;
      for (int s = 0; s < S; ++s) v += part[(s * lc + r) * N + n];
      out[r * op + n] = bias ? v + bias[n] : v;
    }
  }
}

// one cross-attention of the chain: q (lc x kp, rounded to T, zero padded)
// against modality m's KV at column offset `off`; writes av (lc x kp, f32).
// SR, AR: latent rows a thread holds in the score and @V steps
// (ceil(lc / 4), ceil(lc / 8)); AC: value-column chunks (ceil(inner / 64)):
// template constants, so that no unrolled slot is predicated off.
template <typename T, int SR, int AR, int AC>
__device__ void attention(const Params& p, const Layout& L, float* smem, int b, int m, int off,
                          uint32_t seed) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lc = p.lc, inner = p.inner, kp = L.kp, t_len = p.tokens[m];
  const float* qs = smem + L.qs;
  float* avs = smem + L.avs;
  float* m_s = smem + L.ms;
  float* l_s = smem + L.ls;
  float* mk = smem + L.mk;
  float* ks = smem + L.r;
  float* vs = ks + kTile * kp;
  float* ps = vs + kTile * kp;
  const T* kv = static_cast<const T*>(p.kv[m]) + (size_t)b * p.kv_sb[m] + off;
  const long long st = p.kv_st[m];
  const float* mask = p.mask[m] ? p.mask[m] + (size_t)b * p.mask_sb[m] : nullptr;
  for (int i = tid; i < lc; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  const int sj = tid % kTile, sg = tid / kTile;     // score step: key, row group
  const int vd = tid % kDLanes, vg = tid / kDLanes;  // @V step: column, row group
  float acc[AR][AC];
#pragma unroll
  for (int r = 0; r < AR; ++r)
#pragma unroll
    for (int c = 0; c < AC; ++c) acc[r][c] = 0.f;

  constexpr int NL = kTile * (AC * kDLanes + 4) / kThreads;  // tile elements per thread
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < t_len; k0 += kTile) {
      // every load of the tile is issued before the first store: with one
      // block on the SM, only many loads in flight hide the memory latency
      T k_in[NL], v_in[NL];
#pragma unroll
      for (int u = 0; u < NL; ++u) {
        const int idx = tid + u * kThreads;
        if (idx < kTile * kp) {
          const int j = idx / kp, d = idx - j * kp, key = k0 + j;
          const bool ok = key < t_len && d < inner;
          const T* row = kv + (size_t)(ok ? key : 0) * st;
          k_in[u] = ok ? row[d] : from_float<T>(0.f);
          if (pass) v_in[u] = ok ? row[inner + d] : from_float<T>(0.f);
        }
      }
      const int mkey = k0 + tid;
      const float mtid = tid < kTile && mkey < t_len ? (mask ? mask[mkey] : 1.f) : 0.f;
      __syncthreads();  // the previous tile's readers are done
#pragma unroll
      for (int u = 0; u < NL; ++u) {
        const int idx = tid + u * kThreads;
        if (idx < kTile * kp) {
          ks[idx] = to_float(k_in[u]);
          if (pass) vs[idx] = to_float(v_in[u]);
        }
      }
      if (tid < kTile) mk[tid] = mtid;
      __syncthreads();

      // scores of key sj for rows sg, sg + 4, ... (the same code in both
      // passes, so the second pass reproduces the first's maximum exactly)
      float sc[SR];
#pragma unroll
      for (int r = 0; r < SR; ++r) sc[r] = 0.f;
      const float4* kr = reinterpret_cast<const float4*>(ks + sj * kp);
      for (int d4 = 0; d4 < kp / 4; ++d4) {
        const float4 kk = kr[d4];
#pragma unroll
        for (int r = 0; r < SR; ++r) {
          const int i = sg + r * kScoreGroups;
          if (i < lc) {
            const float4 qq = reinterpret_cast<const float4*>(qs + i * kp)[d4];
            sc[r] = fmaf(qq.x, kk.x, sc[r]);
            sc[r] = fmaf(qq.y, kk.y, sc[r]);
            sc[r] = fmaf(qq.z, kk.z, sc[r]);
            sc[r] = fmaf(qq.w, kk.w, sc[r]);
          }
        }
      }
      const float mj = mk[sj];
#pragma unroll
      for (int r = 0; r < SR; ++r) sc[r] = sc[r] * p.scale + (mj - 1.f) * kNegBig;

      if (pass == 0) {
#pragma unroll
        for (int r = 0; r < SR; ++r) {
          const int i = sg + r * kScoreGroups;
          if (i < lc) ps[i * kTile + sj] = sc[r];
        }
        __syncthreads();
        // running max and sum of each row, one warp per row, 4 keys a lane
        const float4 mv = reinterpret_cast<const float4*>(mk)[lane];
        for (int i = warp; i < lc; i += kWarps) {
          const float4 sv = reinterpret_cast<const float4*>(ps + i * kTile)[lane];
          const float mx = warp_max(fmaxf(fmaxf(sv.x, sv.y), fmaxf(sv.z, sv.w)));
          const float m_old = m_s[i], m_new = fmaxf(m_old, mx);
          const float sum = warp_sum(expf(sv.x - m_new) * mv.x + expf(sv.y - m_new) * mv.y +
                                     expf(sv.z - m_new) * mv.z + expf(sv.w - m_new) * mv.w);
          if (lane == 0) {
            l_s[i] = l_s[i] * expf(m_old - m_new) + sum;
            m_s[i] = m_new;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < SR; ++r) {
          const int i = sg + r * kScoreGroups;
          if (i < lc) {
            float pr = expf(sc[r] - m_s[i]) * mj;
            pr = pr / fmaxf(l_s[i], 1e-30f);
            if (p.dropout) {
              const bool keep = healnet::hash_keep(seed, (uint32_t)b, (uint32_t)i,
                                                   (uint32_t)(k0 + sj), p.threshold);
              pr = keep ? pr * p.keep_scale : 0.f;
            }
            ps[i * kTile + sj] = round_to<T>(pr);
          }
        }
        __syncthreads();
        const int live = min(kTile, t_len - k0);  // keys past the end add zero
        for (int j = 0; j < live; j += 4) {
#pragma unroll
          for (int c = 0; c < AC; ++c) {
            const int d = vd + c * kDLanes;
            if (d < inner) {
              const float v0 = vs[j * kp + d], v1 = vs[(j + 1) * kp + d];
              const float v2 = vs[(j + 2) * kp + d], v3 = vs[(j + 3) * kp + d];
#pragma unroll
              for (int r = 0; r < AR; ++r) {
                const int i = vg + r * kAvGroups;
                if (i < lc) {
                  const float4 pp = reinterpret_cast<const float4*>(ps + i * kTile + j)[0];
                  float a = acc[r][c];
                  a = fmaf(pp.x, v0, a);
                  a = fmaf(pp.y, v1, a);
                  a = fmaf(pp.z, v2, a);
                  acc[r][c] = fmaf(pp.w, v3, a);
                }
              }
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < AR; ++r) {
    const int i = vg + r * kAvGroups;
#pragma unroll
    for (int c = 0; c < AC; ++c) {
      const int d = vd + c * kDLanes;
      if (i < lc && d < inner) avs[i * kp + d] = acc[r][c];
    }
  }
}

template <typename T, int SR, int AR, int AC>
__global__ void __launch_bounds__(kThreads) chain_fwd(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int lc = p.lc, ld = p.ld, inner = p.inner, M = p.n_mod, f = p.mult * ld;
  const Layout L = make_layout(lc, ld, inner, p.mult);
  const int kp = L.kp, n = lc * ld, b = blockIdx.x, tid = threadIdx.x;
  float* xs = smem + L.xs;
  float* ys = smem + L.ys;
  float* qs = smem + L.qs;
  float* part = smem + L.part;
  float* hid = smem + L.r;
  const T* x0 = static_cast<const T*>(p.x0) + (size_t)b * n;
  for (int i = tid; i < n; i += kThreads) xs[i] = to_float(x0[i]);
  __syncthreads();

  for (int l = 0; l < p.depth; ++l) {
    for (int m = 0; m < M; ++m) {
      const int site = l * M + m;
      const float pres = p.presence[b * M + m];
      // ---- attention block
      layer_norm(xs, p.w[kLn1S] + site * ld, p.w[kLn1B] + site * ld, ys, lc, ld);
      __syncthreads();
      gemm(ys, ld, ld, p.w[kWq] + (size_t)site * ld * inner, nullptr, inner, qs, kp, lc, part);
      __syncthreads();
      for (int i = tid; i < lc * kp; i += kThreads) {  // q in the KV dtype, zero padding
        const int d = i % kp;
        qs[i] = d < inner ? round_to<T>(qs[i]) : 0.f;
      }
      __syncthreads();
      attention<T, SR, AR, AC>(p, L, smem, b, m, p.offsets[l], (uint32_t)p.seeds[site]);
      __syncthreads();
      gemm(smem + L.avs, kp, inner, p.w[kWout] + (size_t)site * inner * ld,
           p.w[kBout] + site * ld, ld, ys, ld, lc, part);
      __syncthreads();
      for (int i = tid; i < n; i += kThreads) {
        const float o = ys[i];
        xs[i] = pres * (o >= 0.f ? o : 0.01f * o) + xs[i];
      }
      __syncthreads();
      // ---- feed-forward block
      layer_norm(xs, p.w[kLn2S] + site * ld, p.w[kLn2B] + site * ld, ys, lc, ld);
      __syncthreads();
      gemm(ys, ld, ld, p.w[kW0] + (size_t)site * ld * 2 * f, p.w[kB0] + (size_t)site * 2 * f,
           2 * f, hid, 2 * f, lc, part);
      __syncthreads();
      for (int i = tid; i < lc * f; i += kThreads) {
        const int r = i / f, c = i - r * f;
        hid[r * 2 * f + c] = hid[r * 2 * f + c] * activation(hid[r * 2 * f + f + c], p.gelu);
      }
      __syncthreads();
      gemm(hid, 2 * f, f, p.w[kW2] + (size_t)site * f * ld, p.w[kB2] + site * ld, ld, ys, ld,
           lc, part);
      __syncthreads();
      const float* keep = p.ffk ? p.ffk + ((size_t)b * p.depth * M + site) * n : nullptr;
      for (int i = tid; i < n; i += kThreads) {
        const float h = keep ? ys[i] * keep[i] : ys[i];
        xs[i] = pres * h + xs[i];
      }
      __syncthreads();
    }
  }
  T* out = static_cast<T*>(p.out) + (size_t)b * n;
  for (int i = tid; i < n; i += kThreads) out[i] = from_float<T>(xs[i]);
}

template <typename T, int SR, int AR, int AC>
cudaError_t launch_rows(const Params& p, int B, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)make_layout(p.lc, p.ld, p.inner, p.mult).total;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_fwd<T, SR, AR, AC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  chain_fwd<T, SR, AR, AC><<<B, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// the instantiation for lc (<= 8, <= 20 as at every tuned row, <= 32) and
// inner (<= 64, <= 128)
template <typename T, int AC>
cudaError_t launch_lc(const Params& p, int B, cudaStream_t s) {
  if (p.lc <= 8) return launch_rows<T, 8 / kScoreGroups, 8 / kAvGroups, AC>(p, B, s);
  if (p.lc <= 20)
    return launch_rows<T, (20 + kScoreGroups - 1) / kScoreGroups,
                       (20 + kAvGroups - 1) / kAvGroups, AC>(p, B, s);
  return launch_rows<T, kMaxScoreRows, kMaxAvRows, AC>(p, B, s);
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t s) {
  return p.inner <= kDLanes ? launch_lc<T, 1>(p, B, s) : launch_lc<T, kMaxAvChunks>(p, B, s);
}

}  // namespace

extern "C" long long healnet_chain_smem_bytes(int lc, int ld, int inner, int mult) {
  return (long long)sizeof(float) * make_layout(lc, ld, inner, mult).total;
}

// {max modalities, max depth, max lc, max inner} the kernel takes
extern "C" void healnet_chain_limits(int* out) {
  out[0] = kMaxMod;
  out[1] = kMaxDepth;
  out[2] = kMaxLc;
  out[3] = kMaxInner;
}

extern "C" int healnet_chain_forward(
    const void* x0, void* out, const void* const* kv, const long long* kv_sb,
    const long long* kv_st, const int* tokens, const void* const* mask,
    const long long* mask_sb, const float* ffk, const float* presence, const long long* seeds,
    const void* const* weights, const int* offsets, int B, int depth, int n_mod, int lc, int ld,
    int inner, int mult, int gelu, float scale, int dropout, unsigned int threshold,
    float keep_scale, int is_bf16, void* stream) {
  if (n_mod > kMaxMod || depth > kMaxDepth || lc > kMaxLc || inner > kMaxInner || n_mod < 1 ||
      depth < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || lc <= 0) return 0;
  Params p = {};
  p.x0 = x0;
  p.out = out;
  for (int m = 0; m < n_mod; ++m) {
    p.kv[m] = kv[m];
    p.kv_sb[m] = kv_sb[m];
    p.kv_st[m] = kv_st[m];
    p.tokens[m] = tokens[m];
    p.mask[m] = static_cast<const float*>(mask[m]);
    p.mask_sb[m] = mask_sb[m];
  }
  p.ffk = ffk;
  p.presence = presence;
  p.seeds = seeds;
  for (int i = 0; i < kFields; ++i) p.w[i] = static_cast<const float*>(weights[i]);
  for (int l = 0; l < depth; ++l) p.offsets[l] = offsets[l];
  p.depth = depth;
  p.n_mod = n_mod;
  p.lc = lc;
  p.ld = ld;
  p.inner = inner;
  p.mult = mult;
  p.gelu = gelu;
  p.scale = scale;
  p.dropout = dropout;
  p.threshold = threshold;
  p.keep_scale = keep_scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e = is_bf16 ? launch<__nv_bfloat16>(p, B, s) : launch<float>(p, B, s);
  return static_cast<int>(e);
}

extern "C" const char* healnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
