// Fused latent chain, forward: every (layer, modality) block of the HealNet
// fusion loop in one launch, one thread-block cluster per batch element.
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
// against 0.5 GFLOP. The TPU kernel's grid (one block per batch element)
// put 8 of 132 SMs to work; here a cluster of `cluster` blocks (16 at
// brca; ops/fused_chain.py::chain_plan sizes it from the cluster occupancy)
// shares each batch element, all products f32 FMA on the CUDA cores. It
// stays far above its bound: a site is some 13 phases, each a short chain
// of dependent latencies over a few thousand FMAs a block, and seven of them
// end at a cluster barrier that waits for the slowest block (PERF.md has
// the breakdown of scripts/profile_chain_phases.py). What the design does:
//   - keys: block r owns keys [r * kpb, (r + 1) * kpb) of each modality
//     (kpb a multiple of the 64-key tile; a block may own none). It streams
//     its K rows once (element loads into an aligned f32 tile, the next
//     tile's loads in registers while this one is computed: the rows sit at
//     odd element offsets, which no 16-byte copy or TMA takes), keeps the
//     scores in shared memory with its rows' (max, sum), and pushes those to
//     every block of the cluster (st.shared::cluster). After one cluster
//     barrier every block merges them in rank order, so all hold the same
//     (max, sum) bit for bit; an empty range pushes (-inf, 0), which the
//     merge skips. The block forms its probabilities from the stored scores
//     (the absolute key index in the dropout hash), streams its V rows and
//     sends its partial @V sums, column by column, to the block that owns
//     the column; that block adds them in rank order and writes the sum to
//     every block. A range longer than the score buffer (chunk keys, at
//     most 512) takes chunks, and then the second pass recomputes each
//     chunk's scores with the same code;
//   - the latent-side products split over the cluster: q, the out
//     projection and the FF's first product by output column (an FF column
//     c and its value column c + F on one block, so the gating stays
//     local), each element computed by one block in one fixed k-order (a K
//     split inside the block adds its partial sums in split order) with its
//     epilogue (rounding, residual) there; q and x are then stored into
//     every block's copy. The FF's second product splits by K instead: each
//     block multiplies its own F columns of the hidden state (never
//     exchanged) and sends the partial sums of each output column to the
//     block that owns it, which adds them in rank order. So the latents
//     stay identical across the cluster, and two calls give the same bits:
//     no float atomics anywhere;
//   - LN1 and LN2 run on every block (17 x 126 at brca); seven cluster
//     barriers a site (q, (max, sum), partial @V, @V, out, FF partials, x);
//   - 256 threads, at most 128 registers and, at brca, 91 KB of shared
//     memory a block, so two blocks fit an SM and 8 clusters of 16 are
//     resident at once (at one block an SM only 7 GPCs take a 16-cluster).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tc.cuh"
#include "hash_dropout.cuh"

namespace {

namespace tc = healnet::tc;
namespace cg = cooperative_groups;

constexpr int kThreads = tc::kThreads;  // 256: launch_clustered's block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLc = 32;
constexpr int kTile = 64;       // keys per tile; lane l takes keys l and l + 32
constexpr int kRB = 9;          // rows per item of the products
constexpr int kMaxSplit = 16;   // K splits of a product inside a block
constexpr int kMaxMod = 4;
constexpr int kMaxDepth = 16;
constexpr int kMaxInner = 128;
constexpr int kUnroll = 8;      // weights in flight per product item
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
  int kpb[kMaxMod];  // keys a block owns, per modality
  const float* mask[kMaxMod];  // (B, t_m) f32 or null
  long long mask_sb[kMaxMod];
  const float* ffk;        // (B, L * M, lc, ld) f32 or null
  const float* presence;   // (B, M) f32
  const long long* seeds;  // (L, M) 32-bit patterns held in int64
  const float* w[kFields];
  int offsets[kMaxDepth];
  int depth, n_mod, lc, ld, inner, mult, gelu, chunk;
  float scale;
  int dropout;
  uint32_t threshold;
  float keep_scale;
};

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// row pitch of q, av and the key/value tiles: a multiple of 4 floats whose
// quarter is odd, so the float4 reads of 8 neighbouring rows hit 32 banks
__host__ __device__ inline int key_pitch(int inner) {
  const int kp = align4(inner);
  return ((kp / 4) % 2 == 0) ? kp + 4 : kp;
}

// K splits of a product of wc columns (a block's share) over lc rows
__host__ __device__ inline int gemm_split(int wc, int k, int lc) {
  if (wc <= 0 || k <= 0) return 1;
  const int groups = cdiv(lc, kRB);
  int s = kThreads / (wc * groups);
  s = s < 1 ? 1 : (s > kMaxSplit ? kMaxSplit : s);
  return s > k ? k : s;
}

struct Layout {  // offsets in floats into the dynamic shared memory
  int kp, xs, ys, qs, avs, ml, ms, ls, pbuf, part, r, total;
};

// cs: the cluster's size; chunk: the keys whose scores a block holds at once
__host__ __device__ inline Layout make_layout(int lc, int ld, int inner, int mult, int cs,
                                              int chunk) {
  Layout L;
  L.kp = key_pitch(inner);
  const int f = mult * ld;
  const int wa = cdiv(inner, cs), wl = cdiv(ld, cs), wf = cdiv(f, cs);
  // (K, columns of a block, values an item) of q, out, FF first, FF second
  const int dims[4][3] = {{ld, wa, 1}, {inner, wl, 1}, {ld, wf, 2}, {wf, ld, 1}};
  int part = 0;
  for (int g = 0; g < 4; ++g) {
    const int s = gemm_split(dims[g][1], dims[g][0], lc);
    const int need = s > 1 ? s * lc * dims[g][1] * dims[g][2] : 0;
    part = need > part ? need : part;
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
  L.ml = o;  // (max, sum) pushed by every block: [rank][row][2]
  o = align4(o + 2 * cs * lc);
  L.ms = o;
  o = align4(o + lc);
  L.ls = o;
  o = align4(o + lc);
  // partial sums of this block's columns of @V (inner) and of the FF's
  // second product (ld), from every block: [rank][row][column]
  L.pbuf = o;
  o = align4(o + cs * lc * (wa > wl ? wa : wl));
  L.part = o;
  o = align4(o + part);
  L.r = o;  // scores, mask and a key tile; the block's FF columns (lc x F / cs)
  const int attn = lc * chunk + chunk + kTile * L.kp;
  o += lc * wf > attn ? lc * wf : attn;
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

// v at p's place in the shared memory of every block of the cluster
__device__ __forceinline__ void put_all(float* p, int cs, float v) {
  for (int r = 0; r < cs; ++r) tc::st_cluster(p, r, v);
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

// Columns [n0, n1) of A W (+ bias) over lc rows: A in shared memory (row
// pitch ap, K columns), W (K x N) row-major in global memory. epi(i, n, v,
// v2) takes each element; with PAIR, v2 is column n + pair of the same
// product (the FF's value half), else 0. An item is one column for kRB
// rows over a K split; with more than one split the partial sums go through
// `part` and are added in split order. The column range is the same for
// every thread of the block.
template <bool PAIR, typename Epi>
__device__ void gemm_cols(const float* A, int ap, int K, const float* __restrict__ W, int N,
                          const float* __restrict__ bias, int n0, int n1, int pair, int lc,
                          float* part, Epi epi) {
  constexpr int NP = PAIR ? 2 : 1;
  const int wc = n1 - n0;
  if (wc <= 0) return;
  const int groups = cdiv(lc, kRB);
  const int S = gemm_split(wc, K, lc);
  const int kc = cdiv(K, S);
  const int items = wc * groups * S;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int c = it % wc, rest = it / wc;
    const int n = n0 + c, g = rest % groups, s = rest / groups;
    const int i0 = g * kRB, k0 = s * kc, k1 = min(K, k0 + kc);
    float acc[NP][kRB];
#pragma unroll
    for (int q = 0; q < NP; ++q)
#pragma unroll
      for (int r = 0; r < kRB; ++r) acc[q][r] = 0.f;
    int k = k0;
    for (; k + kUnroll <= k1; k += kUnroll) {  // the loads first: kUnroll in flight
      float w[NP][kUnroll];
#pragma unroll
      for (int q = 0; q < NP; ++q)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) w[q][u] = __ldg(W + (size_t)(k + u) * N + n + q * pair);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int r = 0; r < kRB; ++r)
          if (i0 + r < lc) {
            const float a = A[(i0 + r) * ap + k + u];
#pragma unroll
            for (int q = 0; q < NP; ++q) acc[q][r] = fmaf(a, w[q][u], acc[q][r]);
          }
    }
    for (; k < k1; ++k) {
      float w[NP];
#pragma unroll
      for (int q = 0; q < NP; ++q) w[q] = __ldg(W + (size_t)k * N + n + q * pair);
#pragma unroll
      for (int r = 0; r < kRB; ++r)
        if (i0 + r < lc) {
          const float a = A[(i0 + r) * ap + k];
#pragma unroll
          for (int q = 0; q < NP; ++q) acc[q][r] = fmaf(a, w[q], acc[q][r]);
        }
    }
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      if (i0 + r >= lc) break;
      if (S == 1) {
        const float v = bias ? acc[0][r] + bias[n] : acc[0][r];
        const float v2 = PAIR ? acc[NP - 1][r] + bias[n + pair] : 0.f;
        epi(i0 + r, n, v, v2);
      } else {
#pragma unroll
        for (int q = 0; q < NP; ++q) part[((s * lc + i0 + r) * wc + c) * NP + q] = acc[q][r];
      }
    }
  }
  if (S > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < lc * wc; e += kThreads) {
      const int i = e / wc, c = e - i * wc, n = n0 + c;
      float v[NP];
#pragma unroll
      for (int q = 0; q < NP; ++q) v[q] = 0.f;
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int q = 0; q < NP; ++q) v[q] += part[((s * lc + i) * wc + c) * NP + q];
      epi(i, n, bias ? v[0] + bias[n] : v[0], PAIR ? v[NP - 1] + bias[n + pair] : 0.f);
    }
  }
}

// A tile of kTile key rows (K or V columns of the merged KV, `inner` wide)
// in registers: loaded while the previous tile is computed, then stored
// into an aligned f32 tile (pitch kp, columns inner..kp-1 and keys at or
// past kend zero). NL covers kTile rows at the largest pitch of AC.
template <typename T, int AC>
struct TileLoad {
  static constexpr int NL = (kTile * (32 * AC + 4) + kThreads - 1) / kThreads;
  T v[NL];

  __device__ __forceinline__ void load(const T* base, long long st, int k0, int kend, int inner,
                                       int kp) {
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      const int idx = threadIdx.x + u * kThreads, j = idx / kp, d = idx - j * kp;
      const bool ok = idx < kTile * kp && k0 + j < kend && d < inner;
      v[u] = ok ? base[(size_t)(k0 + j) * st + d] : from_float<T>(0.f);
    }
  }

  __device__ __forceinline__ void store(float* tile, int kp) const {
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      if (idx < kTile * kp) tile[idx] = to_float(v[u]);
    }
  }
};

// The scores of keys [c0, c0 + cn) (cn <= chunk) of the block's range into
// sc (row i at i * chunk), their mask values into mk (0 past the end).
// Row i belongs to warp i % 8 (slot i / 8), keys j and j + 32 of a tile to
// lane j. The same code in both passes, so a recomputed chunk is the same.
template <typename T, int NS, int AC>
__device__ void score_chunk(const float* qs, float* sc, float* mk, float* tile, const T* kbase,
                            long long st, const float* mask, int c0, int cn, int chunk, int lc,
                            int inner, int kp, float scale) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, kend = c0 + cn;
  TileLoad<T, AC> ld;
  ld.load(kbase, st, c0, kend, inner, kp);
  for (int t0 = 0; t0 < cn; t0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    ld.store(tile, kp);
    if (tid < kTile) {
      const int key = c0 + t0 + tid;
      mk[t0 + tid] = key < kend ? (mask ? mask[key] : 1.f) : 0.f;
    }
    __syncthreads();
    if (t0 + kTile < cn) ld.load(kbase, st, c0 + t0 + kTile, kend, inner, kp);
    float s[NS][2];
#pragma unroll
    for (int r = 0; r < NS; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k0r = tile + lane * kp;
    const float* k1r = tile + (lane + 32) * kp;
#pragma unroll 4
    for (int c = 0; c < kp; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(k0r + c);
      const float4 b = *reinterpret_cast<const float4*>(k1r + c);
#pragma unroll
      for (int r = 0; r < NS; ++r) {
        const int i = warp + kWarps * r;
        if (i < lc) {
          const float4 q = *reinterpret_cast<const float4*>(qs + i * kp + c);
          float x = s[r][0], y = s[r][1];
          x = fmaf(q.x, a.x, x);
          x = fmaf(q.y, a.y, x);
          x = fmaf(q.z, a.z, x);
          x = fmaf(q.w, a.w, x);
          y = fmaf(q.x, b.x, y);
          y = fmaf(q.y, b.y, y);
          y = fmaf(q.z, b.z, y);
          y = fmaf(q.w, b.w, y);
          s[r][0] = x, s[r][1] = y;
        }
      }
    }
    const float m0 = mk[t0 + lane], m1 = mk[t0 + lane + 32];
#pragma unroll
    for (int r = 0; r < NS; ++r) {
      const int i = warp + kWarps * r;
      if (i < lc) {
        sc[i * chunk + t0 + lane] = s[r][0] * scale + (m0 - 1.f) * kNegBig;
        sc[i * chunk + t0 + lane + 32] = s[r][1] * scale + (m1 - 1.f) * kNegBig;
      }
    }
  }
  __syncthreads();
}

// One cross-attention of the chain: q (lc x kp in qs, rounded to T, zero
// padded) against the block's keys of modality m's KV at column offset
// `off`; ends with this block's partial @V sums stored into the pav of the
// blocks that own their columns, in pbuf (visible after the next cluster barrier).
template <typename T, int NS, int AC>
__device__ void attention(const Params& p, const Layout& L, float* smem, int b, int m, int off,
                          uint32_t seed, int rank, int cs, cg::cluster_group& cluster) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lc = p.lc, inner = p.inner, kp = L.kp, chunk = p.chunk;
  const int kb = rank * p.kpb[m], ke = min(p.tokens[m], kb + p.kpb[m]);
  const float* qs = smem + L.qs;
  float* ml = smem + L.ml;
  float* m_s = smem + L.ms;
  float* l_s = smem + L.ls;
  float* sc = smem + L.r;
  float* mk = sc + lc * chunk;
  float* tile = mk + chunk;
  const T* kv = static_cast<const T*>(p.kv[m]) + (size_t)b * p.kv_sb[m] + off;
  const long long st = p.kv_st[m];
  const float* mask = p.mask[m] ? p.mask[m] + (size_t)b * p.mask_sb[m] : nullptr;
  const int chunks = ke > kb ? cdiv(ke - kb, chunk) : 0;

  // pass 1: the scores, and each row's running max and sum over the range
  for (int i = tid; i < lc; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  for (int c0 = kb; c0 < ke; c0 += chunk) {
    const int cn = min(chunk, ke - c0);
    score_chunk<T, NS, AC>(qs, sc, mk, tile, kv, st, mask, c0, cn, chunk, lc, inner, kp,
                           p.scale);
    for (int i = warp; i < lc; i += kWarps) {
      const float* row = sc + i * chunk;
      float mx = -INFINITY;
      for (int j = lane; j < cn; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_old = m_s[i], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < cn; j += 32) sum += expf(row[j] - m_new) * mk[j];
      sum = warp_sum(sum);
      if (lane == 0) {
        l_s[i] = l_s[i] * expf(m_old - m_new) + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();
  }
  // every block's (max, sum) to every block, merged in rank order
  for (int e = tid; e < lc * cs; e += kThreads) {
    const int i = e % lc, r = e / lc;
    tc::st_cluster(ml + 2 * (rank * lc + i), r, m_s[i]);
    tc::st_cluster(ml + 2 * (rank * lc + i) + 1, r, l_s[i]);
  }
  cluster.sync();
  for (int i = tid; i < lc; i += kThreads) {
    float mx = -INFINITY;
    for (int r = 0; r < cs; ++r) mx = fmaxf(mx, ml[2 * (r * lc + i)]);
    float l = 0.f;
    for (int r = 0; r < cs; ++r) {
      const float mr = ml[2 * (r * lc + i)];
      if (mr != -INFINITY) l += ml[2 * (r * lc + i) + 1] * expf(mr - mx);
    }
    m_s[i] = mx;
    l_s[i] = fmaxf(l, 1e-30f);
  }
  __syncthreads();

  // pass 2: the dropped probabilities, rounded to T, and @V
  float acc[NS][AC];
#pragma unroll
  for (int r = 0; r < NS; ++r)
#pragma unroll
    for (int c = 0; c < AC; ++c) acc[r][c] = 0.f;
  for (int c0 = kb; c0 < ke; c0 += chunk) {
    const int cn = min(chunk, ke - c0), cw = cdiv(cn, kTile) * kTile;
    if (chunks > 1)
      score_chunk<T, NS, AC>(qs, sc, mk, tile, kv, st, mask, c0, cn, chunk, lc, inner, kp,
                             p.scale);
    for (int e = tid; e < lc * cw; e += kThreads) {
      const int i = e / cw, j = e - i * cw;
      float pr = 0.f;
      if (j < cn) {
        pr = expf(sc[i * chunk + j] - m_s[i]) * mk[j];
        pr = pr / l_s[i];
        if (p.dropout) {
          const bool keep = healnet::hash_keep(seed, (uint32_t)b, (uint32_t)i,
                                               (uint32_t)(c0 + j), p.threshold);
          pr = keep ? pr * p.keep_scale : 0.f;
        }
      }
      sc[i * chunk + j] = round_to<T>(pr);
    }
    TileLoad<T, AC> ld;
    ld.load(kv + inner, st, c0, c0 + cn, inner, kp);
    for (int t0 = 0; t0 < cn; t0 += kTile) {
      __syncthreads();  // the probabilities are formed; the previous tile's readers done
      ld.store(tile, kp);
      __syncthreads();
      if (t0 + kTile < cn) ld.load(kv + inner, st, c0 + t0 + kTile, c0 + cn, inner, kp);
      const int live = min(kTile, align4(cn - t0));  // past cn: zero probability, zero V
      for (int j = 0; j < live; j += 4) {
        float4 pp[NS];
#pragma unroll
        for (int r = 0; r < NS; ++r) {
          const int i = warp + kWarps * r;
          pp[r] = i < lc ? *reinterpret_cast<const float4*>(sc + i * chunk + t0 + j)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int c = 0; c < AC; ++c) {
          const int d = lane + 32 * c;
          if (d < inner) {
            const float v0 = tile[j * kp + d], v1 = tile[(j + 1) * kp + d];
            const float v2 = tile[(j + 2) * kp + d], v3 = tile[(j + 3) * kp + d];
#pragma unroll
            for (int r = 0; r < NS; ++r) {
              float a = acc[r][c];
              a = fmaf(pp[r].x, v0, a);
              a = fmaf(pp[r].y, v1, a);
              a = fmaf(pp[r].z, v2, a);
              acc[r][c] = fmaf(pp[r].w, v3, a);
            }
          }
        }
      }
    }
    __syncthreads();  // the chunk's readers are done before the next one's scores
  }
  // the partial sums of column d to the block that owns it, at this rank's slot
  const int wa = cdiv(inner, cs);
#pragma unroll
  for (int r = 0; r < NS; ++r) {
    const int i = warp + kWarps * r;
#pragma unroll
    for (int c = 0; c < AC; ++c) {
      const int d = lane + 32 * c;
      if (i < lc && d < inner) {
        const int owner = d / wa;
        tc::st_cluster(smem + L.pbuf + (rank * lc + i) * wa + d - owner * wa, owner, acc[r][c]);
      }
    }
  }
}

template <typename T, int NS, int AC>
__global__ void __launch_bounds__(kThreads, 2) chain_fwd(Params p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int lc = p.lc, ld = p.ld, inner = p.inner, M = p.n_mod, f = p.mult * ld;
  const Layout L = make_layout(lc, ld, inner, p.mult, cs, p.chunk);
  const int kp = L.kp, n = lc * ld, b = blockIdx.y, tid = threadIdx.x;
  float* xs = smem + L.xs;
  float* ys = smem + L.ys;
  float* qs = smem + L.qs;
  float* avs = smem + L.avs;
  float* part = smem + L.part;
  float* hid = smem + L.r;
  float* pbuf = smem + L.pbuf;
  // each block's share of the columns of q and av (inner), of the out and
  // FF-second products (ld) and of the FF's gated columns (F)
  const int wq = cdiv(inner, cs), wl = cdiv(ld, cs), wf = cdiv(f, cs);
  const int q0 = min(inner, rank * wq), q1 = min(inner, q0 + wq);
  const int l0 = min(ld, rank * wl), l1 = min(ld, l0 + wl);
  const int f0 = min(f, rank * wf), f1 = min(f, f0 + wf);
  const T* x0 = static_cast<const T*>(p.x0) + (size_t)b * n;
  for (int i = tid; i < n; i += kThreads) xs[i] = to_float(x0[i]);
  for (int i = tid; i < lc * kp; i += kThreads) qs[i] = 0.f;  // the padding stays zero
  cluster.sync();  // every block runs before the first remote store

  for (int l = 0; l < p.depth; ++l) {
    for (int m = 0; m < M; ++m) {
      const int site = l * M + m;
      const float pres = p.presence[b * M + m];
      // ---- attention block
      layer_norm(xs, p.w[kLn1S] + site * ld, p.w[kLn1B] + site * ld, ys, lc, ld);
      __syncthreads();
      gemm_cols<false>(ys, ld, ld, p.w[kWq] + (size_t)site * ld * inner, inner, nullptr, q0, q1,
                       0, lc, part, [&](int i, int c, float v, float) {
                         put_all(qs + i * kp + c, cs, round_to<T>(v));  // q in the KV dtype
                       });
      cluster.sync();
      attention<T, NS, AC>(p, L, smem, b, m, p.offsets[l], (uint32_t)p.seeds[site], rank, cs,
                           cluster);
      cluster.sync();
      for (int e = tid; e < lc * (q1 - q0); e += kThreads) {  // this block's av columns
        const int i = e / (q1 - q0), c = e - i * (q1 - q0);
        float v = 0.f;
        for (int r = 0; r < cs; ++r) v += pbuf[(r * lc + i) * wq + c];
        put_all(avs + i * kp + q0 + c, cs, v);
      }
      cluster.sync();
      gemm_cols<false>(avs, kp, inner, p.w[kWout] + (size_t)site * inner * ld, ld,
                       p.w[kBout] + site * ld, l0, l1, 0, lc, part,
                       [&](int i, int c, float o, float) {
                         put_all(xs + i * ld + c, cs,
                                 pres * (o >= 0.f ? o : 0.01f * o) + xs[i * ld + c]);
                       });
      cluster.sync();
      // ---- feed-forward block
      layer_norm(xs, p.w[kLn2S] + site * ld, p.w[kLn2B] + site * ld, ys, lc, ld);
      __syncthreads();
      gemm_cols<true>(ys, ld, ld, p.w[kW0] + (size_t)site * ld * 2 * f, 2 * f,
                      p.w[kB0] + (size_t)site * 2 * f, f0, f1, f, lc, part,
                      [&](int i, int c, float g, float v) {
                        hid[i * wf + c - f0] = g * activation(v, p.gelu);
                      });
      __syncthreads();
      // this block's F columns' share of the second product, to the blocks
      // that own its output columns
      gemm_cols<false>(hid, wf, f1 - f0, p.w[kW2] + ((size_t)site * f + f0) * ld, ld, nullptr, 0,
                       ld, 0, lc, part, [&](int i, int c, float h, float) {
                         const int owner = c / wl;
                         tc::st_cluster(pbuf + (rank * lc + i) * wl + c - owner * wl, owner, h);
                       });
      cluster.sync();
      const float* keep = p.ffk ? p.ffk + ((size_t)b * p.depth * M + site) * n : nullptr;
      for (int e = tid; e < lc * (l1 - l0); e += kThreads) {  // this block's x columns
        const int i = e / (l1 - l0), c = l0 + e - i * (l1 - l0);
        float h = 0.f;
        for (int r = 0; r < cs; ++r) h += pbuf[(r * lc + i) * wl + c - l0];
        h += p.w[kB2][site * ld + c];
        if (keep) h *= keep[i * ld + c];
        put_all(xs + i * ld + c, cs, pres * h + xs[i * ld + c]);
      }
      cluster.sync();
    }
  }
  T* out = static_cast<T*>(p.out) + (size_t)b * n;
  const int share = cdiv(n, cs);
  for (int i = rank * share + tid; i < min(n, (rank + 1) * share); i += kThreads)
    out[i] = from_float<T>(xs[i]);
}

// the instantiation for lc (<= 24 as at every tuned row, <= 32) and inner
// (<= 64, <= 128): template constants, so that no unrolled slot is
// predicated off at the tuned rows
template <typename Fn>
auto with_kernel(int lc, int inner, int is_bf16, Fn&& fn) {
  using B = __nv_bfloat16;
  if (is_bf16) {
    if (lc <= 24) return inner <= 64 ? fn(chain_fwd<B, 3, 2>) : fn(chain_fwd<B, 3, 4>);
    return inner <= 64 ? fn(chain_fwd<B, 4, 2>) : fn(chain_fwd<B, 4, 4>);
  }
  if (lc <= 24) return inner <= 64 ? fn(chain_fwd<float, 3, 2>) : fn(chain_fwd<float, 3, 4>);
  return inner <= 64 ? fn(chain_fwd<float, 4, 2>) : fn(chain_fwd<float, 4, 4>);
}

size_t smem_bytes(int lc, int ld, int inner, int mult, int cluster, int chunk) {
  return sizeof(float) * (size_t)make_layout(lc, ld, inner, mult, cluster, chunk).total;
}

}  // namespace

// shared memory of a block at this shape, cluster size and score chunk
extern "C" long long healnet_chain_smem_bytes(int lc, int ld, int inner, int mult, int cluster,
                                              int chunk) {
  return (long long)smem_bytes(lc, ld, inner, mult, cluster, chunk);
}

// Clusters of `cluster` blocks the card holds at once at this shape (-1
// where the query fails)
extern "C" int healnet_chain_max_clusters(int lc, int ld, int inner, int mult, int cluster,
                                          int chunk, int is_bf16) {
  const size_t smem = smem_bytes(lc, ld, inner, mult, cluster, chunk);
  return with_kernel(lc, inner, is_bf16, [&](auto kern) {
    return tc::max_active_clusters(kern, cluster, smem);
  });
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
    const void* const* weights, const int* offsets, const int* keys_per_block, int B, int depth,
    int n_mod, int lc, int ld, int inner, int mult, int gelu, int cluster, int chunk,
    float scale, int dropout, unsigned int threshold, float keep_scale, int is_bf16,
    void* stream) {
  if (n_mod > kMaxMod || depth > kMaxDepth || lc > kMaxLc || inner > kMaxInner || n_mod < 1 ||
      depth < 1 || cluster < 1 || cluster > tc::kMaxCluster || chunk < kTile ||
      chunk % kTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || lc <= 0) return 0;
  Params p = {};
  p.x0 = x0;
  p.out = out;
  for (int m = 0; m < n_mod; ++m) {
    if (keys_per_block[m] % kTile != 0 || (long long)keys_per_block[m] * cluster < tokens[m])
      return static_cast<int>(cudaErrorInvalidValue);
    p.kv[m] = kv[m];
    p.kv_sb[m] = kv_sb[m];
    p.kv_st[m] = kv_st[m];
    p.tokens[m] = tokens[m];
    p.kpb[m] = keys_per_block[m];
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
  p.chunk = chunk;
  p.scale = scale;
  p.dropout = dropout;
  p.threshold = threshold;
  p.keep_scale = keep_scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(lc, ld, inner, mult, cluster, chunk);
  const cudaError_t e = with_kernel(lc, inner, is_bf16, [&](auto kern) {
    return tc::launch_clustered(kern, p, cluster, B, smem, s);
  });
  return static_cast<int>(e);
}

extern "C" const char* healnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
