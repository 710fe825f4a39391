// Flash cross-attention forward: online softmax over KV tiles, with the
// scale/temperature folded in, a float key mask, and coordinate-hash dropout
// on the normalised probabilities.
//
// Replaces: healnet_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas
// kernel launched by _fwd_call). Forward only.
//
// Semantics kept from the TPU kernel:
//   - a masked key scores s * scale - 1e30 and its probability is multiplied
//     by the mask, so a fully masked tile contributes exactly zero;
//   - the softmax denominator is taken before dropout; dropout multiplies the
//     probability by keep / (1 - rate), keep from hash_keep over the absolute
//     coordinates (batch*head row, query, key);
//   - probabilities are rounded to the value dtype before the product with V;
//   - the output divides by max(l, 1e-30): a row whose keys are all masked
//     outputs 0. The per-row log-sum-exp is written beside the output.
//
// Bound on an H100 SXM at the serving shape (b*h = 8, lq = 17, lkv = 4096,
// d = 63, bf16): 8.3 MB of K and V, about 2.5 us at 3.35 TB/s, against
// 0.14 GFLOP (0.14 us of bf16 tensor-core time). Eight (batch*head) rows
// are far fewer than the 132 SMs, and each row's keys must be split over
// blocks to use the card: the time is latency, of the loads, of each
// tile's chain of dependent steps, and of the merge of a row's splits.
// The operands are not too small for the tensor cores: 17 queries pad to
// two m16 tiles, 63 (27, 20, 113) to a multiple of 16.
//
// Two variants, chosen by the wrapper from the dtype and d before launch:
//
// flash_fwd_tc (bf16, d <= 128; the model's path). One launch per call:
// grid (cluster, rows), one thread-block cluster per batch*head row, each
// block owning a contiguous range of keys (flash_plan in
// ops/flash_attention.py sizes the cluster so that every SM holds a block).
// A block streams 64-key tiles through a cp.async ring of up to 4 stages
// (flash_tc.cuh: the K and V slices sit at 2-byte-aligned offsets of the
// merged KV buffer, so each row is copied as its 16-byte-aligned hull and
// shifted into an aligned tile) and computes S = Q K^T and O += P V with
// mma.sync m16n8k16 (bf16 in, f32 accumulate): lq pads to 16-row query
// tiles (the block loops over groups of 32 queries), d to a multiple of
// 16, with zeros in shared memory only. Each warp owns 16 keys of every
// tile and keeps its own (m, l, acc) in registers; P goes from S's
// accumulator fragments straight into the A fragments of the value product
// (the FlashAttention-2 register layout). At the end the warps' states
// merge in warp order in shared memory, and each block pushes its (m, l)
// to every block of the cluster and its acc of each output element to the
// block that owns the element (distributed shared memory stores); after
// one cluster barrier each block merges its elements in rank order from
// its own shared memory and writes them with the log-sum-exp: no partial
// buffer in device memory, no second kernel, no float atomics, and the
// same bits on every call.
//
// flash_fwd_fma (f32, and bf16 with d > 128): tensor cores would mean TF32
// for f32 and break its 2e-5 contract, so the products are f32 FMAs on the
// CUDA cores. One launch per call on the same skeleton: one cluster per
// row, each block owning a contiguous range of keys (flash_plan, sized by
// this kernel's own occupancy), streamed in tiles of 32 keys through a
// cp.async ring of 16-byte hull copies (flash_tc.cuh, fmav), each tile
// shifted into an aligned f32 tile while the one before it is computed.
// Each query row of a group of 32 is owned by one warp (row r by warp
// r % 8), so its online softmax needs only warp shuffles and one block
// barrier a tile, for the ring and the aligned tiles: each lane takes one
// key for the scores (a float4 of its key row against broadcast float4s of
// the warp's query rows), the softmax state stays in registers, p goes to
// the warp's rows in shared memory, and acc += p V takes a lane's channels
// of each value row as one vector load. At the end the blocks' (m, l, acc) merge
// across the cluster in rank order through distributed shared memory, as
// in flash_fwd_tc: no partial buffer, no second kernel, the same bits on
// every call. Any lq: the block walks the queries in groups of 32. Heads
// wider than 256 take the kernels of flash_wide.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"
#include "hash_dropout.cuh"

namespace {

namespace tc = healnet::tc;
namespace fv = healnet::tc::fmav;

// ---------------------------------------------- FMA variant (f32 compute)

struct FmaParams {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;  // (B, lkv) or null
  void* out;          // (B, lq, H, d)
  float* lse;         // (B*H, lq)
  int H, lq, lkv, d, keys_per_cta, stages;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, mask_sb;
  float scale;
  int dropout;
  const uint32_t* seed;  // the 32-bit hash seed, in device memory (read once a block)
  uint32_t threshold;
  float keep_scale;
};

// Byte offsets into the block's shared memory: the ring's stages (none
// where the slice takes no ring), two aligned tiles, the group's query
// rows, the warps' p rows and the cluster's pushed states.
template <typename T, int DP>
struct FmaFwdLayout {
  size_t tiles, qs, ps, rm, rl, racc, total;
  __host__ __device__ explicit FmaFwdLayout(int stages) {
    using S = fv::Shape<T, DP>;
    tiles = sizeof(float) * (size_t)stages * S::kTileFloats;
    qs = tiles + sizeof(float) * 2 * S::kTileFloats;
    ps = qs + sizeof(float) * fv::kGroup * S::kPitch;
    rm = ps + sizeof(float) * fv::kGroup * fv::kKeys;
    rl = rm + sizeof(float) * tc::kMaxCluster * fv::kGroup;
    racc = rl + sizeof(float) * tc::kMaxCluster * fv::kGroup;
    total = racc + sizeof(float) * (fv::kGroup * DP + tc::kMaxCluster);
  }
};

template <typename T, int DP>
int fma_fwd_stages() {
  return fv::ring_stages<T, DP>([](int s) { return FmaFwdLayout<T, DP>(s).total; });
}

// The key loop of one query group for a warp that owns NS of its rows.
// Tile it's interval, after its one block barrier: the ring issues tile
// it + stages, tile it + 1 is shifted into the other aligned tile, and the
// warp takes scores of its rows against the lane's key, the online softmax
// with warp shuffles, p (dropped, rounded to T) into its rows of ps, and
// acc += p V over the lane's channels. (m, the lane's part of l, acc) stay
// in registers; at the end they are pushed to the cluster.
template <typename T, int DP, int NS>
__device__ __forceinline__ void fwd_group(const FmaParams& p, uint32_t seed,
                                          const fv::RingCopies<T, DP>& rc,
                                          float* raw, float* tiles,
                                          const float* qs, float* ps, float* rm, float* rl,
                                          float* racc, const T* k, const T* v, const float* mask,
                                          int row, int g0, int nq, int kv_begin, int kv_end,
                                          int ntiles, int rank, int csize) {
  using S = fv::Shape<T, DP>;
  constexpr int KT = fv::kKeys, P = S::kPitch, TF = S::kTileFloats, CPL = S::kChPerLane;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, St = p.stages;
  float* pw = ps + warp * fv::kSlots * KT;  // the warp's p rows [slot][key]
  float m[NS > 0 ? NS : 1], l[NS > 0 ? NS : 1], a[NS > 0 ? NS : 1][CPL];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    m[s] = tc::kNegBig, l[s] = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) a[s][i] = 0.f;
  }
  for (int it = 0; it < ntiles; ++it) {
    if constexpr (S::kRing) tc::cp_async_wait(St - 2);
    // tile it is unpacked and tile it + 1 has landed; every warp is done
    // with tile it - 1 (its aligned tile is refilled below)
    __syncthreads();
    const float* ring1 = nullptr;
    if constexpr (S::kRing) {
      if (it + St < ntiles)
        rc.issue(raw + (it % St) * TF, k, p.k_st, v, p.v_st, mask, kv_begin + (it + St) * KT,
                 kv_end, tid);
      tc::cp_async_commit();
      ring1 = raw + ((it + 1) % St) * TF;
    }
    if (it + 1 < ntiles)
      fv::unpack<T, DP>(tiles + ((it + 1) & 1) * TF, ring1, rc.shift, k, p.k_st, v, p.v_st, mask,
                        kv_begin + (it + 1) * KT, kv_end, p.d, tid);
    if constexpr (NS > 0) {
      const float* ks = tiles + (it & 1) * TF;
      const float* vs = ks + KT * P;
      const float mkv = vs[KT * P + lane];
      const int k0 = kv_begin + it * KT;
      float sc[1][NS];
      fv::tile_dots<DP, NS, 1>(sc, qs, nullptr, ks, nullptr, warp, lane);
      // the rows' maxima first, their shuffle chains interleaved
      float x[NS], mx[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) mx[s] = x[s] = sc[0][s] * p.scale + (mkv - 1.f) * 1e30f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int s = 0; s < NS; ++s) mx[s] = fmaxf(mx[s], __shfl_xor_sync(0xffffffffu, mx[s], off));
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float m_new = fmaxf(m[s], mx[s]), corr = __expf(m[s] - m_new);
        m[s] = m_new;
        x[s] = __expf(x[s] - m_new) * mkv;
        l[s] = l[s] * corr + x[s];  // the lane's key; the warp sums at the end
#pragma unroll
        for (int i = 0; i < CPL; ++i) a[s][i] *= corr;
      }
      if (p.dropout) {
#pragma unroll
        for (int s = 0; s < NS; ++s)
          x[s] *= healnet::hash_keep(seed, (uint32_t)row, (uint32_t)(g0 + warp + tc::kWarps * s),
                                     (uint32_t)(k0 + lane), p.threshold)
                      ? p.keep_scale
                      : 0.f;
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) pw[s * KT + lane] = fv::round_to<T>(x[s]);
      __syncwarp();
      fv::tile_axpy<DP, NS>(a, pw, KT, vs, lane);
    }
  }
  if constexpr (S::kRing) tc::cp_async_wait(0);  // only empty groups are left
  // push the block's state of each of the warp's rows: (m, l) to every
  // block of the cluster, acc of output element e = r d + c to the block
  // that owns e (rank e / share)
  const int share = (nq * p.d + csize - 1) / csize;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int r = warp + tc::kWarps * s;
    float ls = l[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane * CPL + i;
      if (c < p.d) {
        const int e = r * p.d + c, owner = e / share;
        tc::st_cluster(racc + rank * share + e - owner * share, owner, a[s][i]);
      }
    }
    if (lane < csize) {
      tc::st_cluster(rm + rank * fv::kGroup + r, lane, m[s]);
      tc::st_cluster(rl + rank * fv::kGroup + r, lane, ls);
    }
  }
}

// One launch per call: grid (cluster, rows), one cluster per batch*head
// row, block `rank` owning keys [rank * keys_per_cta, ...) (flash_plan).
// For each group of up to 32 queries the block streams its keys once; each
// query row is owned by one warp, so a block's state of a row needs no
// merge inside the block. The blocks' states merge across the cluster in
// rank order through distributed shared memory, as in flash_fwd_tc.
template <typename T, int DP>
__global__ void __launch_bounds__(tc::kThreads, fv::min_blocks<DP>()) flash_fwd_fma(FmaParams p) {
  using S = fv::Shape<T, DP>;
  constexpr int KT = fv::kKeys, QG = fv::kGroup, TF = S::kTileFloats;
  extern __shared__ __align__(16) unsigned char fma_smem[];
  const FmaFwdLayout<T, DP> L(p.stages);
  const uint32_t seed = p.dropout ? __ldg(p.seed) : 0u;  // one uniform load a block
  float* raw = reinterpret_cast<float*>(fma_smem);
  float* tiles = reinterpret_cast<float*>(fma_smem + L.tiles);
  float* qs = reinterpret_cast<float*>(fma_smem + L.qs);
  float* ps = reinterpret_cast<float*>(fma_smem + L.ps);
  // pushed by the cluster's blocks: (m, l) [rank][query] and acc [rank][share]
  float* rm = reinterpret_cast<float*>(fma_smem + L.rm);
  float* rl = reinterpret_cast<float*>(fma_smem + L.rl);
  float* racc = reinterpret_cast<float*>(fma_smem + L.racc);

  tc::cg::cluster_group cluster = tc::cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int row = blockIdx.y, b = row / p.H, h = row - b * p.H;
  const int tid = threadIdx.x, warp = tid >> 5, St = p.stages;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* mask = p.mask ? p.mask + b * p.mask_sb : nullptr;
  T* out = static_cast<T*>(p.out);
  const int kv_begin = rank * p.keys_per_cta;
  const int kv_end = min(p.lkv, kv_begin + p.keys_per_cta);
  const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + KT - 1) / KT : 0;
  const fv::RingCopies<T, DP> rc(k, p.k_st, v, p.v_st, kv_begin, p.d, tid);

  for (int g0 = 0; g0 < p.lq; g0 += QG) {
    const int nq = min(QG, p.lq - g0);
    if constexpr (S::kRing) {
      for (int s = 0; s < St; ++s) {
        if (s < ntiles)
          rc.issue(raw + s * TF, k, p.k_st, v, p.v_st, mask, kv_begin + s * KT, kv_end, tid);
        tc::cp_async_commit();
      }
    }
    fv::load_rows_f32<DP, T>(qs, q, p.q_st, g0, QG, p.lq, p.d, tid);
    if (ntiles > 0) {
      if constexpr (S::kRing) tc::cp_async_wait(St - 1);
      __syncthreads();  // tile 0 has landed
      fv::unpack<T, DP>(tiles, raw, rc.shift, k, p.k_st, v, p.v_st, mask, kv_begin, kv_end,
                        p.d, tid);
    }
    const int ns = fv::slots_of(warp, nq);
#define FWD_GROUP(NS)                                                                         \
  fwd_group<T, DP, NS>(p, seed, rc, raw, tiles, qs, ps, rm, rl, racc, k, v, mask, row, g0, nq, kv_begin, \
                       kv_end, ntiles, rank, csize)
    switch (ns) {
      case 0: FWD_GROUP(0); break;
      case 1: FWD_GROUP(1); break;
      case 2: FWD_GROUP(2); break;
      case 3: FWD_GROUP(3); break;
      default: FWD_GROUP(4); break;
    }
#undef FWD_GROUP
    const int ne = nq * p.d, share = (ne + csize - 1) / csize;
    cluster.sync();
    // this block's share of the group's output: the blocks' states merged
    // in rank order from its own shared memory
    for (int e = rank * share + tid; e < min(ne, (rank + 1) * share); e += tc::kThreads) {
      const int r = e / p.d, c = e - r * p.d;
      float mx = tc::kNegBig;
      for (int j = 0; j < csize; ++j) mx = fmaxf(mx, rm[j * QG + r]);
      float a = 0.f, ls = 0.f;
      for (int j = 0; j < csize; ++j) {
        const float f = expf(rm[j * QG + r] - mx);
        a += racc[j * share + e - rank * share] * f;
        ls += rl[j * QG + r] * f;
      }
      const float lc = fmaxf(ls, 1e-30f);
      out[((size_t)(b * p.lq + g0 + r) * p.H + h) * p.d + c] = fv::from_float<T>(a / lc);
      if (c == 0) p.lse[(size_t)row * p.lq + g0 + r] = mx + logf(lc);
    }
    // before the next group pushes, every block is done reading this one's
    if (g0 + QG < p.lq) cluster.sync();
  }
}

// ------------------------------------------------- tensor-core variant (bf16)

struct TcParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* mask;   // (B, lkv) or null
  __nv_bfloat16* out;  // (B, lq, H, d)
  float* lse;          // (B*H, lq)
  int H, lq, lkv, d, keys_per_cta, stages;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, mask_sb;
  float scale;
  int dropout;
  const uint32_t* seed;  // the 32-bit hash seed, in device memory (read once a block)
  uint32_t threshold;
  float keep_scale;
};

// Byte offsets into the block's shared memory. The warps' states (m, l,
// acc of 16 queries each) alias the staging ring, which is idle by then.
template <int DP>
struct FwdLayout {
  size_t ks, vs, qs, mk, rm, rl, racc, total;
  __host__ __device__ explicit FwdLayout(int stages) {
    constexpr int P = tc::Dims<DP>::kPitch;
    const size_t ring = sizeof(uint32_t) * (size_t)stages * tc::Dims<DP>::kStageWords;
    const size_t warps = sizeof(float) * (size_t)tc::kWarps * 16 * (tc::Dims<DP>::kAccPitch + 2);
    ks = tc::align16(ring > warps ? ring : warps);
    vs = ks + 2 * tc::kKeyTile * P;
    qs = vs + 2 * tc::kKeyTile * P;
    mk = qs + 2 * tc::kQGroup * P;
    rm = mk + sizeof(float) * tc::kKeyTile;
    rl = rm + sizeof(float) * tc::kMaxCluster * tc::kQGroup;
    racc = rl + sizeof(float) * tc::kMaxCluster * tc::kQGroup;
    total = racc + sizeof(float) * (tc::kQGroup * DP + tc::kMaxCluster);
  }
};

template <int DP>
int fwd_stages() {
  return tc::pick_stages([](int s) { return FwdLayout<DP>(s).total; });
}

// Warp w owns query tile w / 4 (16 queries of the group) and keys
// 16 (w % 4) .. 16 (w % 4) + 15 of every tile, with its own online-softmax
// state (m, l per query row, acc in registers).
template <int DP>
__global__ void __launch_bounds__(tc::kThreads, DP <= 64 ? 2 : 1) flash_fwd_tc(TcParams p) {
  using D = tc::Dims<DP>;
  constexpr int P = D::kPitch, AP = D::kAccPitch, NT = DP / 8, KS = DP / 16, QG = tc::kQGroup;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const FwdLayout<DP> L(p.stages);
  const uint32_t seed = p.dropout ? __ldg(p.seed) : 0u;  // one uniform load a block
  uint32_t* ring = reinterpret_cast<uint32_t*>(tc_smem);
  float* wacc = reinterpret_cast<float*>(tc_smem);  // [warp][16][AP], after the key loop
  float* wm = wacc + tc::kWarps * 16 * AP;          // [warp][16]
  float* wl = wm + tc::kWarps * 16;                 // [warp][16]
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.ks);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.vs);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.qs);
  float* mk = reinterpret_cast<float*>(tc_smem + L.mk);
  // pushed by the cluster's blocks: (m, l) [rank][query] and acc [rank][share]
  float* rm = reinterpret_cast<float*>(tc_smem + L.rm);
  float* rl = reinterpret_cast<float*>(tc_smem + L.rl);
  float* racc = reinterpret_cast<float*>(tc_smem + L.racc);

  tc::cg::cluster_group cluster = tc::cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int row = blockIdx.y, b = row / p.H, h = row - b * p.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int mt = warp >> 2, wk = (warp & 3) * 16;
  const __nv_bfloat16* q = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = p.v + b * p.v_sb + h * p.v_sh;
  const float* mask = p.mask ? p.mask + b * p.mask_sb : nullptr;
  const int kv_begin = rank * p.keys_per_cta;
  const int kv_end = min(p.lkv, kv_begin + p.keys_per_cta);
  const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + tc::kKeyTile - 1) / tc::kKeyTile : 0;
  const int S = p.stages;

  for (int g0 = 0; g0 < p.lq; g0 += QG) {
    for (int s = 0; s < S - 1; ++s) {
      if (s < ntiles)
        tc::stage_tile<DP>(ring + s * D::kStageWords, k, p.k_st, v, p.v_st, mask,
                           kv_begin + s * tc::kKeyTile, kv_end, p.d, tid);
      tc::cp_async_commit();
    }
    tc::load_rows<DP>(qs, q, p.q_st, g0, p.lq, p.d, tid);
    const bool active = g0 + mt * 16 < p.lq;  // the warp's query tile holds a query

    float m[2], l[2], acc[NT][4];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m[hr] = tc::kNegBig;
      l[hr] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int it = 0; it < ntiles; ++it) {
      tc::cp_async_wait(S - 2);
      __syncthreads();  // tile `it` has landed; every warp is done with it - 1
      const int nxt = it + S - 1;
      if (nxt < ntiles)
        tc::stage_tile<DP>(ring + (nxt % S) * D::kStageWords, k, p.k_st, v, p.v_st, mask,
                           kv_begin + nxt * tc::kKeyTile, kv_end, p.d, tid);
      tc::cp_async_commit();
      const int k0 = kv_begin + it * tc::kKeyTile;
      tc::unpack_tile<DP>(ring + (it % S) * D::kStageWords, ks, vs, mk, k, p.k_st, v, p.v_st,
                          mask != nullptr, k0, kv_end, p.d, tid);
      __syncthreads();
      if (!active) continue;

      // scores of the warp's 16 queries and 16 keys: s[key n-tile][fragment]
      float s[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kb[4], qa[4];
        tc::ldsm_x4(kb, ks + (wk + ((lane >> 4) << 3) + (lane & 7)) * P + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        tc::ldsm_x4(qa, qs + (mt * 16 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
        tc::mma_bf16(s[0], qa, kb[0], kb[1]);
        tc::mma_bf16(s[1], qa, kb[2], kb[3]);
      }

      // online softmax over the warp's keys; P becomes the A fragment
      uint32_t pa[4];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float x[4], mx = tc::kNegBig;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = wk + (j >> 1) * 8 + 2 * t + (j & 1);
          x[j] = s[j >> 1][2 * hr + (j & 1)] * p.scale + (mk[col] - 1.f) * 1e30f;
          mx = fmaxf(mx, x[j]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hr], mx);
        const float corr = __expf(m[hr] - m_new);
        m[hr] = m_new;
        const uint32_t qi = (uint32_t)(g0 + mt * 16 + g + 8 * hr);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = wk + (j >> 1) * 8 + 2 * t + (j & 1);
          float pr = __expf(x[j] - m_new) * mk[col];
          sum += pr;
          if (p.dropout)
            pr *= healnet::hash_keep(seed, (uint32_t)row, qi, (uint32_t)(k0 + col),
                                     p.threshold)
                      ? p.keep_scale
                      : 0.f;
          x[j] = pr;
        }
        l[hr] = l[hr] * corr + sum;  // this thread's keys; the quad sums at the end
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][2 * hr] *= corr;
          acc[n][2 * hr + 1] *= corr;
        }
        pa[hr] = tc::pack_bf16(x[0], x[1]);      // keys 2t, 2t+1
        pa[2 + hr] = tc::pack_bf16(x[2], x[3]);  // keys 8 + 2t, 8 + 2t + 1
      }

      // acc += P V over the warp's 16 keys
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vb[4];
        tc::ldsm_x4_t(vb, vs + (wk + (lane & 7) + ((lane >> 3) & 1) * 8) * P + np * 16 +
                              (lane >> 4) * 8);
        tc::mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
        tc::mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    tc::cp_async_wait(0);  // only empty groups are left; the ring is free

    // each warp's state into shared memory
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float ls = l[hr];
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      const int r = warp * 16 + g + 8 * hr;
      if (t == 0) {
        wm[r] = m[hr];
        wl[r] = ls;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(wacc + r * AP + n * 8 + 2 * t) =
            make_float2(acc[n][2 * hr], acc[n][2 * hr + 1]);
    }
    __syncthreads();
    // the block's state (the four key slices of each query merged in warp
    // order), pushed through distributed shared memory: its (m, l) of every
    // query to every block of the cluster, its acc of output element
    // e = r d + c to the block that owns e (rank e / share)
    const int nq = min(QG, p.lq - g0), ne = nq * p.d, share = (ne + csize - 1) / csize;
#pragma unroll 2
    for (int n = 0; n < QG * DP / tc::kThreads; ++n) {
      const int i = tid + n * tc::kThreads, r = i / DP, c = i % DP;
      if (r >= nq || c >= p.d) continue;
      const int w0 = (r >> 4) * 64 + (r & 15);  // warp 4 (r / 16), row r % 16
      float mx = tc::kNegBig;
#pragma unroll
      for (int w = 0; w < 4; ++w) mx = fmaxf(mx, wm[w0 + 16 * w]);
      float a = 0.f, ls = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float f = __expf(wm[w0 + 16 * w] - mx);
        a += wacc[(w0 + 16 * w) * AP + c] * f;
        ls += wl[w0 + 16 * w] * f;
      }
      const int e = r * p.d + c, owner = e / share;
      tc::st_cluster(racc + rank * share + e - owner * share, owner, a);
      for (int j = c; j < csize; j += p.d) {  // the row's (m, l) to rank j
        tc::st_cluster(rm + rank * QG + r, j, mx);
        tc::st_cluster(rl + rank * QG + r, j, ls);
      }
    }
    cluster.sync();
    // this block's share of the row's output: the blocks' states merged in
    // rank order from its own shared memory
    for (int e = rank * share + tid; e < min(ne, (rank + 1) * share); e += tc::kThreads) {
      const int r = e / p.d, c = e - r * p.d;
      float mx = tc::kNegBig;
      for (int j = 0; j < csize; ++j) mx = fmaxf(mx, rm[j * QG + r]);
      float a = 0.f, ls = 0.f;
      for (int j = 0; j < csize; ++j) {
        const float f = __expf(rm[j * QG + r] - mx);
        a += racc[j * share + e - rank * share] * f;
        ls += rl[j * QG + r] * f;
      }
      const float lc = fmaxf(ls, 1e-30f);
      p.out[((size_t)(b * p.lq + g0 + r) * p.H + h) * p.d + c] = __float2bfloat16(a / lc);
      if (c == 0) p.lse[(size_t)row * p.lq + g0 + r] = mx + logf(lc);
    }
    // after the last group no block touches another's shared memory; before
    // the next, every block must be done reading what this group pushed
    if (g0 + QG < p.lq) cluster.sync();
  }
}

}  // namespace

// The most queries a block of the FMA forward holds at once at head dim d
// (it walks any lq in groups of that many); 0 for d < 1.
extern "C" int healnet_flash_max_queries(int d) { return d >= 1 ? fv::kGroup : 0; }

namespace {

template <typename T, int DP>
cudaError_t launch_fma_fwd(FmaParams p, int cluster, int rows, cudaStream_t s) {
  p.stages = fma_fwd_stages<T, DP>();
  return tc::launch_clustered(flash_fwd_fma<T, DP>, p, cluster, rows,
                              FmaFwdLayout<T, DP>(p.stages).total, s);
}

}  // namespace

// Clusters of `cluster` blocks of the FMA forward the card holds at once
// (-1 where the query fails, or for bf16 heads the tensor cores take).
extern "C" int healnet_flash_fma_max_clusters(int d, int is_bf16, int cluster) {
  if (d > fv::kMaxD) return -1;
  return fv::with_dp32(d, [&](auto dp) -> int {
    constexpr int DP = decltype(dp)::value;
    using B = __nv_bfloat16;
    if (!is_bf16)
      return tc::max_active_clusters(flash_fwd_fma<float, DP>, cluster,
                                     FmaFwdLayout<float, DP>(fma_fwd_stages<float, DP>()).total);
    if constexpr (DP > 128)
      return tc::max_active_clusters(flash_fwd_fma<B, DP>, cluster,
                                     FmaFwdLayout<B, DP>(fma_fwd_stages<B, DP>()).total);
    return -1;
  });
}

extern "C" int healnet_flash_forward(
    const void* q, const void* k, const void* v, const float* mask, void* out, float* lse,
    int B, int H, int lq, int lkv, int d, int cluster, int keys_per_cta, long long q_sb,
    long long q_sh, long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long mask_sb, float scale, int dropout,
    const void* seed, unsigned int threshold, float keep_scale, int is_bf16, void* stream) {
  if (B * H <= 0 || lq <= 0) return 0;
  if (d < 1 || d > fv::kMaxD || (is_bf16 && d <= 128)) return (int)cudaErrorInvalidValue;
  FmaParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.out = out;
  p.lse = lse;
  p.H = H;
  p.lq = lq;
  p.lkv = lkv;
  p.d = d;
  p.keys_per_cta = keys_per_cta;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_st = q_st;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_st = k_st;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_st = v_st;
  p.mask_sb = mask_sb;
  p.scale = scale;
  p.dropout = dropout;
  p.seed = static_cast<const uint32_t*>(seed);
  p.threshold = threshold;
  p.keep_scale = keep_scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return static_cast<int>(fv::with_dp32(d, [&](auto dp) -> cudaError_t {
    constexpr int DP = decltype(dp)::value;
    if (!is_bf16) return launch_fma_fwd<float, DP>(p, cluster, B * H, s);
    if constexpr (DP > 128) return launch_fma_fwd<__nv_bfloat16, DP>(p, cluster, B * H, s);
    return cudaErrorInvalidValue;
  }));
}

extern "C" int healnet_flash_tc_max_clusters(int d, int cluster) {
  return tc::with_dp(d, [&](auto dp) -> int {
    constexpr int DP = decltype(dp)::value;
    return tc::max_active_clusters(flash_fwd_tc<DP>, cluster,
                                   FwdLayout<DP>(fwd_stages<DP>()).total);
  });
}

extern "C" int healnet_flash_forward_tc(
    const void* q, const void* k, const void* v, const float* mask, void* out, float* lse,
    int B, int H, int lq, int lkv, int d, int cluster, int keys_per_cta, long long q_sb,
    long long q_sh, long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long mask_sb, float scale, int dropout,
    const void* seed, unsigned int threshold, float keep_scale, void* stream) {
  if (B * H <= 0 || lq <= 0) return 0;
  TcParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.mask = mask;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = lse;
  p.H = H;
  p.lq = lq;
  p.lkv = lkv;
  p.d = d;
  p.keys_per_cta = keys_per_cta;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_st = q_st;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_st = k_st;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_st = v_st;
  p.mask_sb = mask_sb;
  p.scale = scale;
  p.dropout = dropout;
  p.seed = static_cast<const uint32_t*>(seed);
  p.threshold = threshold;
  p.keep_scale = keep_scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return static_cast<int>(tc::with_dp(d, [&](auto dp) -> cudaError_t {
    constexpr int DP = decltype(dp)::value;
    p.stages = fwd_stages<DP>();
    return tc::launch_clustered(flash_fwd_tc<DP>, p, cluster, B * H,
                                FwdLayout<DP>(p.stages).total, s);
  }));
}

extern "C" const char* healnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
