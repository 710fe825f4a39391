// Flash cross-attention backward: dq, dk, dv from the forward's per-row
// log-sum-exp and delta = rowsum(dO * O), with the key mask and the
// coordinate-hash dropout regenerated over the forward's coordinates.
//
// Replaces: healnet_tpu/ops/flash_attention.py::_bwd_kernel (the Pallas
// kernel launched by _bwd_call).
//
// Per row r = (batch, head), query i, key j, with e_ij = keep_ij / (1 - rate)
// (1 without dropout) and the same f32 arithmetic as the TPU kernel:
//   s_ij  = (q_i . k_j) * scale - 1e30 * (1 - mask_j)
//   p_ij  = exp(s_ij - lse_i) * mask_j        (denominator from the forward)
//   dv_j  = sum_i round_T(p_ij * e_ij) * dO_i
//   ds_ij = round_T(p_ij * (e_ij * (v_j . dO_i) - delta_i))
//   dk_j  = scale * sum_i ds_ij * q_i,   dq_i = scale * sum_j ds_ij * k_j
// A fully masked row has lse = -1e30 and p = 0: its dq is 0 and it adds
// nothing to dk or dv.
//
// Bound on an H100 SXM at the training shape (b*h = 8, lq = 17, lkv = 4096,
// d = 63, bf16): reading k and v and writing dk and dv moves 16.5 MB, about
// 5 us at 3.35 TB/s, against about 0.35 GFLOP (0.35 us of bf16 tensor-core
// time). As in the forward, eight (batch*head) rows are far fewer than the
// 132 SMs: latency, not bytes or operations, sets the time, and 17 queries
// and d = 63 pad to tensor-core tiles (two m16 or four n8 tiles, k16 steps).
//
// Two variants, chosen by the wrapper from the dtype and d before launch:
//
// flash_bwd_tc (bf16, d <= 128; the model's path). One launch per call, the
// forward's cluster plan: one thread-block cluster per row, each block
// owning a contiguous range of keys that it streams through the same
// cp.async ring (flash_tc.cuh). The products run on mma.sync m16n8k16 in
// the transposed layout of the JAX kernel: s^T = K Q^T and dp^T = V dO^T
// with keys on M (each warp owns 16 keys of a 64-key tile) and queries on
// N; dv = round(p e)^T dO and dk = round(ds)^T q with keys on M, their A
// fragments read from p^T and ds^T tiles in shared memory; dq += round(ds) K
// with queries on M. A block stages each tile's dk and dv in the tile's
// spent ring stage and writes them with coalesced stores, and keeps its
// partial dq in shared memory; at the end each block pushes its partial dq
// of each element to the block of the cluster that owns the element
// (distributed shared memory stores), and after one cluster barrier the
// owner adds the parts in rank order, scales once and writes them: no
// partial buffer in device memory, no second kernel, no float atomics.
// q, dO, lse and delta are loaded once per block.
//
// flash_bwd_fma (f32, and bf16 with d > 128): full f32 FMA products on the
// CUDA cores, one launch per call on the same skeleton and plan as the
// forward's FMA variant (flash_attention.cu; fmav in flash_tc.cuh: 32-key
// tiles from a cp.async ring of 16-byte hulls, shifted into double-buffered
// aligned tiles). Each query row of a chunk of at most 32 is owned by one
// warp: each lane takes one key of the tile for s = q K^T and dp = dO V^T
// (a float4 of its key row against broadcast float4s of the warp's rows),
// writes round(p e) and round(ds) to shared memory, and adds dq += round(ds)
// K over its channels in registers. After the next tile's one block
// barrier, warp w takes keys 4w..4w+3 of the previous tile and each lane
// its channels for dv = round(p e)^T dO and dk = round(ds)^T q over the
// chunk's queries (pd and ds are double-buffered, so one block barrier a
// tile suffices), and writes them, a warp's stores covering 32 consecutive
// channels of a row: each block finishes the dk and dv of its own keys. dq
// is summed across the cluster in rank order through distributed shared
// memory: no partial buffer, no second kernel, no float atomics. Heads
// wider than 256 take the kernels of flash_wide.cu.
//
// Any latent count: both variants walk the queries in chunks that fit
// shared memory (query_chunks in ops/flash_attention.py sizes them from
// healnet_flash_bwd[_tc]_max_queries), a loop inside the block that streams
// the block's keys once per chunk. dq is a chunk's own. dk and dv sum over
// the chunks: with more than one chunk each thread carries its own elements'
// f32 sums through a scratch buffer (dkv_acc, (2, B*H, lkv, pitch)) that
// only it reads and writes, in chunk order, and rounds them on the last
// chunk: no float atomics, the same bits on every call. One chunk (the
// model's lq of 17) never touches the scratch.

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
  const float* mask;   // (B, lkv) or null
  const void* dout;    // (B, H, lq, d), strided
  const float* lse;    // (B*H, lq)
  const float* delta;  // (B*H, lq)
  void* dq;            // (B, H, lq, d) contiguous
  void* dk;            // (B, H, lkv, d) contiguous
  void* dv;            // (B, H, lkv, d) contiguous
  float* dkv_acc;      // (2, B*H, lkv, d) f32 when n_chunks > 1, else null
  int H, lq, lkv, d, keys_per_cta, stages, q_chunk, n_chunks;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st, mask_sb;
  float scale;
  int dropout;
  const uint32_t* seed;  // the 32-bit hash seed, in device memory (read once a block)
  uint32_t threshold;
  float keep_scale;
};

// queries of a chunk rounded up to whole slot rows (8 warps)
__host__ __device__ inline int fma_rows(int chunk) {
  return (chunk + tc::kWarps - 1) / tc::kWarps * tc::kWarps;
}

// Byte offsets into the block's shared memory (rows: fma_rows(q_chunk)):
// the ring's stages (none where the slice takes no ring), two aligned
// tiles, q, dO, lse, delta, pd and ds, and the cluster's pushed dq. pd and
// ds of a tile are double-buffered: the dk/dv products of tile it - 1 read
// one pair while the scores of tile it write the other.
template <typename T, int DP>
struct FmaBwdLayout {
  size_t tiles, qs, dos, lse, del, pd, rdq, total;
  __host__ __device__ FmaBwdLayout(int stages, int rows) {
    using S = fv::Shape<T, DP>;
    tiles = sizeof(float) * (size_t)stages * S::kTileFloats;
    qs = tiles + sizeof(float) * 2 * S::kTileFloats;
    dos = qs + sizeof(float) * (size_t)rows * S::kPitch;
    lse = dos + sizeof(float) * (size_t)rows * S::kPitch;
    del = lse + sizeof(float) * rows;
    pd = del + sizeof(float) * rows;  // [buffer][pd, ds][row][key]
    rdq = pd + sizeof(float) * 4 * (size_t)rows * fv::kKeys;
    total = rdq + sizeof(float) * ((size_t)rows * DP + tc::kMaxCluster);
  }
};

template <typename T, int DP>
int fma_bwd_stages(int chunk) {
  return fv::ring_stages<T, DP>(
      [chunk](int s) { return FmaBwdLayout<T, DP>(s, fma_rows(chunk)).total; });
}

// The most queries a chunk may hold (at most 32, a multiple of 8) whose
// layout fits a block at the fewest ring stages.
template <typename T, int DP>
int fma_bwd_max_queries() {
  const int stages = fv::Shape<T, DP>::kRing ? 2 : 0;
  for (int rows = fv::kGroup; rows > 0; rows -= tc::kWarps)
    if (FmaBwdLayout<T, DP>(stages, rows).total <= tc::kMaxSmem) return rows;
  return 0;
}

// dv_j += sum_i pd_ij dO_i and dk_j += sum_i ds_ij q_i for tile keys
// 4 warp .. 4 warp + 3 and the lane's channels lane + 32 c (pd, ds: [row]
// [key] of the tile), over the chunk's nq queries, then written out (dk
// scaled; a warp's stores cover 32 consecutive channels of a row), or
// carried over the chunks in f32 by this thread alone, in chunk order.
// qs and dos hold head columns [c0, c0 + dc) (all of them where d <= 256).
template <typename T, int DP>
__device__ __forceinline__ void dkdv_tile(const FmaParams& p, const float* pd, const float* ds,
                                          const float* qs, const float* dos, int nq, int k0,
                                          int kv_end, T* dk, T* dv, float* dk_acc, float* dv_acc,
                                          bool first, bool last, int c0, int dc) {
  constexpr int KT = fv::kKeys, P = DP + 4, CW = DP / 32;
  const int lane = threadIdx.x & 31, j0 = 4 * (threadIdx.x >> 5);
  float av[4][CW], ak[4][CW];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int c = 0; c < CW; ++c) av[jj][c] = ak[jj][c] = 0.f;
#pragma unroll 2
  for (int i = 0; i < nq; ++i) {
    const float4 pv = *reinterpret_cast<const float4*>(pd + i * KT + j0);
    const float4 sv = *reinterpret_cast<const float4*>(ds + i * KT + j0);
    float o[CW], x[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) o[c] = dos[i * P + lane + 32 * c], x[c] = qs[i * P + lane + 32 * c];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        av[jj][c] = fmaf(fv::at(pv, jj), o[c], av[jj][c]);
        ak[jj][c] = fmaf(fv::at(sv, jj), x[c], ak[jj][c]);
      }
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int key = k0 + j0 + jj;
    if (key >= kv_end) continue;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int ch = lane + 32 * c;
      if (ch >= dc) continue;
      const size_t off = (size_t)key * p.d + c0 + ch;
      float a = av[jj][c], b = ak[jj][c];
      if (dk_acc != nullptr) {
        if (!first) {
          b += dk_acc[off];
          a += dv_acc[off];
        }
        if (!last) {
          dk_acc[off] = b;
          dv_acc[off] = a;
          continue;
        }
      }
      dv[off] = fv::from_float<T>(a);
      dk[off] = fv::from_float<T>(b * p.scale);
    }
  }
}

// The key loop of one query chunk for a warp that owns NS of its rows.
// Tile it's interval, after its one block barrier: the ring issues tile
// it + stages, tile it + 1 is shifted into the other aligned tile, every
// thread takes its dk/dv products of tile it - 1 (from that tile's pd/ds
// buffer), and the warp takes s = q K^T and dp = dO V^T of its rows against
// the lane's key of tile it, p, round(p e) and round(ds) into the other
// buffer, and dq += round(ds) K over the lane's channels (its own rows
// only: __syncwarp). dq stays in registers and is pushed at the end.
template <typename T, int DP, int NS>
__device__ __forceinline__ void bwd_chunk(const FmaParams& p, uint32_t seed,
                                          const fv::RingCopies<T, DP>& rc,
                                          float* raw, float* tiles,
                                          const float* qs, const float* dos, const float* lse_s,
                                          const float* del_s, float* pdbuf, float* rdq,
                                          const T* k, const T* v, const float* mask, T* dk,
                                          T* dv, float* dk_acc, float* dv_acc, int row, int q0c,
                                          int nq, int rows, int kv_begin, int kv_end,
                                          int ntiles, int rank, int csize, bool first,
                                          bool last) {
  using S = fv::Shape<T, DP>;
  constexpr int KT = fv::kKeys, P = S::kPitch, TF = S::kTileFloats, CPL = S::kChPerLane;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, St = p.stages;
  const int buf = 2 * rows * KT;  // floats of one (pd, ds) buffer pair
  float dqa[NS > 0 ? NS : 1][CPL];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < CPL; ++i) dqa[s][i] = 0.f;
  for (int it = 0; it <= ntiles; ++it) {
    if constexpr (S::kRing)
      if (it < ntiles) tc::cp_async_wait(St - 2);
    // tile it is unpacked and tile it + 1 has landed; every warp is done
    // with tile it - 1's aligned tile and with the products of tile it - 2
    // (the pd/ds buffer tile it writes)
    __syncthreads();
    if (it < ntiles) {
      const float* ring1 = nullptr;
      if constexpr (S::kRing) {
        if (it + St < ntiles)
          rc.issue(raw + (it % St) * TF, k, p.k_st, v, p.v_st, mask, kv_begin + (it + St) * KT,
                   kv_end, tid);
        tc::cp_async_commit();
        ring1 = raw + ((it + 1) % St) * TF;
      }
      if (it + 1 < ntiles)
        fv::unpack<T, DP>(tiles + ((it + 1) & 1) * TF, ring1, rc.shift, k, p.k_st, v, p.v_st,
                          mask,
                          kv_begin + (it + 1) * KT, kv_end, p.d, tid);
    }
    if (it > 0) {
      const float* pd = pdbuf + ((it - 1) & 1) * buf;
      dkdv_tile<T, DP>(p, pd, pd + rows * KT, qs, dos, nq, kv_begin + (it - 1) * KT, kv_end, dk,
                       dv, dk_acc, dv_acc, first, last, 0, p.d);
    }
    if constexpr (NS > 0) {
      if (it < ntiles) {
        const float* ks = tiles + (it & 1) * TF;
        const float* vs = ks + KT * P;
        const float mkv = vs[KT * P + lane];
        const int k0 = kv_begin + it * KT;
        float* pd = pdbuf + (it & 1) * buf;
        float* ds = pd + rows * KT;
        float sd[2][NS];
        fv::tile_dots<DP, NS, 2>(sd, qs, dos, ks, vs, warp, lane);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int r = warp + tc::kWarps * s;
          const float x = sd[0][s] * p.scale + (mkv - 1.f) * 1e30f;
          const float pr = __expf(x - lse_s[r]) * mkv;
          float e = 1.f;
          if (p.dropout)
            e = healnet::hash_keep(seed, (uint32_t)row, (uint32_t)(q0c + r), (uint32_t)(k0 + lane),
                                   p.threshold)
                    ? p.keep_scale
                    : 0.f;
          pd[r * KT + lane] = fv::round_to<T>(pr * e);
          ds[r * KT + lane] = fv::round_to<T>(pr * (sd[1][s] * e - del_s[r]));
        }
        __syncwarp();
        fv::tile_axpy<DP, NS>(dqa, ds + warp * KT, tc::kWarps * KT, ks, lane);
      }
    }
  }
  // push the warp's partial dq of element e = r d + c to the block that
  // owns e (rank e / share)
  const int share = (nq * p.d + csize - 1) / csize;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int r = warp + tc::kWarps * s;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane * CPL + i;
      if (c < p.d) {
        const int e = r * p.d + c, owner = e / share;
        tc::st_cluster(rdq + rank * share + e - owner * share, owner, dqa[s][i]);
      }
    }
  }
}

// One launch per call, the forward's plan: one cluster per row, block
// `rank` owning a contiguous range of keys, whose dk and dv it finishes
// (sums over every query, in query order, by one thread an element). For
// each chunk of at most 32 queries the block streams its keys once; dq is
// summed across the cluster in rank order through distributed shared
// memory. With more than one chunk, dk and dv are carried over the chunks
// in the f32 scratch buffer, each element by one thread, in chunk order.
template <typename T, int DP>
__global__ void __launch_bounds__(tc::kThreads, fv::min_blocks<DP>()) flash_bwd_fma(FmaParams p) {
  using S = fv::Shape<T, DP>;
  constexpr int KT = fv::kKeys, TF = S::kTileFloats;
  extern __shared__ __align__(16) unsigned char fma_smem[];
  const int rows = fma_rows(p.q_chunk);
  const FmaBwdLayout<T, DP> L(p.stages, rows);
  const uint32_t seed = p.dropout ? __ldg(p.seed) : 0u;  // one uniform load a block
  float* raw = reinterpret_cast<float*>(fma_smem);
  float* tiles = reinterpret_cast<float*>(fma_smem + L.tiles);
  float* qs = reinterpret_cast<float*>(fma_smem + L.qs);
  float* dos = reinterpret_cast<float*>(fma_smem + L.dos);
  float* lse_s = reinterpret_cast<float*>(fma_smem + L.lse);
  float* del_s = reinterpret_cast<float*>(fma_smem + L.del);
  float* pdbuf = reinterpret_cast<float*>(fma_smem + L.pd);
  float* rdq = reinterpret_cast<float*>(fma_smem + L.rdq);  // pushed parts [rank][share]

  tc::cg::cluster_group cluster = tc::cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int row = blockIdx.y, b = row / p.H, h = row - b * p.H;
  const int tid = threadIdx.x, warp = tid >> 5, St = p.stages;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* mask = p.mask ? p.mask + b * p.mask_sb : nullptr;
  T* dk = static_cast<T*>(p.dk) + (size_t)row * p.lkv * p.d;
  T* dv = static_cast<T*>(p.dv) + (size_t)row * p.lkv * p.d;
  const int kv_begin = rank * p.keys_per_cta;
  const int kv_end = min(p.lkv, kv_begin + p.keys_per_cta);
  const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + KT - 1) / KT : 0;
  const fv::RingCopies<T, DP> rc(k, p.k_st, v, p.v_st, kv_begin, p.d, tid);
  // the carry of dk and dv over the chunks: this row's (lkv, d) halves
  float* dk_acc = p.dkv_acc ? p.dkv_acc + (size_t)row * p.lkv * p.d : nullptr;
  float* dv_acc = p.dkv_acc ? dk_acc + (size_t)gridDim.y * p.lkv * p.d : nullptr;

  for (int chunk = 0; chunk < p.n_chunks; ++chunk) {
    const int q0c = chunk * p.q_chunk, nq = min(p.q_chunk, p.lq - q0c);
    const bool first = chunk == 0, last = chunk == p.n_chunks - 1;
    if constexpr (S::kRing) {
      for (int s = 0; s < St; ++s) {
        if (s < ntiles)
          rc.issue(raw + s * TF, k, p.k_st, v, p.v_st, mask, kv_begin + s * KT, kv_end, tid);
        tc::cp_async_commit();
      }
    }
    // q, dO, lse and delta once per block and chunk (seen after the first
    // barrier of the key loop)
    fv::load_rows_f32<DP, T>(qs, q, p.q_st, q0c, rows, p.lq, p.d, tid);
    fv::load_rows_f32<DP, T>(dos, dout, p.o_st, q0c, rows, p.lq, p.d, tid);
    for (int i = tid; i < rows; i += tc::kThreads) {
      lse_s[i] = i < nq ? p.lse[(size_t)row * p.lq + q0c + i] : 0.f;
      del_s[i] = i < nq ? p.delta[(size_t)row * p.lq + q0c + i] : 0.f;
    }
    if (ntiles > 0) {
      if constexpr (S::kRing) tc::cp_async_wait(St - 1);
      __syncthreads();  // tile 0 has landed
      fv::unpack<T, DP>(tiles, raw, rc.shift, k, p.k_st, v, p.v_st, mask, kv_begin, kv_end,
                        p.d, tid);
    }
    const int ns = fv::slots_of(warp, nq);
#define BWD_CHUNK(NS)                                                                       \
  bwd_chunk<T, DP, NS>(p, seed, rc, raw, tiles, qs, dos, lse_s, del_s, pdbuf, rdq, k, v, mask, dk, dv,     \
                       dk_acc, dv_acc, row, q0c, nq, rows, kv_begin, kv_end, ntiles, rank, \
                       csize, first, last)
    switch (ns) {
      case 0: BWD_CHUNK(0); break;
      case 1: BWD_CHUNK(1); break;
      case 2: BWD_CHUNK(2); break;
      case 3: BWD_CHUNK(3); break;
      default: BWD_CHUNK(4); break;
    }
#undef BWD_CHUNK
    if constexpr (S::kRing) tc::cp_async_wait(0);  // only empty groups are left
    cluster.sync();
    // the chunk's dq: the parts added in rank order, scaled once
    const int ne = nq * p.d, share = (ne + csize - 1) / csize;
    T* dq = static_cast<T*>(p.dq) + ((size_t)row * p.lq + q0c) * p.d;
    for (int e = rank * share + tid; e < min(ne, (rank + 1) * share); e += tc::kThreads) {
      float a = 0.f;
      for (int j = 0; j < csize; ++j) a += rdq[j * share + e - rank * share];
      dq[e] = fv::from_float<T>(a * p.scale);
    }
    // before the next chunk pushes, every block is done reading this one's
    if (!last) cluster.sync();
  }
}

// ------------------------------------------------- tensor-core variant (bf16)

constexpr int kDsPitch = tc::kQGroup + 8;  // bf16 row pitch of the p^T and ds^T tiles

struct TcParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* mask;          // (B, lkv) or null
  const __nv_bfloat16* dout;  // (B, H, lq, d), strided
  const float* lse;           // (B*H, lq)
  const float* delta;         // (B*H, lq)
  __nv_bfloat16* dq;          // (B, H, lq, d) contiguous
  __nv_bfloat16* dk;          // (B, H, lkv, d) contiguous
  __nv_bfloat16* dv;          // (B, H, lkv, d) contiguous
  float* dkv_acc;             // (2, B*H, lkv, DP) f32 when n_chunks > 1, else null
  int H, lq, lkv, d, keys_per_cta, stages, q_chunk, n_chunks;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st, mask_sb;
  float scale;
  int dropout;
  const uint32_t* seed;  // the 32-bit hash seed, in device memory (read once a block)
  uint32_t threshold;
  float keep_scale;
};

__host__ __device__ inline int pad_queries(int lq) {
  return (lq + tc::kQGroup - 1) / tc::kQGroup * tc::kQGroup;
}

// Byte offsets into the block's shared memory (lqp = the query chunk, a
// multiple of 32).
template <int DP>
struct BwdLayout {
  size_t ks, vs, qs, dos, lse, del, mk, pt, dst, dq, rdq, total;
  __host__ __device__ BwdLayout(int stages, int lqp) {
    constexpr int P = tc::Dims<DP>::kPitch;
    ks = tc::align16(sizeof(uint32_t) * (size_t)stages * tc::Dims<DP>::kStageWords);
    vs = ks + 2 * tc::kKeyTile * P;
    qs = vs + 2 * tc::kKeyTile * P;
    dos = qs + 2 * (size_t)lqp * P;
    lse = dos + 2 * (size_t)lqp * P;
    del = lse + sizeof(float) * lqp;
    mk = del + sizeof(float) * lqp;
    pt = mk + sizeof(float) * tc::kKeyTile;
    dst = pt + 2 * tc::kKeyTile * kDsPitch;
    dq = dst + 2 * tc::kKeyTile * kDsPitch;
    rdq = dq + sizeof(float) * (size_t)lqp * tc::Dims<DP>::kAccPitch;
    total = rdq + sizeof(float) * ((size_t)lqp * DP + tc::kMaxCluster);
  }
};

template <int DP>
int bwd_stages(int lq) {
  return tc::pick_stages([lq](int s) { return BwdLayout<DP>(s, pad_queries(lq)).total; });
}

// The largest query chunk (a multiple of 32) whose layout fits a block at
// two ring stages.
template <int DP>
int bwd_max_queries() {
  int best = 0;
  for (int lqp = tc::kQGroup; BwdLayout<DP>(2, lqp).total <= tc::kMaxSmem; lqp += tc::kQGroup)
    best = lqp;
  return best;
}

// Per 64-key tile and 32-query group, warp w takes keys 16 (w % 4) ..
// + 15 and queries 16 (w / 4) .. + 15 for s^T and dp^T, writes round(p e)
// and round(ds) to the p^T and ds^T tiles; after a barrier it computes dv
// and dk of the same keys on the n-tiles n = w / 4 (mod 2) of the head dim
// over all 32 queries, and dq for query tile w % 2 on the n-tiles
// n = w / 2 (mod 4) over all 64 keys.
template <int DP>
__global__ void __launch_bounds__(tc::kThreads, DP <= 64 ? 2 : 1) flash_bwd_tc(TcParams p) {
  using D = tc::Dims<DP>;
  constexpr int P = D::kPitch, AP = D::kAccPitch, NT = DP / 8, KS = DP / 16;
  constexpr int NV = NT / 2, NQ = (NT + 3) / 4;  // n-tiles per warp for dv/dk and for dq
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int lqp = pad_queries(p.q_chunk);
  const BwdLayout<DP> L(p.stages, lqp);
  const uint32_t seed = p.dropout ? __ldg(p.seed) : 0u;  // one uniform load a block
  uint32_t* ring = reinterpret_cast<uint32_t*>(tc_smem);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.ks);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.vs);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.qs);
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.dos);
  float* lse_s = reinterpret_cast<float*>(tc_smem + L.lse);
  float* del_s = reinterpret_cast<float*>(tc_smem + L.del);
  float* mk = reinterpret_cast<float*>(tc_smem + L.mk);                 // the tile's key mask
  __nv_bfloat16* pt = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.pt);   // round(p e) [key][query]
  __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.dst); // round(ds) [key][query]
  float* dq_s = reinterpret_cast<float*>(tc_smem + L.dq);  // the block's partial dq [query][AP]
  float* rdq = reinterpret_cast<float*>(tc_smem + L.rdq);  // pushed parts [rank][share]

  tc::cg::cluster_group cluster = tc::cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int row = blockIdx.y, b = row / p.H, h = row - b * p.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wk = (warp & 3) * 16, qh = warp >> 2;
  const __nv_bfloat16* q = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dout = p.dout + b * p.o_sb + h * p.o_sh;
  const float* mask = p.mask ? p.mask + b * p.mask_sb : nullptr;
  __nv_bfloat16* dk = p.dk + (size_t)row * p.lkv * p.d;
  __nv_bfloat16* dv = p.dv + (size_t)row * p.lkv * p.d;
  const int kv_begin = rank * p.keys_per_cta;
  const int kv_end = min(p.lkv, kv_begin + p.keys_per_cta);
  const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + tc::kKeyTile - 1) / tc::kKeyTile : 0;
  const int S = p.stages;
  // the carry of dk and dv over the chunks: this row's (lkv, DP) halves
  float* dk_acc = p.dkv_acc ? p.dkv_acc + (size_t)row * p.lkv * DP : nullptr;
  float* dv_acc = p.dkv_acc ? dk_acc + (size_t)gridDim.y * p.lkv * DP : nullptr;

  for (int chunk = 0; chunk < p.n_chunks; ++chunk) {
    // queries [q0c, q0c + nq) of the chunk; shared-memory rows are relative
    const int q0c = chunk * p.q_chunk, nq = min(p.q_chunk, p.lq - q0c);
    const int ngroups = (nq + tc::kQGroup - 1) / tc::kQGroup;
    const bool first = chunk == 0, last = chunk == p.n_chunks - 1;
    for (int s = 0; s < S - 1; ++s) {
      if (s < ntiles)
        tc::stage_tile<DP>(ring + s * D::kStageWords, k, p.k_st, v, p.v_st, mask,
                           kv_begin + s * tc::kKeyTile, kv_end, p.d, tid);
      tc::cp_async_commit();
    }
    // q, dO, lse and delta once per block and chunk; padded queries get
    // q = dO = 0 and lse = 1e30, so their probabilities are exactly 0
    for (int r0 = 0; r0 < ngroups * tc::kQGroup; r0 += tc::kQGroup) {
      tc::load_rows<DP>(qs + r0 * P, q, p.q_st, q0c + r0, p.lq, p.d, tid);
      tc::load_rows<DP>(dos + r0 * P, dout, p.o_st, q0c + r0, p.lq, p.d, tid);
    }
    for (int i = tid; i < lqp; i += tc::kThreads) {
      lse_s[i] = i < nq ? p.lse[(size_t)row * p.lq + q0c + i] : 1e30f;
      del_s[i] = i < nq ? p.delta[(size_t)row * p.lq + q0c + i] : 0.f;
    }
    for (int i = tid; i < lqp * AP; i += tc::kThreads) dq_s[i] = 0.f;

    for (int it = 0; it < ntiles; ++it) {
      tc::cp_async_wait(S - 2);
      if (tid == 0) tc::bulk_wait_read();  // the stage of tile it - 1 is read out
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

      // dv and dk of the warp's keys on its n-tiles, summed over the groups
      float dva[NV][4], dka[NV][4];
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dva[n][e] = dka[n][e] = 0.f;

      for (int grp = 0; grp < ngroups; ++grp) {
        const int q0 = grp * tc::kQGroup, qw = q0 + qh * 16;  // the warp's 16 queries
        // s^T = K Q^T and dp^T = V dO^T: keys on M, queries on N (2 x 8)
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
        if (qw < nq) {
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            uint32_t ka[4], va[4], qb[4], ob[4];
            tc::ldsm_x4(ka, ks + (wk + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
            tc::ldsm_x4(va, vs + (wk + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
            const int r = qw + ((lane >> 4) << 3) + (lane & 7), c = kk * 16 + ((lane >> 3) & 1) * 8;
            tc::ldsm_x4(qb, qs + r * P + c);
            tc::ldsm_x4(ob, dos + r * P + c);
            tc::mma_bf16(st[0], ka, qb[0], qb[1]);
            tc::mma_bf16(st[1], ka, qb[2], qb[3]);
            tc::mma_bf16(dpt[0], va, ob[0], ob[1]);
            tc::mma_bf16(dpt[1], va, ob[2], ob[3]);
          }
          // p = exp(s - lse) * mask; st <- p * e, dpt <- p * (dp * e - delta)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int kc = wk + g + 8 * hr;
            const float mkv = mk[kc];
#pragma unroll
            for (int n = 0; n < 2; ++n) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int qi = qw + n * 8 + 2 * t + e;
                const float x = st[n][2 * hr + e] * p.scale + (mkv - 1.f) * 1e30f;
                const float pr = __expf(x - lse_s[qi]) * mkv;
                float ev = 1.f;
                if (p.dropout)
                  ev = healnet::hash_keep(seed, (uint32_t)row, (uint32_t)(q0c + qi),
                                          (uint32_t)(k0 + kc), p.threshold)
                           ? p.keep_scale
                           : 0.f;
                st[n][2 * hr + e] = pr * ev;
                dpt[n][2 * hr + e] = pr * (dpt[n][2 * hr + e] * ev - del_s[qi]);
              }
            }
          }
        }
        // round(p e) and round(ds) into the [key][query] tiles
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int off = (wk + g + 8 * hr) * kDsPitch + qh * 16 + n * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(pt + off) =
                tc::pack_bf16(st[n][2 * hr], st[n][2 * hr + 1]);
            *reinterpret_cast<uint32_t*>(dst + off) =
                tc::pack_bf16(dpt[n][2 * hr], dpt[n][2 * hr + 1]);
          }
        }
        __syncthreads();  // the tile's p^T and ds^T are complete

        // dv += round(p e)^T dO, dk += round(ds)^T q over the group's 32
        // queries: keys on M, the head dim on N, queries on K
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          uint32_t pa[4], da[4];
          tc::ldsm_x4(pa, pt + (wk + (lane & 15)) * kDsPitch + kq * 16 + (lane >> 4) * 8);
          tc::ldsm_x4(da, dst + (wk + (lane & 15)) * kDsPitch + kq * 16 + (lane >> 4) * 8);
          const int r = q0 + kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int n = qh + 2 * i;
            uint32_t ob[2], qb[2];
            tc::ldsm_x2_t(ob, dos + r * P + n * 8);
            tc::ldsm_x2_t(qb, qs + r * P + n * 8);
            tc::mma_bf16(dva[i], pa, ob[0], ob[1]);
            tc::mma_bf16(dka[i], da, qb[0], qb[1]);
          }
        }
        // dq += round(ds) K over the tile's 64 keys: queries on M (tile
        // warp % 2 of the group), the head dim on N, keys on K
        {
          const int mq = warp & 1;
          float dqa[NQ][4];
#pragma unroll
          for (int i = 0; i < NQ; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) dqa[i][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < tc::kKeyTile / 16; ++kk) {
            uint32_t a[4];
            tc::ldsm_x4_t(a, dst + (kk * 16 + ((lane >> 4) << 3) + (lane & 7)) * kDsPitch +
                                 mq * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int i = 0; i < NQ; ++i) {
              const int n = (warp >> 1) + 4 * i;
              if (n < NT) {
                uint32_t kb[2];
                tc::ldsm_x2_t(kb, ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + n * 8);
                tc::mma_bf16(dqa[i], a, kb[0], kb[1]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            const int n = (warp >> 1) + 4 * i;
            if (n < NT) {
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                float2* acc = reinterpret_cast<float2*>(
                    dq_s + (q0 + mq * 16 + g + 8 * hr) * AP + n * 8 + 2 * t);
                *acc = make_float2(acc->x + dqa[i][2 * hr], acc->y + dqa[i][2 * hr + 1]);
              }
            }
          }
        }
        if (grp + 1 < ngroups) __syncthreads();  // p^T and ds^T are rewritten by the next group
      }

      if (dk_acc != nullptr) {
        // this thread's fragments of dk and dv carried over the chunks in f32
        // (its own elements only, in chunk order); rounded on the last chunk
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int key = k0 + wk + g + 8 * hr;
          if (key >= kv_end) continue;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const size_t off = (size_t)key * DP + (qh + 2 * i) * 8 + 2 * t;
            float2* ck = reinterpret_cast<float2*>(dk_acc + off);
            float2* cv = reinterpret_cast<float2*>(dv_acc + off);
            if (!first) {
              const float2 a = *ck, b = *cv;
              dka[i][2 * hr] += a.x;
              dka[i][2 * hr + 1] += a.y;
              dva[i][2 * hr] += b.x;
              dva[i][2 * hr + 1] += b.y;
            }
            if (!last) {
              *ck = make_float2(dka[i][2 * hr], dka[i][2 * hr + 1]);
              *cv = make_float2(dva[i][2 * hr], dva[i][2 * hr + 1]);
            }
          }
        }
        if (!last) continue;  // uniform: dk and dv leave on the last chunk only
      }

      // the tile's dk and dv: the warps' fragments into the tile's ring stage
      // (unpacked, and not staged again before the next tile's first
      // barrier), packed at pitch d as the rows lie in device memory, then
      // written out by one bulk asynchronous copy each where the rows start
      // and end on 16 bytes, else with coalesced stores
      __nv_bfloat16* dvs = reinterpret_cast<__nv_bfloat16*>(ring + (it % S) * D::kStageWords);
      __nv_bfloat16* dks = dvs + tc::kKeyTile * DP;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int j = wk + g + 8 * hr;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = (qh + 2 * i) * 8 + 2 * t + e;
            if (c < p.d) {
              dvs[j * p.d + c] = __float2bfloat16(dva[i][2 * hr + e]);
              dks[j * p.d + c] = __float2bfloat16(dka[i][2 * hr + e] * p.scale);
            }
          }
        }
      }
      const int n = min(tc::kKeyTile, kv_end - k0) * p.d;
      __nv_bfloat16 *dv_out = dv + (size_t)k0 * p.d, *dk_out = dk + (size_t)k0 * p.d;
      const bool bulk =
          ((reinterpret_cast<uintptr_t>(dv_out) | reinterpret_cast<uintptr_t>(dk_out)) & 15) == 0 &&
          n % 8 == 0;
      if (bulk) tc::fence_proxy_async();
      __syncthreads();
      if (!bulk) {
        tc::store_rows(dv_out, dvs, n, tid);
        tc::store_rows(dk_out, dks, n, tid);
      } else if (tid == 0) {
        tc::bulk_store(dv_out, dvs, 2 * n);
        tc::bulk_store(dk_out, dks, 2 * n);
        tc::bulk_commit();
      }
    }
    if (tid == 0) tc::bulk_wait();
    tc::cp_async_wait(0);
    __syncthreads();  // every warp's dq sums are in
    // the chunk's dq: each block pushes its partial dq of element e = r d + c
    // to the block that owns e (rank e / share) through distributed shared
    // memory; the owner adds the parts in rank order, scales once and writes
    // them. No block touches another's shared memory after the last barrier.
    const int ne = nq * p.d, share = (ne + csize - 1) / csize;
    for (int e = tid; e < ne; e += tc::kThreads) {
      const int r = e / p.d, c = e - r * p.d, owner = e / share;
      tc::st_cluster(rdq + rank * share + e - owner * share, owner, dq_s[r * AP + c]);
    }
    cluster.sync();
    __nv_bfloat16* dq = p.dq + ((size_t)row * p.lq + q0c) * p.d;
    for (int e = rank * share + tid; e < min(ne, (rank + 1) * share); e += tc::kThreads) {
      float a = 0.f;
      for (int j = 0; j < csize; ++j) a += rdq[j * share + e - rank * share];
      dq[e] = __float2bfloat16(a * p.scale);
    }
    // before the next chunk pushes, every block is done reading this one's
    if (!last) cluster.sync();
  }  // chunk
}

}  // namespace

// The most queries a chunk of the FMA backward holds at head dim d (0 for
// d < 1).
extern "C" int healnet_flash_bwd_max_queries(int d) {
  if (d < 1 || d > fv::kMaxD) return 0;
  return fv::with_dp32(d, [](auto dp) -> int {
    return fma_bwd_max_queries<float, decltype(dp)::value>();
  });
}

namespace {

template <typename T, int DP>
cudaError_t launch_fma_bwd(FmaParams p, int cluster, int rows, cudaStream_t s) {
  p.stages = fma_bwd_stages<T, DP>(p.q_chunk);
  return tc::launch_clustered(flash_bwd_fma<T, DP>, p, cluster, rows,
                              FmaBwdLayout<T, DP>(p.stages, fma_rows(p.q_chunk)).total, s);
}

}  // namespace

// Clusters of `cluster` blocks of the FMA backward (query chunk lq) the
// card holds at once (-1 where the query fails, or for bf16 heads the
// tensor cores take).
extern "C" int healnet_flash_bwd_fma_max_clusters(int lq, int d, int is_bf16, int cluster) {
  if (d > fv::kMaxD) return -1;
  return fv::with_dp32(d, [&](auto dp) -> int {
    constexpr int DP = decltype(dp)::value;
    using B = __nv_bfloat16;
    if (!is_bf16)
      return tc::max_active_clusters(
          flash_bwd_fma<float, DP>, cluster,
          FmaBwdLayout<float, DP>(fma_bwd_stages<float, DP>(lq), fma_rows(lq)).total);
    if constexpr (DP > 128)
      return tc::max_active_clusters(
          flash_bwd_fma<B, DP>, cluster,
          FmaBwdLayout<B, DP>(fma_bwd_stages<B, DP>(lq), fma_rows(lq)).total);
    return -1;
  });
}

extern "C" int healnet_flash_backward(
    const void* q, const void* k, const void* v, const float* mask, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv, float* dkv_acc, int B,
    int H, int lq, int lkv, int d, int cluster, int keys_per_cta, int q_chunk, int n_chunks,
    long long q_sb, long long q_sh, long long q_st, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st, long long o_sb,
    long long o_sh, long long o_st, long long mask_sb, float scale, int dropout,
    const void* seed, unsigned int threshold, float keep_scale, int is_bf16, void* stream) {
  if (B * H <= 0 || lq <= 0) return 0;
  if (d < 1 || d > fv::kMaxD || (is_bf16 && d <= 128) || q_chunk < 1 ||
      q_chunk > fv::kGroup)
    return (int)cudaErrorInvalidValue;
  FmaParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dkv_acc = dkv_acc;
  p.H = H;
  p.lq = lq;
  p.lkv = lkv;
  p.d = d;
  p.keys_per_cta = keys_per_cta;
  p.q_chunk = q_chunk;
  p.n_chunks = n_chunks;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_st = q_st;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_st = k_st;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_st = v_st;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_st = o_st;
  p.mask_sb = mask_sb;
  p.scale = scale;
  p.dropout = dropout;
  p.seed = static_cast<const uint32_t*>(seed);
  p.threshold = threshold;
  p.keep_scale = keep_scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return static_cast<int>(fv::with_dp32(d, [&](auto dp) -> cudaError_t {
    constexpr int DP = decltype(dp)::value;
    if (!is_bf16) return launch_fma_bwd<float, DP>(p, cluster, B * H, s);
    if constexpr (DP > 128) return launch_fma_bwd<__nv_bfloat16, DP>(p, cluster, B * H, s);
    return cudaErrorInvalidValue;
  }));
}

extern "C" int healnet_flash_bwd_tc_max_queries(int d) {
  return tc::with_dp(d, [&](auto dp) -> int { return bwd_max_queries<decltype(dp)::value>(); });
}

extern "C" int healnet_flash_bwd_tc_max_clusters(int lq, int d, int cluster) {
  return tc::with_dp(d, [&](auto dp) -> int {
    constexpr int DP = decltype(dp)::value;
    return tc::max_active_clusters(flash_bwd_tc<DP>, cluster,
                                   BwdLayout<DP>(bwd_stages<DP>(lq), pad_queries(lq)).total);
  });
}

extern "C" int healnet_flash_backward_tc(
    const void* q, const void* k, const void* v, const float* mask, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv, float* dkv_acc, int B,
    int H, int lq, int lkv, int d, int cluster, int keys_per_cta, int q_chunk, int n_chunks,
    long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long o_sb, long long o_sh, long long o_st,
    long long mask_sb, float scale, int dropout, const void* seed, unsigned int threshold,
    float keep_scale, void* stream) {
  if (B * H <= 0 || lq <= 0) return 0;
  TcParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.mask = mask;
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dkv_acc = dkv_acc;
  p.H = H;
  p.lq = lq;
  p.lkv = lkv;
  p.d = d;
  p.keys_per_cta = keys_per_cta;
  p.q_chunk = q_chunk;
  p.n_chunks = n_chunks;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_st = q_st;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_st = k_st;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_st = v_st;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_st = o_st;
  p.mask_sb = mask_sb;
  p.scale = scale;
  p.dropout = dropout;
  p.seed = static_cast<const uint32_t*>(seed);
  p.threshold = threshold;
  p.keep_scale = keep_scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return static_cast<int>(tc::with_dp(d, [&](auto dp) -> cudaError_t {
    constexpr int DP = decltype(dp)::value;
    p.stages = bwd_stages<DP>(q_chunk);
    return tc::launch_clustered(flash_bwd_tc<DP>, p, cluster, B * H,
                                BwdLayout<DP>(p.stages, pad_queries(q_chunk)).total, s);
  }));
}

extern "C" const char* healnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
