// Flash cross-attention, forward and backward, for heads of 257-512
// channels: one pass over a block's keys per query group, each tile's
// scores taken once over the whole head, bf16 on tensor cores.
//
// Replaces: healnet_tpu/ops/flash_attention.py::_fwd_kernel (:98) and
// ::_bwd_kernel (:201) for heads wider than the one-pass kernels of
// flash_attention.cu / flash_attention_bwd.cu take (256). The Pallas kernels
// take any head dim; heads wider than kMaxD here keep the column-chunked
// flash_fwd_fma_chunked / flash_bwd_fma_chunked of those files. The wrapper
// (ops/flash_attention.py::flash_variant) picks the route from the dtype and
// d before the launch.
//
// Semantics kept from the TPU kernels (and the other flash kernels):
//   - a masked key scores s * scale - 1e30 and its probability is multiplied
//     by the mask; a row whose keys are all masked outputs 0 and gets zero
//     gradients;
//   - the softmax denominator is taken before dropout; dropout multiplies a
//     probability by keep / (1 - rate), keep from hash_keep over the absolute
//     (batch*head row, query, key) coordinates, bit-equal to JAX;
//   - p (and in the backward round(p e) and round(ds)) is rounded to the
//     input dtype before its products; the forward writes the log-sum-exp
//     beside the output; the backward takes delta = rowsum(dO * O) from the
//     wrapper;
//   - any lq (the forward walks groups of 32 queries, the backward chunks
//     sized by healnet_flash_wide_bwd_max_queries); no float atomics: two
//     calls give the same bits.
//
// Bound on an H100 SXM at (b*h 8, lq 17, lkv 4096, d 320), K and V column
// slices of a merged KV buffer: the forward reads K and V once (42 MB in
// f32, 21 MB in bf16) and q, writes out and the log-sum-exp: 0.0251 ms (f32)
// / 0.0126 ms (bf16) at 3.35 TB/s, against 0.18 GFLOP (2.7 us of f32 FMA,
// 0.2 us of bf16 tensor-core time). The backward also reads dO and writes
// dk and dv: 0.0502 / 0.0251 ms. Bytes bound both.
//
// What the chunked kernels did, and what this design does about it. They
// loop over 256-column output chunks and, inside each, walk every tile
// again, summing the scores over every column chunk (two passes over K and
// two sets of score FMAs at d 320), reload the group's q from device memory
// for every tile, load K and V with synchronous thread loads (no ring, one
// block an SM, nothing hides the latency), widen bf16 to f32 on the CUDA
// cores, and merge the cluster once per output chunk. Here:
//   - the group's q rows (and in the backward dO, lse, delta) are staged in
//     shared memory once per group, over the whole head;
//   - K and V stream once through a cp.async ring of 16-byte hull copies
//     (the slices sit at any 2- or 4-byte offset of the merged KV buffer;
//     kirp's pitch is 270), a warp a row; a landed row is shifted in place to
//     the start of its slot, whose pitch (DP + 8 bf16, DP + 4 f32) is the
//     hull's, and where the rows start on 16 bytes and fill the padded head
//     a whole tile is used as it lands, with no shift and no barrier: the
//     copy of the next tiles overlaps this tile's products;
//   - each tile's scores are taken once over the whole head; p (and round(p
//     e), round(ds)) go to shared memory;
//   - the accumulators of the whole head stay in registers across the key
//     loop: bf16 splits the value product (and dq, dk, dv) over warps by
//     output columns (m16n8k16 mma.sync, bf16 in, f32 accumulate; queries
//     pad to m16 tiles and d to a multiple of 16, with zeros in shared memory
//     only); f32 stays on CUDA-core FMAs (TF32 would break the 2e-5 forward
//     contract): each warp owns query rows, its lanes one key for the scores
//     and columns lane + 32 i for the products, and the backward's dk and dv
//     of a tile are split over the threads by key quad and column;
//   - each tile's dk and dv are finished over the whole head in one visit,
//     staged in the tile's spent stage and written by bulk asynchronous
//     copies, a row each (carried over query chunks in the dkv_acc scratch,
//     each element by one thread, as flash_bwd_fma does);
//   - the cluster merges once per query group, as flash_fwd_fma does; where
//     the ring and the pushed states do not both fit, the pushed states alias
//     the ring behind one more cluster barrier.
// Tiles: 32 keys for bf16 (one a lane in the softmax), 16 for f32 (a lane
// takes one key over half the head, the halves added by a shuffle). Stages
// and the backward's query chunk are sized from shared memory. One block an
// SM (the head's accumulators take up to 64 registers a thread; 8 warps, 16
// in the f32 backward), so the plan's clusters take any size up to 16: 9 at
// 8 rows, where clusters of 10-16 are resident only 7 at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"
#include "hash_dropout.cuh"

#ifndef WIDE_PHASE  // clock64 phase markers of scripts/profile_flash_phases.py
#define WIDE_PHASE(k)
#define WIDE_PHASE_INIT()
#define WIDE_PHASE_FLUSH()
#endif

namespace {

namespace tc = healnet::tc;
namespace fv = healnet::tc::fmav;
using bf16 = __nv_bfloat16;

constexpr int kMaxD = 512;   // the widest head these kernels take
constexpr int kGroup = 32;   // queries a block holds at once: two m16 tiles
constexpr int kMaxCpl = kMaxD / 32;  // columns lane + 32 i a lane owns (f32)
constexpr float kNegBig = tc::kNegBig;

// Warps a block: 8, and 16 for the f32 backward, whose dk and dv products
// split over more warps (two query rows a warp, at most 128 registers a
// thread; 16 warps slowed the f32 forward, whose warps reread K for fewer
// rows). One block an SM either way.
constexpr int kWarps = 8;
constexpr int kBwdF32Warps = 16;
constexpr int kMaxNt = kMaxD / 8 / kWarps;  // n8 column tiles a warp owns (bf16)

// Per dtype: keys a tile, the multiple the head pads to, the row pitch's
// padding (a row of DP + kPad elements is a whole number of 16-byte chunks,
// odd in 16-byte units, and one more chunk than the padded head: a row's
// 16-byte hull fits its slot).
template <typename T>
struct Wide;
template <>
struct Wide<bf16> {
  static constexpr int kKeys = 32, kAlign = 16, kPad = 8;
};
template <>
struct Wide<float> {
  static constexpr int kKeys = 16, kAlign = 32, kPad = 4;
};

__host__ __device__ inline int pad_dim(int d, int align) {
  return (d + align - 1) / align * align;
}

template <typename T>
__host__ __device__ inline size_t row_bytes(int dp) {
  return sizeof(T) * (size_t)(dp + Wide<T>::kPad);
}

// A ring stage: K rows, V rows, the tile's mask
template <typename T>
__host__ __device__ inline size_t stage_bytes(int dp) {
  return 2 * Wide<T>::kKeys * row_bytes<T>(dp) + sizeof(float) * Wide<T>::kKeys;
}

__host__ __device__ inline size_t max_sz(size_t a, size_t b) { return a > b ? a : b; }

// Byte offsets of the forward's shared memory: the ring at 0, the cluster's
// pushed acc (racc; at 0 where it aliases the ring), the group's q rows, the
// scores (bf16 only), p, the rows' softmax corrections and the pushed (m, l).
template <typename T>
struct FwdLayout {
  size_t racc, qs, sc, ps, corr, rm, rl, total;
  __host__ __device__ FwdLayout(int dp, int stages, bool alias) {
    constexpr int KT = Wide<T>::kKeys;
    constexpr bool kTc = sizeof(T) == 2;
    const size_t ring = stages * stage_bytes<T>(dp);
    const size_t acc = tc::align16(sizeof(float) * ((size_t)kGroup * dp + tc::kMaxCluster));
    racc = alias ? 0 : ring;
    qs = alias ? max_sz(ring, acc) : ring + acc;
    sc = qs + kGroup * row_bytes<T>(dp);
    ps = sc + (kTc ? sizeof(float) * kGroup * (KT + 4) : 0);
    corr = ps + (kTc ? sizeof(bf16) * kGroup * (KT + 8) : sizeof(float) * kGroup * KT);
    rm = corr + sizeof(float) * kGroup;
    rl = rm + sizeof(float) * tc::kMaxCluster * kGroup;
    total = rl + sizeof(float) * tc::kMaxCluster * kGroup;
  }
};

// Byte offsets of the backward's shared memory (rows: chunk_rows of the
// query chunk): the ring at 0, the cluster's pushed dq (rdq; at 0 where it
// aliases the ring), q, dO, lse, delta, and round(p e) and round(ds)
// ([key][query] bf16 for the mma operands, [query][key] f32).
template <typename T>
struct BwdLayout {
  size_t rdq, qs, dos, lse, del, pd, total;
  __host__ __device__ BwdLayout(int dp, int rows, int stages, bool alias) {
    constexpr int KT = Wide<T>::kKeys;
    constexpr bool kTc = sizeof(T) == 2;
    const size_t ring = stages * stage_bytes<T>(dp);
    const size_t dq = tc::align16(sizeof(float) * ((size_t)rows * dp + tc::kMaxCluster));
    rdq = alias ? 0 : ring;
    qs = alias ? max_sz(ring, dq) : ring + dq;
    dos = qs + rows * row_bytes<T>(dp);
    lse = dos + rows * row_bytes<T>(dp);
    del = lse + sizeof(float) * rows;
    pd = tc::align16(del + sizeof(float) * rows);
    total = pd + (kTc ? 2 * sizeof(bf16) * KT * (rows + 8) : 2 * sizeof(float) * rows * KT);
  }
};

// A kernel's ring depth and aliasing for its layout: the most stages (4 to
// 2) beside separate pushed states, else the most behind which they alias
// the ring; (0, ...) where not even that fits.
struct Plan {
  int stages, alias;
  size_t smem;
};

template <typename Layout>
Plan pick_plan(Layout layout) {
  for (int alias = 0; alias < 2; ++alias)
    for (int s = 4; s >= 2; --s) {
      const size_t total = layout(s, alias != 0).total;
      if (total <= tc::kMaxSmem) return {s, alias, total};
    }
  return {0, 0, 0};
}

template <typename T>
Plan fwd_plan(int d) {
  const int dp = pad_dim(d, Wide<T>::kAlign);
  return pick_plan([dp](int s, bool a) { return FwdLayout<T>(dp, s, a); });
}

template <typename T>
Plan bwd_plan(int d, int rows) {
  const int dp = pad_dim(d, Wide<T>::kAlign);
  return pick_plan([dp, rows](int s, bool a) { return BwdLayout<T>(dp, rows, s, a); });
}

// the backward's rows for a query chunk: bf16 pads to m16 tiles; f32 takes
// the chunk's rows alone (its warps touch no row past the chunk)
template <typename T>
__host__ __device__ inline int chunk_rows(int chunk) {
  return sizeof(T) == 2 ? pad_dim(chunk, 16) : chunk;
}

// ldmatrix x2 (not transposed): matrices from the row addresses of lanes
// 0-7 and 8-15
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(tc::smem_addr(p))
               : "memory");
}

// Issue the copies of keys [k0, min(k0 + KT, kv_end)) of K and V and of
// their mask values into ring stage `st`: stage row r is K (r < KT) or V of
// key k0 + r % KT, copied as the 16-byte chunks that hold part of it (its
// 16-byte-aligned hull; a chunk holding one byte of the row lies in the
// row's page, so the hull never faults), at pitch row_bytes<T>(dp). A warp
// takes a row, its lanes consecutive chunks.
template <typename T, int NW>
__device__ __forceinline__ void stage_kv(char* st, const T* k, long long k_st, const T* v,
                                         long long v_st, const float* mask, int k0, int kv_end,
                                         int d, int dp, int tid) {
  constexpr int KT = Wide<T>::kKeys;
  const int rb = (int)row_bytes<T>(dp), lane = tid & 31;
  for (int r = tid >> 5; r < 2 * KT; r += NW) {
    const int key = k0 + (r & (KT - 1));
    if (key >= kv_end) continue;
    const uintptr_t row = reinterpret_cast<uintptr_t>(r < KT ? k + key * k_st : v + key * v_st);
    const int n = (int)(((row & 15) + sizeof(T) * (uintptr_t)d + 15) >> 4);
    const char* src = reinterpret_cast<const char*>(row & ~uintptr_t(15));
    char* dst = st + (size_t)r * rb;
    for (int c = lane; c < n; c += 32) tc::cp_async16(dst + 16 * c, src + 16 * c);
  }
  if (mask != nullptr && tid < KT && k0 + tid < kv_end)
    tc::cp_async4(st + 2 * KT * rb + sizeof(float) * tid, mask + k0 + tid);
}

// Turn a landed stage into aligned tiles in place: each row's bytes shifted
// from its hull offset to the start of its slot (a warp a row, every lane's
// reads of the row before its writes), columns d..DP-1 and keys at or past
// kv_end zero, and the mask slot the tile's mask (1 without a mask, 0 past
// kv_end). A row already 16-byte aligned has only its tail cleared.
template <typename T, int NW>
__device__ __forceinline__ void shift_stage(char* st, const T* k, long long k_st, const T* v,
                                            long long v_st, bool has_mask, int k0, int kv_end,
                                            int d, int dp, int tid) {
  constexpr int KT = Wide<T>::kKeys, PER = kMaxD * (int)sizeof(T) / 16 / 32;
  const int lane = tid & 31, warp = tid >> 5;
  const int rb = (int)row_bytes<T>(dp), nc = dp * (int)sizeof(T) / 16;
  const int db = d * (int)sizeof(T);
  for (int r = warp; r < 2 * KT; r += NW) {
    const int key = k0 + (r & (KT - 1));
    const bool live = key < kv_end;
    const int s = live ? (int)(reinterpret_cast<uintptr_t>(r < KT ? k + key * k_st
                                                                  : v + key * v_st) & 15)
                       : 0;
    uint4* row = reinterpret_cast<uint4*>(st + (size_t)r * rb);
    uint4 o[PER];
    bool put[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + 32 * j;
      o[j] = make_uint4(0u, 0u, 0u, 0u);
      put[j] = c < nc && (!live || s != 0 || 16 * c + 16 > db);
      if (put[j] && live) {
        uint32_t w[4];
        if (s == 0) {
          const uint4 a = row[c];
          w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
        } else {
          const uint4 a = row[c], b = row[c + 1];
          const uint32_t win[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
          const bool two = s & 8, one = s & 4, half = s & 2;
          uint32_t sel[5];  // hull words s / 4 + e of the window
#pragma unroll
          for (int e = 0; e < 5; ++e) {
            const uint32_t lo = two ? win[e + 2] : win[e];
            const uint32_t hi = two ? win[e + 3] : win[e + 1];
            sel[e] = one ? hi : lo;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[e] = half ? __byte_perm(sel[e], sel[e + 1], 0x5432) : sel[e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b0 = 16 * c + 4 * e;  // the word's first byte in the row
          w[e] = b0 + 4 <= db ? w[e] : b0 + 2 == db ? (w[e] & 0xFFFFu) : 0u;
        }
        o[j] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (put[j]) row[lane + 32 * j] = o[j];
  }
  if (tid < KT) {
    float* mk = reinterpret_cast<float*>(st + 2 * KT * rb);
    mk[tid] = k0 + tid >= kv_end ? 0.f : has_mask ? mk[tid] : 1.f;
  }
}

// Rows [r0, r0 + rows) of a strided (n x d) matrix into shared memory at
// pitch dp + kPad, a warp a row; rows at or past n and columns d..dp-1 are
// zero.
template <typename T, int NW>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long st, int r0, int rows,
                                          int n, int d, int dp, int tid) {
  const int pitch = dp + Wide<T>::kPad, lane = tid & 31;
  for (int r = tid >> 5; r < rows; r += NW) {
    const T* row = r0 + r < n ? src + (r0 + r) * st : nullptr;
    for (int c = lane; c < dp; c += 32)
      dst[r * pitch + c] = (row != nullptr && c < d) ? row[c] : fv::from_float<T>(0.f);
  }
}

__device__ __forceinline__ float warp_sum(float x, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The slots of warp `warp` among n query rows (row r in warp r % NW).
template <int NW>
__device__ __forceinline__ int slots_of(int warp, int n) {
  return warp < n ? (n - 1 - warp) / NW + 1 : 0;
}

__device__ __forceinline__ float keep(uint32_t seed, int row, int q, int kv, uint32_t threshold,
                                      float scale) {
  return healnet::hash_keep(seed, (uint32_t)row, (uint32_t)q, (uint32_t)kv, threshold) ? scale
                                                                                         : 0.f;
}

// ------------------------------------------------------------------ forward

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;  // (B, lkv) or null
  void* out;          // (B, lq, H, d)
  float* lse;         // (B*H, lq)
  int H, lq, lkv, d, keys_per_cta, stages, alias;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, mask_sb;
  float scale;
  int dropout;
  uint32_t seed, threshold;
  float keep_scale;
};

// Push a row's (m, l) to every block of the cluster (lanes < csize of the
// row's warp).
__device__ __forceinline__ void push_ml(float* rm, float* rl, int rank, int csize, int r, float m,
                                        float l, int lane) {
  if (lane < csize) {
    tc::st_cluster(rm + rank * kGroup + r, lane, m);
    tc::st_cluster(rl + rank * kGroup + r, lane, l);
  }
}

// Push acc of output element e = r d + c to the block that owns e (rank
// e / share).
__device__ __forceinline__ void push_elem(float* buf, int rank, int share, int e, float x) {
  const int owner = e / share;
  tc::st_cluster(buf + rank * share + e - owner * share, owner, x);
}

// This block's share of the group's output, after the cluster barrier: the
// blocks' (m, l, acc) merged in rank order from its own shared memory, and
// the log-sum-exp.
template <typename T, int NW>
__device__ __forceinline__ void merge_out(const FwdParams& p, const float* rm, const float* rl,
                                          const float* racc, int rank, int csize, int row, int b,
                                          int h, int g0, int nq) {
  const int ne = nq * p.d, share = (ne + csize - 1) / csize;
  T* out = static_cast<T*>(p.out);
  for (int e = rank * share + threadIdx.x; e < min(ne, (rank + 1) * share);
       e += 32 * NW) {
    const int r = e / p.d, c = e - r * p.d;
    float mx = kNegBig;
    for (int j = 0; j < csize; ++j) mx = fmaxf(mx, rm[j * kGroup + r]);
    float a = 0.f, ls = 0.f;
    for (int j = 0; j < csize; ++j) {
      const float f = expf(rm[j * kGroup + r] - mx);
      a += racc[j * share + e - rank * share] * f;
      ls += rl[j * kGroup + r] * f;
    }
    const float lc = fmaxf(ls, 1e-30f);
    out[((size_t)(b * p.lq + g0 + r) * p.H + h) * p.d + c] = fv::from_float<T>(a / lc);
    if (c == 0) p.lse[(size_t)row * p.lq + g0 + r] = mx + logf(lc);
  }
}

// What every kernel of this file knows of its block: its cluster rank, its
// batch*head row, its keys and tiles.
template <typename T>
struct Block {
  int rank, csize, row, b, h, kv_begin, kv_end, ntiles;
  // K and V rows start on 16 bytes and fill their padded width: a landed
  // whole tile is already aligned, zero-padded tiles
  bool aligned;
  const T *q, *k, *v;
  const float* mask;
  template <typename Params>
  __device__ Block(const Params& p, const tc::cg::cluster_group& cluster) {
    rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
    row = blockIdx.y, b = row / p.H, h = row - b * p.H;
    q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
    mask = p.mask ? p.mask + b * p.mask_sb : nullptr;
    kv_begin = rank * p.keys_per_cta;
    kv_end = min(p.lkv, kv_begin + p.keys_per_cta);
    constexpr int KT = Wide<T>::kKeys;
    ntiles = kv_end > kv_begin ? (kv_end - kv_begin + KT - 1) / KT : 0;
    aligned = ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0 &&
              ((p.k_st * sizeof(T)) & 15) == 0 && ((p.v_st * sizeof(T)) & 15) == 0 &&
              p.d % Wide<T>::kAlign == 0;
  }
};

// A landed ring stage, ready for the products: its K rows at 0, V rows
// after them, its mask slot after those; `slot`: whether the slot holds the
// tile's mask (else every key of the tile attends).
struct Tile {
  char* st;
  bool slot;
  __device__ __forceinline__ float mask(const float* mk, int j) const {
    return slot ? mk[j] : 1.f;
  }
};

// The ring's tile it, ready: waits for it to land (one block barrier, after
// which every warp is done with tile it - 1 and its stage, and the bulk
// stores of a spent stage have read it), issues tile it + stages - 1 into
// that stage, and unless the tile is whole and aligned (Block::aligned)
// shifts it into aligned tiles and ends with a block barrier.
template <typename T, int NW, typename Params>
__device__ __forceinline__ Tile next_tile(const Params& p, const Block<T>& blk, char* ring,
                                          int dp, int it) {
  constexpr int KT = Wide<T>::kKeys;
  const int St = p.stages, tid = threadIdx.x, k0 = blk.kv_begin + it * KT;
  const size_t sb = stage_bytes<T>(dp);
  tc::cp_async_wait(St - 2);
  if (tid < KT) tc::bulk_wait_read();
  __syncthreads();
  WIDE_PHASE(2);
  const int nxt = it + St - 1;
  if (nxt < blk.ntiles)
    stage_kv<T, NW>(ring + (nxt % St) * sb, blk.k, p.k_st, blk.v, p.v_st, blk.mask,
                    blk.kv_begin + nxt * KT, blk.kv_end, p.d, dp, tid);
  tc::cp_async_commit();
  WIDE_PHASE(3);
  char* st = ring + (it % St) * sb;
  if (blk.aligned && k0 + KT <= blk.kv_end) {
    WIDE_PHASE(4);
    return {st, blk.mask != nullptr};
  }
  shift_stage<T, NW>(st, blk.k, p.k_st, blk.v, p.v_st, blk.mask != nullptr, k0, blk.kv_end, p.d,
                     dp, tid);
  __syncthreads();
  WIDE_PHASE(4);
  return {st, true};
}

// The first stages - 1 tiles of a pass over the block's keys, issued.
template <typename T, int NW, typename Params>
__device__ __forceinline__ void prime_ring(const Params& p, const Block<T>& blk, char* ring,
                                           int dp) {
  constexpr int KT = Wide<T>::kKeys;
  const size_t sb = stage_bytes<T>(dp);
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < blk.ntiles)
      stage_kv<T, NW>(ring + s * sb, blk.k, p.k_st, blk.v, p.v_st, blk.mask,
                      blk.kv_begin + s * KT, blk.kv_end, p.d, dp, threadIdx.x);
    tc::cp_async_commit();
  }
}

// bf16 on tensor cores. Per 32-key tile: S = Q K^T with warp w on query
// tile w / 4 and keys 8 (w % 4) .. + 7 (f32 scores into shared memory); the
// online softmax of row r by warp r % 8, a key a lane (m and l in
// registers; round(p e) into shared memory, the row's correction beside
// it); then acc = acc * corr + P V on the warp's n8 column tiles
// [w * ntw, (w + 1) * ntw) of every query tile, in registers across the
// key loop.
__global__ void __launch_bounds__(32 * kWarps, 1) flash_fwd_wide_tc(FwdParams p) {
  constexpr int KT = Wide<bf16>::kKeys, SP = KT + 4, PP = KT + 8, kThreads = 32 * kWarps;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  WIDE_PHASE_INIT();
  const int dp = pad_dim(p.d, 16), P = dp + 8, nt8 = dp / 8, ntw = (nt8 + kWarps - 1) / kWarps;
  const FwdLayout<bf16> L(dp, p.stages, p.alias != 0);
  char* ring = reinterpret_cast<char*>(wide_smem);
  bf16* qs = reinterpret_cast<bf16*>(wide_smem + L.qs);
  float* sc = reinterpret_cast<float*>(wide_smem + L.sc);
  bf16* ps = reinterpret_cast<bf16*>(wide_smem + L.ps);
  float* corr_s = reinterpret_cast<float*>(wide_smem + L.corr);
  float* rm = reinterpret_cast<float*>(wide_smem + L.rm);
  float* rl = reinterpret_cast<float*>(wide_smem + L.rl);
  float* racc = reinterpret_cast<float*>(wide_smem + L.racc);

  tc::cg::cluster_group cluster = tc::cg::this_cluster();
  const Block<bf16> blk(p, cluster);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int n0 = warp * ntw;

  for (int g0 = 0; g0 < p.lq; g0 += kGroup) {
    const int nq = min(kGroup, p.lq - g0), nmt = (nq + 15) >> 4;
    prime_ring<bf16, kWarps>(p, blk, ring, dp);
    load_rows<bf16, kWarps>(qs, blk.q, p.q_st, g0, kGroup, p.lq, p.d, dp, tid);
    for (int i = tid; i < kGroup * PP; i += kThreads) ps[i] = __float2bfloat16(0.f);
    if (tid < kGroup) corr_s[tid] = 1.f;
    float m[4], l[4], acc[2][kMaxNt][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) m[s] = kNegBig, l[s] = 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < kMaxNt; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;
    WIDE_PHASE(1);

    for (int it = 0; it < blk.ntiles; ++it) {
      const Tile tile = next_tile<bf16, kWarps>(p, blk, ring, dp, it);
      const bf16* ks = reinterpret_cast<const bf16*>(tile.st);
      const bf16* vs = ks + KT * P;
      const float* mk = reinterpret_cast<const float*>(tile.st + 2 * KT * sizeof(bf16) * P);
      const int k0 = blk.kv_begin + it * KT;
      {  // scores of the warp's 16 queries and 8 keys over the whole head
        const int mt = warp >> 2, nk = (warp & 3) * 8;
        if (mt < nmt) {
          float s4[4] = {0.f, 0.f, 0.f, 0.f};
          const bf16* qa_row = qs + (mt * 16 + (lane & 15)) * P + (lane >> 4) * 8;
          const bf16* kb_row = ks + (nk + (lane & 7)) * P + ((lane >> 3) & 1) * 8;
#pragma unroll 4
          for (int kk = 0; kk < dp / 16; ++kk) {
            uint32_t qa[4], kb[2];
            tc::ldsm_x4(qa, qa_row + kk * 16);
            ldsm_x2(kb, kb_row + kk * 16);
            tc::mma_bf16(s4, qa, kb[0], kb[1]);
          }
          *reinterpret_cast<float2*>(sc + (mt * 16 + g) * SP + nk + 2 * t) =
              make_float2(s4[0], s4[1]);
          *reinterpret_cast<float2*>(sc + (mt * 16 + g + 8) * SP + nk + 2 * t) =
              make_float2(s4[2], s4[3]);
        }
      }
      __syncthreads();
      WIDE_PHASE(5);
      {  // online softmax of the warp's rows, one key a lane
        const float mkv = tile.mask(mk, lane);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int r = warp + kWarps * s;
          if (r < nq) {
            const float x = sc[r * SP + lane] * p.scale + (mkv - 1.f) * 1e30f;
            const float m_new = fmaxf(m[s], warp_max(x, 32)), corr = __expf(m[s] - m_new);
            m[s] = m_new;
            float pr = __expf(x - m_new) * mkv;
            l[s] = l[s] * corr + pr;  // the lane's key; the warp sums at the end
            if (p.dropout)
              pr *= keep(p.seed, blk.row, g0 + r, k0 + lane, p.threshold, p.keep_scale);
            ps[r * PP + lane] = __float2bfloat16(pr);
            if (lane == 0) corr_s[r] = corr;
          }
        }
      }
      __syncthreads();
      WIDE_PHASE(6);
      // acc = acc * corr + P V on the warp's column tiles
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt < nmt) {
          const float c0 = corr_s[mt * 16 + g], c1 = corr_s[mt * 16 + g + 8];
#pragma unroll
          for (int i = 0; i < kMaxNt; ++i) {
            acc[mt][i][0] *= c0, acc[mt][i][1] *= c0;
            acc[mt][i][2] *= c1, acc[mt][i][3] *= c1;
          }
#pragma unroll
          for (int k16 = 0; k16 < KT / 16; ++k16) {
            uint32_t pa[4];
            tc::ldsm_x4(pa, ps + (mt * 16 + (lane & 15)) * PP + k16 * 16 + (lane >> 4) * 8);
            const bf16* vrow = vs + (k16 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P;
#pragma unroll
            for (int i = 0; i < kMaxNt; ++i) {
              const int n = n0 + i;
              if (i < ntw && n < nt8) {
                uint32_t vb[2];
                tc::ldsm_x2_t(vb, vrow + n * 8);
                tc::mma_bf16(acc[mt][i], pa, vb[0], vb[1]);
              }
            }
          }
        }
      }
      WIDE_PHASE(7);
    }
    tc::cp_async_wait(0);  // only empty groups are left
    // where the pushed acc aliases the ring, every block of the cluster is
    // done with its ring before any block pushes into it
    if (p.alias) cluster.sync();
    const int share = (nq * p.d + blk.csize - 1) / blk.csize;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int r = warp + kWarps * s;
      if (r < nq) push_ml(rm, rl, blk.rank, blk.csize, r, m[s], warp_sum(l[s], 32), lane);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < kMaxNt; ++i) {
        const int n = n0 + i;
        if (mt < nmt && i < ntw && n < nt8)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = mt * 16 + g + 8 * (e >> 1), c = n * 8 + 2 * t + (e & 1);
            if (r < nq && c < p.d) push_elem(racc, blk.rank, share, r * p.d + c, acc[mt][i][e]);
          }
      }
    WIDE_PHASE(8);
    cluster.sync();
    WIDE_PHASE(9);
    merge_out<bf16, kWarps>(p, rm, rl, racc, blk.rank, blk.csize, blk.row, blk.b, blk.h, g0, nq);
    WIDE_PHASE(10);
    // before the next group pushes, every block is done reading this one's
    if (g0 + kGroup < p.lq) cluster.sync();
    WIDE_PHASE(11);
  }
  WIDE_PHASE_FLUSH();
}

// f32 on the CUDA cores, the key loop and push of one query group for a
// warp that owns NS of its rows (row r by warp r % 8, slot r / 8). Per
// 16-key tile: lane l takes key l % 16 over the float4 chunks of half l / 16
// of the head (the halves added by a shuffle), the online softmax runs in
// registers and shuffles, p goes to the warp's rows in shared memory, and
// acc += p V over columns lane + 32 i, all in registers across the loop.
template <int NS>
__device__ __forceinline__ void fwd_f32_group(const FwdParams& p, const Block<float>& blk,
                                              tc::cg::cluster_group& cluster, char* ring,
                                              const float* qs, float* ps, float* rm, float* rl,
                                              float* racc, int dp, int g0, int nq) {
  constexpr int KT = Wide<float>::kKeys, NSA = NS > 0 ? NS : 1;
  const int P = dp + 4, cpl = dp / 32, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int key = lane & 15, half = lane >> 4;
  float* pw = ps + warp * (kGroup / kWarps) * KT;  // the warp's p rows [slot][key]
  float m[NSA], l[NSA], a[NSA][kMaxCpl];
#pragma unroll
  for (int s = 0; s < NSA; ++s) {
    m[s] = kNegBig, l[s] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxCpl; ++i) a[s][i] = 0.f;
  }
  WIDE_PHASE(1);
  for (int it = 0; it < blk.ntiles; ++it) {
    const Tile tile = next_tile<float, kWarps>(p, blk, ring, dp, it);
    if constexpr (NS > 0) {
      const float* ks = reinterpret_cast<const float*>(tile.st);
      const float* vs = ks + KT * P;
      const float mkv = tile.mask(vs + KT * P, key);
      const int k0 = blk.kv_begin + it * KT;
      float sc[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) sc[s] = 0.f;
      const float* kr = ks + key * P;
#pragma unroll 4
      for (int c = 4 * half; c < dp; c += 8) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + (warp + kWarps * s) * P + c);
          float x = sc[s];
          x = fmaf(qv.x, kv.x, x);
          x = fmaf(qv.y, kv.y, x);
          x = fmaf(qv.z, kv.z, x);
          x = fmaf(qv.w, kv.w, x);
          sc[s] = x;
        }
      }
      WIDE_PHASE(5);
      float x[NS], mx[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        sc[s] += __shfl_xor_sync(0xffffffffu, sc[s], 16);
        mx[s] = x[s] = sc[s] * p.scale + (mkv - 1.f) * 1e30f;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
#pragma unroll
        for (int s = 0; s < NS; ++s) mx[s] = fmaxf(mx[s], __shfl_xor_sync(0xffffffffu, mx[s], off));
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float m_new = fmaxf(m[s], mx[s]), corr = __expf(m[s] - m_new);
        m[s] = m_new;
        x[s] = __expf(x[s] - m_new) * mkv;
        l[s] = l[s] * corr + x[s];  // the lane's key (twice in the warp); summed at the end
#pragma unroll
        for (int i = 0; i < kMaxCpl; ++i) a[s][i] *= corr;
        if (p.dropout)
          x[s] *= keep(p.seed, blk.row, g0 + warp + kWarps * s, k0 + key, p.threshold,
                       p.keep_scale);
        if (half == 0) pw[s * KT + key] = x[s];
      }
      __syncwarp();
      WIDE_PHASE(6);
#pragma unroll
      for (int j = 0; j < KT; j += 4) {
        float4 pv[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) pv[s] = *reinterpret_cast<const float4*>(pw + s * KT + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* vr = vs + (j + jj) * P + lane;
#pragma unroll
          for (int i = 0; i < kMaxCpl; ++i) {
            if (i < cpl) {
              const float vv = vr[32 * i];
#pragma unroll
              for (int s = 0; s < NS; ++s) a[s][i] = fmaf(fv::at(pv[s], jj), vv, a[s][i]);
            }
          }
        }
      }
      WIDE_PHASE(7);
    }
  }
  tc::cp_async_wait(0);  // only empty groups are left
  if (p.alias) cluster.sync();
  const int share = (nq * p.d + blk.csize - 1) / blk.csize;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int r = warp + kWarps * s;
    push_ml(rm, rl, blk.rank, blk.csize, r, m[s], warp_sum(l[s], 16), lane);
#pragma unroll
    for (int i = 0; i < kMaxCpl; ++i) {
      const int c = lane + 32 * i;
      if (i < cpl && c < p.d) push_elem(racc, blk.rank, share, r * p.d + c, a[s][i]);
    }
  }
}

__global__ void __launch_bounds__(32 * kWarps, 1) flash_fwd_wide_fma(FwdParams p) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  WIDE_PHASE_INIT();
  const int dp = pad_dim(p.d, 32);
  const FwdLayout<float> L(dp, p.stages, p.alias != 0);
  char* ring = reinterpret_cast<char*>(wide_smem);
  float* qs = reinterpret_cast<float*>(wide_smem + L.qs);
  float* ps = reinterpret_cast<float*>(wide_smem + L.ps);
  float* rm = reinterpret_cast<float*>(wide_smem + L.rm);
  float* rl = reinterpret_cast<float*>(wide_smem + L.rl);
  float* racc = reinterpret_cast<float*>(wide_smem + L.racc);
  tc::cg::cluster_group cluster = tc::cg::this_cluster();
  const Block<float> blk(p, cluster);
  const int warp = threadIdx.x >> 5;
  for (int g0 = 0; g0 < p.lq; g0 += kGroup) {
    const int nq = min(kGroup, p.lq - g0);
    prime_ring<float, kWarps>(p, blk, ring, dp);
    load_rows<float, kWarps>(qs, blk.q, p.q_st, g0, kGroup, p.lq, p.d, dp, threadIdx.x);
#define FWD_GROUP(NS) fwd_f32_group<NS>(p, blk, cluster, ring, qs, ps, rm, rl, racc, dp, g0, nq)
    switch (slots_of<kWarps>(warp, nq)) {
      case 0: FWD_GROUP(0); break;
      case 1: FWD_GROUP(1); break;
      case 2: FWD_GROUP(2); break;
      case 3: FWD_GROUP(3); break;
      default: FWD_GROUP(4); break;
    }
#undef FWD_GROUP
    WIDE_PHASE(8);
    cluster.sync();
    WIDE_PHASE(9);
    merge_out<float, kWarps>(p, rm, rl, racc, blk.rank, blk.csize, blk.row, blk.b, blk.h, g0, nq);
    WIDE_PHASE(10);
    if (g0 + kGroup < p.lq) cluster.sync();
    WIDE_PHASE(11);
  }
  WIDE_PHASE_FLUSH();
}

// ----------------------------------------------------------------- backward

struct BwdParams {
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
  int H, lq, lkv, d, keys_per_cta, stages, alias, q_chunk, n_chunks;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st, mask_sb;
  float scale;
  int dropout;
  uint32_t seed, threshold;
  float keep_scale;
};

// dk or dv elements (x0, and x1 where `pair`) of tile key j (key k0 + j;
// at or past kv_end: nothing), columns c and c + 1, summed over this query
// chunk: carried over the chunks in f32 by this thread alone, in chunk
// order, and on the last chunk staged (times `scale`) at stage[j P + c]
// for the tile's store (a stage row's pitch P is odd in 16-byte units, so
// the rows of one store fall on distinct banks).
template <typename T>
__device__ __forceinline__ void put_dkv(T* stage, int P, float* acc, int k0, int j, int kv_end,
                                        int c, int d, float x0, float x1, bool pair, float scale,
                                        bool first, bool last) {
  if (k0 + j >= kv_end || c >= d) return;
  pair = pair && c + 1 < d;
  if (acc != nullptr) {
    const size_t off = (size_t)(k0 + j) * d + c;
    if (!first) {
      x0 += acc[off];
      if (pair) x1 += acc[off + 1];
    }
    if (!last) {
      acc[off] = x0;
      if (pair) acc[off + 1] = x1;
      return;
    }
  }
  T* dst = stage + j * P + c;
  if constexpr (sizeof(T) == 2) {
    if (pair) {
      *reinterpret_cast<uint32_t*>(dst) = tc::pack_bf16(x0 * scale, x1 * scale);
      return;
    }
  }
  dst[0] = fv::from_float<T>(x0 * scale);
  if (pair) dst[1] = fv::from_float<T>(x1 * scale);
}

// The tile's staged dv and dk (rows j of the stage's V and K slots, pitch
// P; keys [k0, min(k0 + KT, kv_end))) written out after a block barrier,
// only on the last query chunk: a bulk asynchronous copy a row, thread j
// (< KT) issuing row j of both, where the rows start and end on 16 bytes
// (next_tile waits for them to read the stage before it is refilled), else
// a warp a row.
template <typename T, int NW>
__device__ __forceinline__ void store_dkv(const T* stage, int P, T* dk, T* dv, int k0,
                                          int kv_end, int d, bool last) {
  constexpr int KT = Wide<T>::kKeys;
  if (!last) return;
  const int nk = min(KT, kv_end - k0), bytes = d * (int)sizeof(T), tid = threadIdx.x;
  T *dv_out = dv + (size_t)k0 * d, *dk_out = dk + (size_t)k0 * d;
  const bool bulk = ((reinterpret_cast<uintptr_t>(dv_out) | reinterpret_cast<uintptr_t>(dk_out) |
                      bytes) & 15) == 0;
  if (bulk) tc::fence_proxy_async();
  __syncthreads();
  if (bulk) {
    if (tid < nk) {
      tc::bulk_store(dv_out + tid * d, stage + tid * P, bytes);
      tc::bulk_store(dk_out + tid * d, stage + (KT + tid) * P, bytes);
      tc::bulk_commit();
    }
    return;
  }
  for (int r = tid >> 5; r < 2 * nk; r += NW) {
    const int j = r < nk ? r : r - nk;
    const T* src = stage + (r < nk ? j : KT + j) * P;
    T* dst = (r < nk ? dv_out : dk_out) + (size_t)j * d;
    for (int c = tid & 31; c < d; c += 32) dst[c] = src[c];
  }
}

// The chunk's dq after the cluster barrier: the blocks' parts added in rank
// order, scaled once.
template <typename T, int NW>
__device__ __forceinline__ void merge_dq(const BwdParams& p, const float* rdq, int rank,
                                         int csize, int row, int q0c, int nq) {
  const int ne = nq * p.d, share = (ne + csize - 1) / csize;
  T* dq = static_cast<T*>(p.dq) + ((size_t)row * p.lq + q0c) * p.d;
  for (int e = rank * share + threadIdx.x; e < min(ne, (rank + 1) * share);
       e += 32 * NW) {
    float a = 0.f;
    for (int j = 0; j < csize; ++j) a += rdq[j * share + e - rank * share];
    dq[e] = fv::from_float<T>(a * p.scale);
  }
}

// The per-chunk prologue both backward kernels share: q, dO, lse and delta
// of the chunk's rows (padded queries: q = dO = 0, lse = 1e30 so that their
// probabilities are 0, delta = 0).
template <typename T, int NW>
__device__ __forceinline__ void load_chunk(const BwdParams& p, const Block<T>& blk, const T* dout,
                                           T* qs, T* dos, float* lse_s, float* del_s, int rows,
                                           int q0c, int nq, int dp) {
  const int tid = threadIdx.x;
  load_rows<T, NW>(qs, blk.q, p.q_st, q0c, rows, q0c + nq, p.d, dp, tid);
  load_rows<T, NW>(dos, dout, p.o_st, q0c, rows, q0c + nq, p.d, dp, tid);
  for (int i = tid; i < rows; i += 32 * NW) {
    lse_s[i] = i < nq ? p.lse[(size_t)blk.row * p.lq + q0c + i] : 1e30f;
    del_s[i] = i < nq ? p.delta[(size_t)blk.row * p.lq + q0c + i] : 0.f;
  }
}

// bf16 dv = round(p e)^T dO or dk = round(ds)^T q of the tile's 32 keys on
// the warp's column tiles: keys on M (two m16 tiles), columns on N, the
// chunk's queries on K (A from the [key][query] tile `src`, B from the
// query rows `rows_s`); then carried or staged (times `scale`, put_dkv).
__device__ __forceinline__ void tile_dkdv_tc(const bf16* src, const bf16* rows_s, bf16* stage,
                                             float* acc, int QP, int P, int nmt, int n0, int ntw,
                                             int nt8, int k0, int kv_end, int d, float scale,
                                             bool first, bool last) {
  // stage: the dv or dk slot of the spent stage, rows at pitch P
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float o[2][kMaxNt][4];
#pragma unroll
  for (int km = 0; km < 2; ++km)
#pragma unroll
    for (int i = 0; i < kMaxNt; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[km][i][e] = 0.f;
  for (int kq = 0; kq < nmt; ++kq) {
    uint32_t a0[4], a1[4];
    tc::ldsm_x4(a0, src + (lane & 15) * QP + kq * 16 + (lane >> 4) * 8);
    tc::ldsm_x4(a1, src + (16 + (lane & 15)) * QP + kq * 16 + (lane >> 4) * 8);
    const bf16* brow = rows_s + (kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P;
#pragma unroll
    for (int i = 0; i < kMaxNt; ++i) {
      const int n = n0 + i;
      if (i < ntw && n < nt8) {
        uint32_t bv[2];
        tc::ldsm_x2_t(bv, brow + n * 8);
        tc::mma_bf16(o[0][i], a0, bv[0], bv[1]);
        tc::mma_bf16(o[1][i], a1, bv[0], bv[1]);
      }
    }
  }
#pragma unroll
  for (int km = 0; km < 2; ++km)
#pragma unroll
    for (int i = 0; i < kMaxNt; ++i)
      if (i < ntw && n0 + i < nt8)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          put_dkv<bf16>(stage, P, acc, k0, km * 16 + g + 8 * hr, kv_end, (n0 + i) * 8 + 2 * t, d,
                        o[km][i][2 * hr], o[km][i][2 * hr + 1], true, scale, first, last);
}

// bf16 on tensor cores. Per 32-key tile and query chunk: s = q K^T and
// dp = dO V^T with warp w on query tile w / 4 and keys 8 (w % 4) .. + 7; p,
// round(p e) and round(ds) from the fragments into [key][query] tiles; then
// dq += round(ds) K, dv and dk of the tile's keys, each on the warp's n8
// column tiles (dq in registers across the key loop, dv and dk finished in
// the tile's visit, staged in the tile's spent ring stage and stored with
// coalesced 16-byte stores).
__global__ void __launch_bounds__(32 * kWarps, 1) flash_bwd_wide_tc(BwdParams p) {
  constexpr int KT = Wide<bf16>::kKeys;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  WIDE_PHASE_INIT();
  const int dp = pad_dim(p.d, 16), P = dp + 8, nt8 = dp / 8, ntw = (nt8 + kWarps - 1) / kWarps;
  const int rows = chunk_rows<bf16>(p.q_chunk), QP = rows + 8;
  const BwdLayout<bf16> L(dp, rows, p.stages, p.alias != 0);
  char* ring = reinterpret_cast<char*>(wide_smem);
  bf16* qs = reinterpret_cast<bf16*>(wide_smem + L.qs);
  bf16* dos = reinterpret_cast<bf16*>(wide_smem + L.dos);
  float* lse_s = reinterpret_cast<float*>(wide_smem + L.lse);
  float* del_s = reinterpret_cast<float*>(wide_smem + L.del);
  bf16* pt = reinterpret_cast<bf16*>(wide_smem + L.pd);  // round(p e) [key][query]
  bf16* dst = pt + KT * QP;                                // round(ds) [key][query]
  float* rdq = reinterpret_cast<float*>(wide_smem + L.rdq);

  tc::cg::cluster_group cluster = tc::cg::this_cluster();
  const Block<bf16> blk(p, cluster);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int n0 = warp * ntw;
  const bf16* dout = static_cast<const bf16*>(p.dout) + blk.b * p.o_sb + blk.h * p.o_sh;
  bf16* dk = static_cast<bf16*>(p.dk) + (size_t)blk.row * p.lkv * p.d;
  bf16* dv = static_cast<bf16*>(p.dv) + (size_t)blk.row * p.lkv * p.d;
  float* dk_acc = p.dkv_acc ? p.dkv_acc + (size_t)blk.row * p.lkv * p.d : nullptr;
  float* dv_acc = p.dkv_acc ? dk_acc + (size_t)gridDim.y * p.lkv * p.d : nullptr;

  for (int chunk = 0; chunk < p.n_chunks; ++chunk) {
    const int q0c = chunk * p.q_chunk, nq = min(p.q_chunk, p.lq - q0c), nmt = (nq + 15) >> 4;
    const bool first = chunk == 0, last = chunk == p.n_chunks - 1;
    prime_ring<bf16, kWarps>(p, blk, ring, dp);
    load_chunk<bf16, kWarps>(p, blk, dout, qs, dos, lse_s, del_s, rows, q0c, nq, dp);
    float dqa[2][kMaxNt][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < kMaxNt; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[mt][i][e] = 0.f;
    WIDE_PHASE(1);

    for (int it = 0; it < blk.ntiles; ++it) {
      const Tile tile = next_tile<bf16, kWarps>(p, blk, ring, dp, it);
      char* st = tile.st;
      const bf16* ks = reinterpret_cast<const bf16*>(st);
      const bf16* vs = ks + KT * P;
      const float* mk = reinterpret_cast<const float*>(st + 2 * KT * sizeof(bf16) * P);
      const int k0 = blk.kv_begin + it * KT;
      {  // s and dp of the warp's 16 queries and 8 keys; p, round(p e), round(ds)
        const int mt = warp >> 2, nk = (warp & 3) * 8;
        if (mt < nmt) {
          float s4[4] = {0.f, 0.f, 0.f, 0.f}, d4[4] = {0.f, 0.f, 0.f, 0.f};
          const int qoff = (mt * 16 + (lane & 15)) * P + (lane >> 4) * 8;
          const int koff = (nk + (lane & 7)) * P + ((lane >> 3) & 1) * 8;
#pragma unroll 2
          for (int kk = 0; kk < dp / 16; ++kk) {
            uint32_t qa[4], oa[4], kb[2], vb[2];
            tc::ldsm_x4(qa, qs + qoff + kk * 16);
            tc::ldsm_x4(oa, dos + qoff + kk * 16);
            ldsm_x2(kb, ks + koff + kk * 16);
            ldsm_x2(vb, vs + koff + kk * 16);
            tc::mma_bf16(s4, qa, kb[0], kb[1]);
            tc::mma_bf16(d4, oa, vb[0], vb[1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = mt * 16 + g + 8 * (e >> 1), kc = nk + 2 * t + (e & 1);
            const float mkv = tile.mask(mk, kc);
            const float x = s4[e] * p.scale + (mkv - 1.f) * 1e30f;
            const float pr = __expf(x - lse_s[qi]) * mkv;
            const float ev =
                p.dropout ? keep(p.seed, blk.row, q0c + qi, k0 + kc, p.threshold, p.keep_scale)
                          : 1.f;
            pt[kc * QP + qi] = __float2bfloat16(pr * ev);
            dst[kc * QP + qi] = __float2bfloat16(pr * (d4[e] * ev - del_s[qi]));
          }
        }
      }
      __syncthreads();  // the tile's p^T and ds^T are complete
      WIDE_PHASE(5);
      // dq += round(ds) K over the tile's keys: queries on M, columns on N
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt < nmt) {
#pragma unroll
          for (int k16 = 0; k16 < KT / 16; ++k16) {
            uint32_t a[4];
            tc::ldsm_x4_t(a, dst + (k16 * 16 + ((lane >> 4) << 3) + (lane & 7)) * QP + mt * 16 +
                                 ((lane >> 3) & 1) * 8);
            const bf16* krow = ks + (k16 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P;
#pragma unroll
            for (int i = 0; i < kMaxNt; ++i) {
              const int n = n0 + i;
              if (i < ntw && n < nt8) {
                uint32_t kb[2];
                tc::ldsm_x2_t(kb, krow + n * 8);
                tc::mma_bf16(dqa[mt][i], a, kb[0], kb[1]);
              }
            }
          }
        }
      }
      WIDE_PHASE(6);
      // the stage's K and V are spent once every warp is done with dq: its
      // K and V slots stage dv and dk for the store
      bf16* sdv = reinterpret_cast<bf16*>(st);
      if (last) __syncthreads();
      tile_dkdv_tc(pt, dos, sdv, dv_acc, QP, P, nmt, n0, ntw, nt8, k0, blk.kv_end, p.d, 1.f,
                   first, last);
      tile_dkdv_tc(dst, qs, sdv + KT * P, dk_acc, QP, P, nmt, n0, ntw, nt8, k0, blk.kv_end, p.d,
                   p.scale, first, last);
      store_dkv<bf16, kWarps>(sdv, P, dk, dv, k0, blk.kv_end, p.d, last);
      WIDE_PHASE(7);
    }
    tc::cp_async_wait(0);  // only empty groups are left
    if (tid < KT) tc::bulk_wait();  // the tiles' dk and dv are stored
    if (p.alias) cluster.sync();  // every ring is idle before the pushes land in it
    const int share = (nq * p.d + blk.csize - 1) / blk.csize;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < kMaxNt; ++i) {
        const int n = n0 + i;
        if (mt < nmt && i < ntw && n < nt8)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = mt * 16 + g + 8 * (e >> 1), c = n * 8 + 2 * t + (e & 1);
            if (r < nq && c < p.d) push_elem(rdq, blk.rank, share, r * p.d + c, dqa[mt][i][e]);
          }
      }
    WIDE_PHASE(8);
    cluster.sync();
    WIDE_PHASE(9);
    merge_dq<bf16, kWarps>(p, rdq, blk.rank, blk.csize, blk.row, q0c, nq);
    WIDE_PHASE(10);
    // before the next chunk pushes, every block is done reading this one's
    if (!last) cluster.sync();
  }
  WIDE_PHASE_FLUSH();
}

// f32 on the CUDA cores, the key loop and push of one query chunk for a
// warp that owns NS of its rows. Per 16-key tile: s and dp of the warp's
// rows as in the forward (a key a lane over half the head), p, round(p e)
// and round(ds) into [query][key] rows, dq += ds K over columns lane + 32 i
// in registers; after a block barrier, thread (warp w, lane l) finishes dv
// and dk of keys 4 (l / 8) .. + 3 on columns 8 w + l % 8 + 128 c over the
// chunk's queries, staged in the tile's spent ring stage for a coalesced
// store.
template <int NS>
__device__ __forceinline__ void bwd_f32_chunk(const BwdParams& p, const Block<float>& blk,
                                              tc::cg::cluster_group& cluster, char* ring,
                                              const float* qs, const float* dos,
                                              const float* lse_s, const float* del_s, float* pd,
                                              float* rdq, float* dk, float* dv, float* dk_acc,
                                              float* dv_acc, int dp, int rows, int q0c, int nq,
                                              bool first, bool last) {
  constexpr int KT = Wide<float>::kKeys, NSA = NS > 0 ? NS : 1, NW = kBwdF32Warps;
  constexpr int CS = 8 * NW, CQ = kMaxD / CS;  // a thread's columns: cb + CS c
  const int P = dp + 4, cpl = dp / 32, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int key = lane & 15, half = lane >> 4;
  float* ds = pd + rows * KT;
  float dqa[NSA][kMaxCpl];
#pragma unroll
  for (int s = 0; s < NSA; ++s)
#pragma unroll
    for (int i = 0; i < kMaxCpl; ++i) dqa[s][i] = 0.f;
  WIDE_PHASE(1);
  for (int it = 0; it < blk.ntiles; ++it) {
    const Tile tile = next_tile<float, NW>(p, blk, ring, dp, it);
    char* st = tile.st;
    const float* ks = reinterpret_cast<const float*>(st);
    const float* vs = ks + KT * P;
    const int k0 = blk.kv_begin + it * KT;
    if constexpr (NS > 0) {
      const float mkv = tile.mask(vs + KT * P, key);
      float sd[2][NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) sd[0][s] = sd[1][s] = 0.f;
      const float* kr = ks + key * P;
      const float* vr = vs + key * P;
#pragma unroll 2
      for (int c = 4 * half; c < dp; c += 8) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + c);
        const float4 vv = *reinterpret_cast<const float4*>(vr + c);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int r = warp + NW * s;
          const float4 qv = *reinterpret_cast<const float4*>(qs + r * P + c);
          const float4 ov = *reinterpret_cast<const float4*>(dos + r * P + c);
          float x = sd[0][s], y = sd[1][s];
          x = fmaf(qv.x, kv.x, x), y = fmaf(ov.x, vv.x, y);
          x = fmaf(qv.y, kv.y, x), y = fmaf(ov.y, vv.y, y);
          x = fmaf(qv.z, kv.z, x), y = fmaf(ov.z, vv.z, y);
          x = fmaf(qv.w, kv.w, x), y = fmaf(ov.w, vv.w, y);
          sd[0][s] = x, sd[1][s] = y;
        }
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int r = warp + NW * s;
        const float sv = sd[0][s] + __shfl_xor_sync(0xffffffffu, sd[0][s], 16);
        const float dpv = sd[1][s] + __shfl_xor_sync(0xffffffffu, sd[1][s], 16);
        const float x = sv * p.scale + (mkv - 1.f) * 1e30f;
        const float pr = __expf(x - lse_s[r]) * mkv;
        const float e =
            p.dropout ? keep(p.seed, blk.row, q0c + r, k0 + key, p.threshold, p.keep_scale) : 1.f;
        if (half == 0) {
          pd[r * KT + key] = pr * e;
          ds[r * KT + key] = pr * (dpv * e - del_s[r]);
        }
      }
      __syncwarp();
      WIDE_PHASE(5);
#pragma unroll
      for (int j = 0; j < KT; j += 4) {
        float4 dv4[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s)
          dv4[s] = *reinterpret_cast<const float4*>(ds + (warp + NW * s) * KT + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* kr2 = ks + (j + jj) * P + lane;
#pragma unroll
          for (int i = 0; i < kMaxCpl; ++i) {
            if (i < cpl) {
              const float kk = kr2[32 * i];
#pragma unroll
              for (int s = 0; s < NS; ++s) dqa[s][i] = fmaf(fv::at(dv4[s], jj), kk, dqa[s][i]);
            }
          }
        }
      }
      WIDE_PHASE(6);
    }
    // round(p e) and round(ds) of every row; the stage's K and V are spent
    __syncthreads();
    {  // dv and dk of the tile's keys 4 (lane / 8) .. + 3, columns cb + CS c
      const int j0 = 4 * (lane >> 3), cb = warp * 8 + (lane & 7);
      float av[4][CQ], ak[4][CQ];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < CQ; ++c) av[jj][c] = ak[jj][c] = 0.f;
#pragma unroll 2
      for (int i = 0; i < nq; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(pd + i * KT + j0);
        const float4 sv = *reinterpret_cast<const float4*>(ds + i * KT + j0);
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          if (cb + CS * c < dp) {
            const float o = dos[i * P + cb + CS * c], x = qs[i * P + cb + CS * c];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              av[jj][c] = fmaf(fv::at(pv, jj), o, av[jj][c]);
              ak[jj][c] = fmaf(fv::at(sv, jj), x, ak[jj][c]);
            }
          }
        }
      }
      float* sdv = reinterpret_cast<float*>(st);  // dv and dk staged in the V and K slots
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          const int ch = cb + CS * c;
          put_dkv<float>(sdv, P, dv_acc, k0, j0 + jj, blk.kv_end, ch, p.d, av[jj][c], 0.f, false,
                         1.f, first, last);
          put_dkv<float>(sdv + KT * P, P, dk_acc, k0, j0 + jj, blk.kv_end, ch, p.d, ak[jj][c],
                         0.f, false, p.scale, first, last);
        }
      store_dkv<float, NW>(sdv, P, dk, dv, k0, blk.kv_end, p.d, last);
    }
    WIDE_PHASE(7);
  }
  tc::cp_async_wait(0);  // only empty groups are left
  if (tid < KT) tc::bulk_wait();  // the tiles' dk and dv are stored
  if (p.alias) cluster.sync();
  const int share = (nq * p.d + blk.csize - 1) / blk.csize;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int r = warp + NW * s;
#pragma unroll
    for (int i = 0; i < kMaxCpl; ++i) {
      const int c = lane + 32 * i;
      if (i < cpl && c < p.d) push_elem(rdq, blk.rank, share, r * p.d + c, dqa[s][i]);
    }
  }
}

__global__ void __launch_bounds__(32 * kBwdF32Warps, 1) flash_bwd_wide_fma(BwdParams p) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  WIDE_PHASE_INIT();
  const int dp = pad_dim(p.d, 32), rows = chunk_rows<float>(p.q_chunk);
  const BwdLayout<float> L(dp, rows, p.stages, p.alias != 0);
  char* ring = reinterpret_cast<char*>(wide_smem);
  float* qs = reinterpret_cast<float*>(wide_smem + L.qs);
  float* dos = reinterpret_cast<float*>(wide_smem + L.dos);
  float* lse_s = reinterpret_cast<float*>(wide_smem + L.lse);
  float* del_s = reinterpret_cast<float*>(wide_smem + L.del);
  float* pd = reinterpret_cast<float*>(wide_smem + L.pd);
  float* rdq = reinterpret_cast<float*>(wide_smem + L.rdq);
  tc::cg::cluster_group cluster = tc::cg::this_cluster();
  const Block<float> blk(p, cluster);
  const int warp = threadIdx.x >> 5;
  const float* dout = static_cast<const float*>(p.dout) + blk.b * p.o_sb + blk.h * p.o_sh;
  float* dk = static_cast<float*>(p.dk) + (size_t)blk.row * p.lkv * p.d;
  float* dv = static_cast<float*>(p.dv) + (size_t)blk.row * p.lkv * p.d;
  float* dk_acc = p.dkv_acc ? p.dkv_acc + (size_t)blk.row * p.lkv * p.d : nullptr;
  float* dv_acc = p.dkv_acc ? dk_acc + (size_t)gridDim.y * p.lkv * p.d : nullptr;

  for (int chunk = 0; chunk < p.n_chunks; ++chunk) {
    const int q0c = chunk * p.q_chunk, nq = min(p.q_chunk, p.lq - q0c);
    const bool first = chunk == 0, last = chunk == p.n_chunks - 1;
    prime_ring<float, kBwdF32Warps>(p, blk, ring, dp);
    load_chunk<float, kBwdF32Warps>(p, blk, dout, qs, dos, lse_s, del_s, rows, q0c, nq, dp);
#define BWD_CHUNK(NS)                                                                           \
  bwd_f32_chunk<NS>(p, blk, cluster, ring, qs, dos, lse_s, del_s, pd, rdq, dk, dv, dk_acc, dv_acc, \
                    dp, rows, q0c, nq, first, last)
    switch (slots_of<kBwdF32Warps>(warp, nq)) {
      case 0: BWD_CHUNK(0); break;
      case 1: BWD_CHUNK(1); break;
      default: BWD_CHUNK(2); break;
    }
#undef BWD_CHUNK
    WIDE_PHASE(8);
    cluster.sync();
    WIDE_PHASE(9);
    merge_dq<float, kBwdF32Warps>(p, rdq, blk.rank, blk.csize, blk.row, q0c, nq);
    WIDE_PHASE(10);
    if (!last) cluster.sync();
  }
  WIDE_PHASE_FLUSH();
}

// A launch of `kern` with `threads` a block: grid (cluster, rows), one
// cluster of `cluster` blocks per row (tc::cluster_config at another block
// size).
template <typename Kernel>
cudaLaunchConfig_t wide_config(cudaLaunchAttribute* attr, int threads, int cluster, int rows,
                               size_t smem, cudaStream_t s) {
  cudaLaunchConfig_t cfg = tc::cluster_config<Kernel>(attr, cluster, rows, smem, s);
  cfg.blockDim = dim3(threads, 1, 1);
  return cfg;
}

// Clusters of `cluster` blocks the card holds at once; -1 where the query
// fails (its error is cleared).
template <int NW, typename Kernel>
int wide_max_clusters(Kernel kern, int cluster, size_t smem) {
  if (tc::configure(kern) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wide_config<Kernel>(attr, 32 * NW, cluster, 1, smem, nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)kern, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}

template <int NW, typename Kernel, typename Params>
cudaError_t wide_launch(Kernel kern, const Params& p, int cluster, int rows, size_t smem,
                        cudaStream_t s) {
  cudaError_t e = tc::configure(kern);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wide_config<Kernel>(attr, 32 * NW, cluster, rows, smem, s);
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The backward's largest query chunk at head dim d: 32 rows, else the most
// (16 for bf16; for f32 any count, 23 at d 512) whose layout fits at two
// stages.
template <typename T>
int bwd_max_queries(int d) {
  for (int rows = kGroup; rows > 0; rows -= sizeof(T) == 2 ? 16 : 1)
    if (bwd_plan<T>(d, rows).stages > 0) return rows;
  return 0;
}

}  // namespace

// The widest head the kernels of this file take.
extern "C" int healnet_flash_wide_max_d() { return kMaxD; }

// Clusters of `cluster` blocks of the wide forward the card holds at once
// at head dim d (-1 where the query fails or d is out of range).
extern "C" int healnet_flash_wide_fwd_max_clusters(int d, int is_bf16, int cluster) {
  if (d < 1 || d > kMaxD) return -1;
  const Plan pl = is_bf16 ? fwd_plan<bf16>(d) : fwd_plan<float>(d);
  if (pl.stages == 0) return -1;
  return is_bf16 ? wide_max_clusters<kWarps>(flash_fwd_wide_tc, cluster, pl.smem)
                 : wide_max_clusters<kWarps>(flash_fwd_wide_fma, cluster, pl.smem);
}

// The most queries a chunk of the wide backward holds at head dim d (0
// where d is out of range).
extern "C" int healnet_flash_wide_bwd_max_queries(int d, int is_bf16) {
  if (d < 1 || d > kMaxD) return 0;
  return is_bf16 ? bwd_max_queries<bf16>(d) : bwd_max_queries<float>(d);
}

// Clusters of `cluster` blocks of the wide backward (query chunk q_chunk)
// the card holds at once.
extern "C" int healnet_flash_wide_bwd_max_clusters(int q_chunk, int d, int is_bf16, int cluster) {
  if (d < 1 || d > kMaxD || q_chunk < 1 || q_chunk > kGroup) return -1;
  const Plan pl = is_bf16 ? bwd_plan<bf16>(d, chunk_rows<bf16>(q_chunk))
                          : bwd_plan<float>(d, chunk_rows<float>(q_chunk));
  if (pl.stages == 0) return -1;
  return is_bf16 ? wide_max_clusters<kWarps>(flash_bwd_wide_tc, cluster, pl.smem)
                 : wide_max_clusters<kBwdF32Warps>(flash_bwd_wide_fma, cluster, pl.smem);
}

extern "C" int healnet_flash_wide_forward(
    const void* q, const void* k, const void* v, const float* mask, void* out, float* lse,
    int B, int H, int lq, int lkv, int d, int cluster, int keys_per_cta, long long q_sb,
    long long q_sh, long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long mask_sb, float scale, int dropout,
    unsigned int seed, unsigned int threshold, float keep_scale, int is_bf16, void* stream) {
  if (B * H <= 0 || lq <= 0) return 0;
  if (d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const Plan pl = is_bf16 ? fwd_plan<bf16>(d) : fwd_plan<float>(d);
  if (pl.stages == 0) return (int)cudaErrorInvalidValue;
  FwdParams p;
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
  p.stages = pl.stages;
  p.alias = pl.alias;
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
  p.seed = seed;
  p.threshold = threshold;
  p.keep_scale = keep_scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? wide_launch<kWarps>(flash_fwd_wide_tc, p, cluster, B * H, pl.smem, s)
              : wide_launch<kWarps>(flash_fwd_wide_fma, p, cluster, B * H, pl.smem, s));
}

extern "C" int healnet_flash_wide_backward(
    const void* q, const void* k, const void* v, const float* mask, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv, float* dkv_acc, int B,
    int H, int lq, int lkv, int d, int cluster, int keys_per_cta, int q_chunk, int n_chunks,
    long long q_sb, long long q_sh, long long q_st, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st, long long o_sb,
    long long o_sh, long long o_st, long long mask_sb, float scale, int dropout,
    unsigned int seed, unsigned int threshold, float keep_scale, int is_bf16, void* stream) {
  if (B * H <= 0 || lq <= 0) return 0;
  if (d < 1 || d > kMaxD || q_chunk < 1 || q_chunk > kGroup || n_chunks < 1 ||
      (is_bf16 && q_chunk % 16 != 0) || (n_chunks > 1 && dkv_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan pl = is_bf16 ? bwd_plan<bf16>(d, chunk_rows<bf16>(q_chunk))
                          : bwd_plan<float>(d, chunk_rows<float>(q_chunk));
  if (pl.stages == 0) return (int)cudaErrorInvalidValue;
  BwdParams p;
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
  p.stages = pl.stages;
  p.alias = pl.alias;
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
  p.seed = seed;
  p.threshold = threshold;
  p.keep_scale = keep_scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? wide_launch<kWarps>(flash_bwd_wide_tc, p, cluster, B * H, pl.smem, s)
              : wide_launch<kBwdF32Warps>(flash_bwd_wide_fma, p, cluster, B * H, pl.smem, s));
}

extern "C" const char* healnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
