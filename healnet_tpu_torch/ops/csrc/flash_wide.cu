// Flash cross-attention, forward and backward, for heads wider than 256
// channels: one pass over a block's keys per query group, each tile's
// scores taken once, bf16 on tensor cores. Heads of 257-512 sit in one block
// (the "wide" kernels); wider heads are split by columns into panels over
// the blocks of a thread-block cluster (the "panel" kernels: the same
// kernels compiled with the exchange of partial scores between panels).
//
// Replaces: healnet_tpu/ops/flash_attention.py::_fwd_kernel (:98) and
// ::_bwd_kernel (:201) for heads wider than the one-pass kernels of
// flash_attention.cu / flash_attention_bwd.cu take (256). The Pallas kernels
// take any head dim, and so do these. The wrapper
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
// dk and dv: 0.0502 / 0.0251 ms. At d 576 the bytes scale with d: 0.0453 /
// 0.0226 ms forward, 0.0904 / 0.0452 backward. Bytes bound all of them.
//
// One block (heads of 257-512). A block owns a range of keys and the whole
// head:
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
//
// Panels (heads past 512). A block holds q, K, V, dO and the accumulators
// of kMaxD columns at most, so a wider head is split into N panels of
// balanced width (whole kAlign units, the last clipped to d; at d 576, two
// of 288). A cluster is P panels x S key ranges (rank = range * P + panel,
// P * S <= 16): block (panel i, range j) does the one-block kernel's work on
// panel i's columns of range j's keys, K and V read once. A tile's scores
// need the whole head, so each block writes its partial q_i K_i^T (in the
// backward also dO_i V_i^T) into the same slot of every panel peer's shared
// memory with st.async, which completes on the peer's mbarrier (one a tile
// parity: the slots are double-buffered, and a peer can only write a tile's
// slot after this block has read the slot two tiles back, since it first
// waits for this block's partial of the tile between); each block then sums
// the P partials in panel order 0..P-1, so every panel holds the same bits
// of the scores, and with them the same softmax state, p, dropout keep and
// log-sum-exp (written by panel 0 alone). The rest is per panel: the output
// (and dq) merged over the panel's key ranges in range order, dk and dv of
// the panel's columns finished per tile by the block. No whole-cluster
// barrier per tile. In bf16 the ring's K and V rows come as one bulk copy a
// row on an mbarrier a stage (stage_kv), in f32 as the threads' copies.
//
// Past kMaxPanels panels (d > 3072; 2880 in the bf16 backward, whose panels
// stop at 480 columns: ops/flash_attention.py::flash_panels) the exchange
// slots no longer fit beside a 512-wide panel, and the head takes T passes
// of P <= kMaxPanels panels: first T score passes, each tile's partials
// summed over the pass's panels as above and added, in pass order, to a
// scores scratch in device memory (the wrapper's; (B*H, lq, lkv) f32, twice
// in the backward: s and dp) by panel 0's block, then T output passes that
// take the tile's scores from the scratch (every pass stages its panel's K
// and V, so they are read twice: a rare shape, held on the card at small
// sizes). Any d.
//
// Tiles: 32 keys for bf16 (one a lane in the softmax), 16 for f32 (a lane
// takes one key over half the head, the halves added by a shuffle). Stages
// and the backward's query chunk are sized from shared memory. One block an
// SM (the head's accumulators take up to 64 registers a thread; 8 warps, 16
// in the f32 backward), so the plan's clusters take any size up to 16 (a
// multiple of P): 9 at 8 rows for one panel, where clusters of 10-16 are
// resident only 7 at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"
#include "hash_dropout.cuh"
#include "hopper.cuh"

#ifndef WIDE_PHASE  // clock64 phase markers of scripts/profile_flash_phases.py
#define WIDE_PHASE(k)
#define WIDE_PHASE_INIT()
#define WIDE_PHASE_FLUSH()
#endif

namespace {

namespace tc = healnet::tc;
namespace fv = healnet::tc::fmav;
namespace hp = healnet::hopper;
using bf16 = __nv_bfloat16;

constexpr int kMaxD = 512;      // the widest head (or panel) a block takes
constexpr int kMaxPanels = 6;   // panels of one pass: their slots fit at 512
constexpr int kGroup = 32;      // queries a block holds at once: two m16 tiles
constexpr int kMaxCpl = kMaxD / 32;  // columns lane + 32 i a lane owns (f32)
constexpr float kNegBig = tc::kNegBig;

// What a pass over the keys does: everything (one pass), or, where the head
// takes several passes, sum its panels' partial scores into the scratch, or
// take the scores from it
enum Mode { kFused, kScore, kOutput };

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
// 16-byte hull fits its slot), and the pitch of a query row of a tile's
// scores in an exchange slot.
template <typename T>
struct Wide;
template <>
struct Wide<bf16> {
  static constexpr int kKeys = 32, kAlign = 16, kPad = 8, kXPitch = kKeys + 4;
};
template <>
struct Wide<float> {
  static constexpr int kKeys = 16, kAlign = 32, kPad = 4, kXPitch = kKeys;
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

// Floats of an exchange slot: a panel's partial scores of a tile for `rows`
// queries (the backward's s, then its dp).
template <typename T>
__host__ __device__ inline int slot_floats(int rows, bool bwd) {
  return (bwd ? 2 : 1) * rows * Wide<T>::kXPitch;
}

// Bytes of the panel kernels' exchange (16-aligned): six mbarriers (two for
// the exchange, one a tile parity; four for the ring's stages), then a slot
// for each tile parity and panel; none for the one-panel kernels.
constexpr int kXchgHead = 48;
template <typename T>
__host__ __device__ inline size_t xchg_bytes(int rows, bool bwd, int panels) {
  return panels > 1 ? kXchgHead + sizeof(float) * 2 * panels * (size_t)slot_floats<T>(rows, bwd)
                    : 0;
}

// Byte offsets of the forward's shared memory: the ring at 0, the cluster's
// pushed acc (racc; at 0 where it aliases the ring), the group's q rows, the
// scores (bf16 with one panel: panels sum them in the exchange's slots), p,
// the rows' softmax corrections, the pushed (m, l), and the panels'
// exchange.
template <typename T>
struct FwdLayout {
  size_t racc, qs, sc, ps, corr, rm, rl, xb, total;
  __host__ __device__ FwdLayout(int dp, int stages, bool alias, int panels) {
    constexpr int KT = Wide<T>::kKeys;
    constexpr bool kTc = sizeof(T) == 2;
    const size_t ring = stages * stage_bytes<T>(dp);
    const size_t acc = tc::align16(sizeof(float) * ((size_t)kGroup * dp + tc::kMaxCluster));
    racc = alias ? 0 : ring;
    qs = alias ? max_sz(ring, acc) : ring + acc;
    sc = qs + kGroup * row_bytes<T>(dp);
    ps = sc + (kTc && panels == 1 ? sizeof(float) * kGroup * (KT + 4) : 0);
    corr = ps + (kTc ? sizeof(bf16) * kGroup * (KT + 8) : sizeof(float) * kGroup * KT);
    rm = corr + sizeof(float) * kGroup;
    rl = rm + sizeof(float) * tc::kMaxCluster * kGroup;
    const size_t end = rl + sizeof(float) * tc::kMaxCluster * kGroup;
    xb = panels > 1 ? tc::align16(end) : end;
    total = xb + xchg_bytes<T>(kGroup, false, panels);
  }
};

// Byte offsets of the backward's shared memory (rows: chunk_rows of the
// query chunk): the ring at 0, the cluster's pushed dq (rdq; at 0 where it
// aliases the ring), q, dO, lse, delta, round(p e) and round(ds) ([key][query]
// bf16 for the mma operands, [query][key] f32), and the panels' exchange.
template <typename T>
struct BwdLayout {
  size_t rdq, qs, dos, lse, del, pd, xb, total;
  __host__ __device__ BwdLayout(int dp, int rows, int stages, bool alias, int panels) {
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
    const size_t end =
        pd + (kTc ? 2 * sizeof(bf16) * KT * (rows + 8) : 2 * sizeof(float) * rows * KT);
    xb = panels > 1 ? tc::align16(end) : end;
    total = xb + xchg_bytes<T>(rows, true, panels);
  }
};

// A layout's byte offsets as the kernels take them: reckoned on the host and
// passed in the params (reckoned in the kernel, they were rematerialized at
// every use, 8 instructions each, at the cost of the one-block kernels' time).
struct FwdOffsets {
  uint32_t racc, qs, sc, ps, corr, rm, rl, xb;
};
struct BwdOffsets {
  uint32_t rdq, qs, dos, lse, del, pd, xb;
};

template <typename T>
FwdOffsets offsets(const FwdLayout<T>& l) {
  return {(uint32_t)l.racc, (uint32_t)l.qs, (uint32_t)l.sc, (uint32_t)l.ps,
          (uint32_t)l.corr, (uint32_t)l.rm, (uint32_t)l.rl, (uint32_t)l.xb};
}

template <typename T>
BwdOffsets offsets(const BwdLayout<T>& l) {
  return {(uint32_t)l.rdq, (uint32_t)l.qs, (uint32_t)l.dos, (uint32_t)l.lse,
          (uint32_t)l.del, (uint32_t)l.pd, (uint32_t)l.xb};
}

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
Plan fwd_plan(int dp, int panels) {
  return pick_plan([=](int s, bool a) { return FwdLayout<T>(dp, s, a, panels); });
}

template <typename T>
Plan bwd_plan(int dp, int rows, int panels) {
  return pick_plan([=](int s, bool a) { return BwdLayout<T>(dp, rows, s, a, panels); });
}

// kAlign units of a head of d columns, and the padded width of its widest
// panel when split into panels * passes
template <typename T>
int head_units(int d) {
  return (d + Wide<T>::kAlign - 1) / Wide<T>::kAlign;
}

template <typename T>
int panel_dp(int d, int panels, int passes) {
  const int n = panels * passes;
  return (head_units<T>(d) + n - 1) / n * Wide<T>::kAlign;
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

// `p`'s place (in this block's shared memory) in block `rank`'s
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(tc::smem_addr(p)), "r"(rank));
  return a;
}

// A store into another block's shared memory that completes its bytes on
// that block's mbarrier `bar` (both cluster addresses).
__device__ __forceinline__ void st_async(uint32_t addr, float x, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "f"(x), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, float x, float y, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "f"(x), "f"(y), "r"(bar)
      : "memory");
}

// One bulk asynchronous copy of `bytes` (a multiple of 16) from device
// memory into this block's shared memory, both 16-byte aligned, completing
// its bytes on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(tc::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(tc::smem_addr(bar))
      : "memory");
}

// Issue the copies of keys [k0, min(k0 + KT, kv_end)) of K and V and of
// their mask values into ring stage `st`: stage row r is K (r < KT) or V of
// key k0 + r % KT, copied as the 16-byte chunks that hold part of it (its
// 16-byte-aligned hull; a chunk holding one byte of the row lies in the
// row's page, so the hull never faults), at pitch row_bytes<T>(dp). A warp
// takes a row, its lanes consecutive chunks; in the bf16 panel kernels
// (kBulk) thread r < 2 KT takes row r as one bulk copy on the stage's
// mbarrier `bar` (its arrival expecting the row's bytes), so that K and V
// land without the threads' 16-byte copies, whose issue took 30% of the
// bf16 forward's time (-11% at d 576; the f32 panels, whose issue took
// 13%, lost 2-7% to the ring's barriers and spills, and keep the copies).
template <typename T, int NW, bool kBulk>
__device__ __forceinline__ void stage_kv(char* st, uint64_t* bar, const T* k, long long k_st,
                                         const T* v, long long v_st, const float* mask, int k0,
                                         int kv_end, int d, int dp, int tid) {
  constexpr int KT = Wide<T>::kKeys;
  const int rb = (int)row_bytes<T>(dp), lane = tid & 31;
  if constexpr (kBulk) {
    if (tid < 2 * KT) {
      const int key = k0 + (tid & (KT - 1));
      uint32_t bytes = 0;
      uintptr_t row = 0;
      if (key < kv_end) {
        row = reinterpret_cast<uintptr_t>(tid < KT ? k + key * k_st : v + key * v_st);
        bytes = (uint32_t)(((row & 15) + sizeof(T) * (uintptr_t)d + 15) & ~uintptr_t(15));
      }
      hp::mbar_expect_tx(bar, bytes);
      if (bytes > 0)
        bulk_load(st + (size_t)tid * rb, reinterpret_cast<const void*>(row & ~uintptr_t(15)),
                  bytes, bar);
    }
  }
  for (int r = tid >> 5; !kBulk && r < 2 * KT; r += NW) {
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

__device__ __forceinline__ float keep(uint32_t seed, uint32_t row, int q, int kv,
                                      uint32_t threshold, float scale) {
  return healnet::hash_keep(seed, row, (uint32_t)q, (uint32_t)kv, threshold) ? scale : 0.f;
}

// A block's batch*head row, read from blockIdx where an index needs it (a
// register holds the row's hash row instead: Block::hrow).
__device__ __forceinline__ int block_row() { return (int)blockIdx.y; }

// The passes over the keys a query group (or chunk) takes, and what pass
// `pass` does: one fused pass, or T score passes then T output passes.
template <typename Params>
__device__ __forceinline__ int passes_of(const Params& p) {
  return p.passes > 1 ? 2 * p.passes : 1;
}

template <typename Params>
__device__ __forceinline__ int mode_of(const Params& p, int pass) {
  return p.passes == 1 ? kFused : pass < p.passes ? kScore : kOutput;
}

// ------------------------------------------------------------------ forward

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;  // (B, lkv) or null
  void* out;          // (B, lq, H, d)
  float* lse;         // (B*H, lq)
  float* scores;      // (B*H, lq, lkv) f32 where passes > 1, else null
  FwdOffsets off;     // the shared-memory layout
  int H, lq, lkv, d, dp, panels, passes, units, keys_per_cta, stages, alias;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, mask_sb;
  float scale;
  int dropout;
  const uint32_t* seed;  // the 32-bit hash seed, in device memory (read once a block)
  uint32_t threshold;
  float keep_scale;
  uint32_t row_offset;  // the hash rows: row_offset + b * head_stride + h
  int head_stride;
};

// What every kernel of this file knows of its block: its cluster rank, its
// panel and key range, its batch and head and their hash row, its keys and
// tiles, and the columns of the panel it is on. Without panels (kP false)
// the panel is the head: pan 0, the range the rank, columns [0, d), all
// known to the compiler.
template <typename T, bool kP>
struct Block {
  int rank, pan, kr, nkr, b, h, kv_begin, kv_end, ntiles;
  // the dropout hash's row of (b, h): row_offset + b * head_stride + h, a
  // shard's rows at their coordinates in the whole batch
  uint32_t hrow;
  int c0, wd;  // the panel's columns [c0, c0 + wd) of the head
  // the panel's K and V rows start on 16 bytes and fill their padded width:
  // a landed whole tile is already aligned, zero-padded tiles
  bool aligned;
  const T *q, *k, *v;  // the panel's first column
  const float* mask;
  uint64_t* rbar;  // bf16 panels: the ring stages' mbarriers (K and V rows by bulk copies)
  uint32_t rphase;  // bf16 panels: each stage's phase parity, a bit a stage
  uint32_t seed;    // the dropout hash seed, read from device memory once a block
  template <typename Params>
  __device__ Block(const Params& p, const tc::cg::cluster_group& cluster) {
    rbar = nullptr, rphase = 0u;
    seed = p.dropout ? __ldg(p.seed) : 0u;
    rank = (int)cluster.block_rank();
    if constexpr (kP) {
      pan = rank % p.panels, kr = rank / p.panels, nkr = (int)cluster.num_blocks() / p.panels;
    } else {
      pan = 0, kr = rank, nkr = (int)cluster.num_blocks();
    }
    b = block_row() / p.H, h = block_row() - b * p.H;
    hrow = p.row_offset + (uint32_t)(b * p.head_stride + h);
    mask = p.mask ? p.mask + b * p.mask_sb : nullptr;
    kv_begin = kr * p.keys_per_cta;
    kv_end = min(p.lkv, kv_begin + p.keys_per_cta);
    constexpr int KT = Wide<T>::kKeys;
    ntiles = kv_end > kv_begin ? (kv_end - kv_begin + KT - 1) / KT : 0;
    panel(p, 0);
  }
  // Onto panel t * panels + pan of the head's panels * passes: its kAlign
  // units [n u / N, (n + 1) u / N), the last clipped to d.
  template <typename Params>
  __device__ void panel(const Params& p, int t) {
    constexpr int A = Wide<T>::kAlign;
    if constexpr (kP) {
      const int n = p.panels * p.passes, idx = t * p.panels + pan;
      c0 = idx * p.units / n * A;
      wd = min(p.d, (idx + 1) * p.units / n * A) - c0;
    } else {
      c0 = 0, wd = p.d;
    }
    q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + c0;
    k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + c0;
    v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + c0;
    aligned = ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0 &&
              ((p.k_st * sizeof(T)) & 15) == 0 && ((p.v_st * sizeof(T)) & 15) == 0 &&
              (kP ? wd == p.dp : wd % A == 0);
  }
  // the block of key range j on this block's panel
  __device__ int peer(int j, int panels) const { return j * panels + pan; }
};

// The exchange of partial scores between a key range's panel blocks: two
// mbarriers (one a tile parity), the slots [parity][panel][floats], and the
// tiles exchanged so far (every thread counts them).
struct Xchg {
  uint64_t* bar;
  float* xs;
  int slot;
  uint32_t tick;
  __device__ float* at(int parity, int panel, int panels) const {
    return xs + (parity * panels + panel) * slot;
  }
};

// The exchange at `base`, its barriers initialised before any peer can
// write to it (one cluster barrier), and the block's ring barriers (each
// stage's, arrived at by the 2 KT threads that copy its rows; used by the
// bf16 kernels). Nothing where there is one panel.
template <bool kPanels, typename T, bool kP>
__device__ __forceinline__ Xchg make_xchg(unsigned char* base, int slot, Block<T, kP>& blk,
                                          tc::cg::cluster_group& cluster) {
  Xchg x{reinterpret_cast<uint64_t*>(base), reinterpret_cast<float*>(base + kXchgHead), slot, 0u};
  if constexpr (kPanels) {
    blk.rbar = x.bar + 2;
    if (threadIdx.x == 0) {
      hp::mbar_init(&x.bar[0], 1);
      hp::mbar_init(&x.bar[1], 1);
      for (int s = 0; s < 4; ++s) hp::mbar_init(&blk.rbar[s], 2 * Wide<T>::kKeys);
      hp::mbar_init_fence();
    }
    cluster.sync();
  }
  return x;
}

// x (and y) at `loc`, an address in this block's slot of the tile, here and
// at the same place in every panel peer of its key range, completing there
// on the tile's barrier `bar`.
template <typename T, bool kP>
__device__ __forceinline__ void share(const Block<T, kP>& blk, int panels, float* loc,
                                      const uint64_t* bar, float x) {
  *loc = x;
  for (int i = 0; i < panels; ++i)
    if (i != blk.pan) {
      const int r = blk.kr * panels + i;
      st_async(cluster_addr(loc, r), x, cluster_addr(bar, r));
    }
}

template <typename T, bool kP>
__device__ __forceinline__ void share(const Block<T, kP>& blk, int panels, float* loc,
                                      const uint64_t* bar, float x, float y) {
  *reinterpret_cast<float2*>(loc) = make_float2(x, y);
  for (int i = 0; i < panels; ++i)
    if (i != blk.pan) {
      const int r = blk.kr * panels + i;
      st_async(cluster_addr(loc, r), x, y, cluster_addr(bar, r));
    }
}

// The tile's exchange has landed: wait for the phase of its parity.
__device__ __forceinline__ void xchg_wait(Xchg& x) {
  hp::mbar_wait(&x.bar[x.tick & 1], (x.tick >> 1) & 1);
}

// The sum of the panels' partials at float `off` of the tile's slots, in
// panel order.
__device__ __forceinline__ float panel_sum(const Xchg& x, int panels, int off) {
  const int par = x.tick & 1;
  float s = 0.f;
  for (int i = 0; i < panels; ++i) s += x.at(par, i, panels)[off];
  return s;
}

// Push a row's (m, l) to every block of this block's panel (lanes < nkr of
// the row's warp), at this block's key range.
template <typename T, bool kP>
__device__ __forceinline__ void push_ml(float* rm, float* rl, const Block<T, kP>& blk, int panels,
                                        int r, float m, float l, int lane) {
  if (lane < blk.nkr) {
    tc::st_cluster(rm + blk.kr * kGroup + r, blk.peer(lane, panels), m);
    tc::st_cluster(rl + blk.kr * kGroup + r, blk.peer(lane, panels), l);
  }
}

// Push the panel's acc (or dq) element e = r wd + c to its panel's block
// that owns e (key range e / share).
template <typename T, bool kP>
__device__ __forceinline__ void push_elem(float* buf, const Block<T, kP>& blk, int panels,
                                          int share, int e, float x) {
  const int owner = e / share;
  tc::st_cluster(buf + blk.kr * share + e - owner * share, blk.peer(owner, panels), x);
}

// This block's share of the group's output on its panel, after the cluster
// barrier: the key ranges' (m, l, acc) merged in range order from its own
// shared memory, and the log-sum-exp (by the head's first column alone).
template <typename T, int NW, bool kP>
__device__ __forceinline__ void merge_out(const FwdParams& p, const float* rm, const float* rl,
                                          const float* racc, const Block<T, kP>& blk, int g0,
                                          int nq) {
  const int wd = blk.wd, ne = nq * wd, share = (ne + blk.nkr - 1) / blk.nkr;
  T* out = static_cast<T*>(p.out);
  for (int e = blk.kr * share + threadIdx.x; e < min(ne, (blk.kr + 1) * share); e += 32 * NW) {
    const int r = e / wd, c = e - r * wd;
    float mx = kNegBig;
    for (int j = 0; j < blk.nkr; ++j) mx = fmaxf(mx, rm[j * kGroup + r]);
    float a = 0.f, ls = 0.f;
    for (int j = 0; j < blk.nkr; ++j) {
      const float f = expf(rm[j * kGroup + r] - mx);
      a += racc[j * share + e - blk.kr * share] * f;
      ls += rl[j * kGroup + r] * f;
    }
    const float lc = fmaxf(ls, 1e-30f);
    out[((size_t)(blk.b * p.lq + g0 + r) * p.H + blk.h) * p.d + blk.c0 + c] =
        fv::from_float<T>(a / lc);
    if (blk.c0 + c == 0) p.lse[(size_t)block_row() * p.lq + g0 + r] = mx + logf(lc);
  }
}

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
template <typename T, int NW, typename Params, bool kP>
__device__ __forceinline__ Tile next_tile(const Params& p, Block<T, kP>& blk, char* ring, int dp,
                                          int it) {
  constexpr int KT = Wide<T>::kKeys;
  const int St = p.stages, tid = threadIdx.x, k0 = blk.kv_begin + it * KT;
  const size_t sb = stage_bytes<T>(dp);
  constexpr bool kBulk = kP && sizeof(T) == 2;
  // bulk copies: this thread's generic writes to a stage (its shift, staged
  // dk and dv) ordered before the bulk copies that refill it
  if constexpr (kBulk) tc::fence_proxy_async();
  tc::cp_async_wait(St - 2);
  if constexpr (kBulk) {
    hp::mbar_wait(&blk.rbar[it % St], (blk.rphase >> (it % St)) & 1u);
    blk.rphase ^= 1u << (it % St);
  }
  if (tid < KT) tc::bulk_wait_read();
  __syncthreads();
  WIDE_PHASE(2);
  const int nxt = it + St - 1;
  if (nxt < blk.ntiles)
    stage_kv<T, NW, kBulk>(ring + (nxt % St) * sb, kBulk ? blk.rbar + nxt % St : nullptr, blk.k,
                           p.k_st, blk.v, p.v_st, blk.mask, blk.kv_begin + nxt * KT, blk.kv_end,
                           blk.wd, dp, tid);
  tc::cp_async_commit();
  WIDE_PHASE(3);
  char* st = ring + (it % St) * sb;
  if (blk.aligned && k0 + KT <= blk.kv_end) {
    WIDE_PHASE(4);
    return {st, blk.mask != nullptr};
  }
  shift_stage<T, NW>(st, blk.k, p.k_st, blk.v, p.v_st, blk.mask != nullptr, k0, blk.kv_end,
                     blk.wd, dp, tid);
  __syncthreads();
  WIDE_PHASE(4);
  return {st, true};
}

// The first stages - 1 tiles of a pass over the block's keys, issued.
// (Bulk copies: after every thread's generic writes to the ring, fenced,
// are done: the copies write it through the async proxy.)
template <typename T, int NW, typename Params, bool kP>
__device__ __forceinline__ void prime_ring(const Params& p, const Block<T, kP>& blk, char* ring,
                                           int dp) {
  constexpr int KT = Wide<T>::kKeys;
  constexpr bool kBulk = kP && sizeof(T) == 2;
  const size_t sb = stage_bytes<T>(dp);
  if constexpr (kBulk) {
    tc::fence_proxy_async();
    __syncthreads();
  }
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < blk.ntiles)
      stage_kv<T, NW, kBulk>(ring + s * sb, kBulk ? blk.rbar + s : nullptr, blk.k, p.k_st, blk.v,
                             p.v_st, blk.mask, blk.kv_begin + s * KT, blk.kv_end, blk.wd, dp,
                             threadIdx.x);
    tc::cp_async_commit();
  }
}

// bf16 on tensor cores. Per 32-key tile: S = Q K^T with warp w on query
// tile w / 4 and keys 8 (w % 4) .. + 7 (f32 scores into shared memory: with
// panels, into this block's exchange slot and its peers', then summed in
// panel order); the online softmax of row r by warp r % 8, a key a lane (m
// and l in registers; round(p e) into shared memory, the row's correction
// beside it); then acc = acc * corr + P V on the warp's n8 column tiles
// [w * ntw, (w + 1) * ntw) of every query tile, in registers across the key
// loop.
template <bool kPanels>
__global__ void __launch_bounds__(32 * kWarps, 1) flash_fwd_wide_tc(FwdParams p) {
  constexpr int KT = Wide<bf16>::kKeys, SP = KT + 4, PP = KT + 8, kThreads = 32 * kWarps;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  WIDE_PHASE_INIT();
  // one panel: the head padded, as the host reckons p.dp, in a form the
  // compiler knows to be a multiple of 16
  const int dp = kPanels ? p.dp : pad_dim(p.d, 16), P = dp + 8, nt8 = dp / 8;
  const int ntw = (nt8 + kWarps - 1) / kWarps, panels = kPanels ? p.panels : 1;
  const FwdOffsets L = p.off;
  char* ring = reinterpret_cast<char*>(wide_smem);
  bf16* qs = reinterpret_cast<bf16*>(wide_smem + L.qs);
  float* sc = reinterpret_cast<float*>(wide_smem + L.sc);
  bf16* ps = reinterpret_cast<bf16*>(wide_smem + L.ps);
  float* corr_s = reinterpret_cast<float*>(wide_smem + L.corr);
  float* rm = reinterpret_cast<float*>(wide_smem + L.rm);
  float* rl = reinterpret_cast<float*>(wide_smem + L.rl);
  float* racc = reinterpret_cast<float*>(wide_smem + L.racc);

  tc::cg::cluster_group cluster = tc::cg::this_cluster();
  Block<bf16, kPanels> blk(p, cluster);
  Xchg xg = make_xchg<kPanels>(wide_smem + L.xb, slot_floats<bf16>(kGroup, false), blk, cluster);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int n0 = warp * ntw, npass = kPanels ? passes_of(p) : 1;

  for (int g0 = 0; g0 < p.lq; g0 += kGroup) {
    const int nq = min(kGroup, p.lq - g0), nmt = (nq + 15) >> 4;
    for (int pass = 0; pass < npass; ++pass) {
      const int mode = kPanels ? mode_of(p, pass) : kFused;
      if constexpr (kPanels) blk.panel(p, pass % p.passes);
      prime_ring<bf16, kWarps>(p, blk, ring, dp);
      if (mode != kOutput)
        load_rows<bf16, kWarps>(qs, blk.q, p.q_st, g0, kGroup, p.lq, blk.wd, dp, tid);
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
        const bool exchange = kPanels && mode != kOutput;
        if (mode != kOutput) {  // scores of the warp's 16 queries and 8 keys over the panel
          if (exchange && tid == 0)
            hp::mbar_expect_tx(&xg.bar[xg.tick & 1],
                               (panels - 1) * nmt * 16 * KT * (int)sizeof(float));
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
            const int off = (mt * 16 + g) * SP + nk + 2 * t;
            if constexpr (kPanels) {
              float* own = xg.at(xg.tick & 1, blk.pan, panels);
              share(blk, panels, own + off, &xg.bar[xg.tick & 1], s4[0], s4[1]);
              share(blk, panels, own + off + 8 * SP, &xg.bar[xg.tick & 1], s4[2], s4[3]);
            } else {
              *reinterpret_cast<float2*>(sc + off) = make_float2(s4[0], s4[1]);
              *reinterpret_cast<float2*>(sc + off + 8 * SP) = make_float2(s4[2], s4[3]);
            }
          }
        }
        __syncthreads();
        if (exchange) {
          WIDE_PHASE(12);
          xchg_wait(xg);
        }
        WIDE_PHASE(5);
        {  // online softmax of the warp's rows, one key a lane
          const float mkv = tile.mask(mk, lane);
          const bool live = k0 + lane < blk.kv_end;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int r = warp + kWarps * s;
            if (r < nq) {
              float sv;
              if constexpr (kPanels) {
                float* held =
                    mode == kFused
                        ? nullptr
                        : p.scores + ((size_t)block_row() * p.lq + g0 + r) * p.lkv + k0 + lane;
                if (mode == kOutput) {
                  sv = live ? *held : 0.f;
                } else {
                  sv = panel_sum(xg, panels, r * SP + lane);
                  if (mode == kScore) {  // panel 0 adds the pass's sum to the scratch
                    if (blk.pan == 0 && live) *held = (pass > 0 ? *held : 0.f) + sv;
                    continue;
                  }
                }
              } else {
                sv = sc[r * SP + lane];
              }
              const float x = sv * p.scale + (mkv - 1.f) * 1e30f;
              const float m_new = fmaxf(m[s], warp_max(x, 32)), corr = __expf(m[s] - m_new);
              m[s] = m_new;
              float pr = __expf(x - m_new) * mkv;
              l[s] = l[s] * corr + pr;  // the lane's key; the warp sums at the end
              if (p.dropout)
                pr *= keep(blk.seed, blk.hrow, g0 + r, k0 + lane, p.threshold, p.keep_scale);
              ps[r * PP + lane] = __float2bfloat16(pr);
              if (lane == 0) corr_s[r] = corr;
            }
          }
        }
        if (exchange) ++xg.tick;
        if (mode == kScore) continue;
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
      if (mode == kScore) {  // the scratch is whole once every panel 0 is done
        if (pass == p.passes - 1)
          cluster.sync();
        else
          __syncthreads();  // every warp is done with the ring and q before the next pass
        continue;
      }
      // where the pushed acc aliases the ring, every block of the cluster is
      // done with its ring before any block pushes into it
      if (p.alias) cluster.sync();
      const int share = (nq * blk.wd + blk.nkr - 1) / blk.nkr;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int r = warp + kWarps * s;
        if (r < nq) push_ml(rm, rl, blk, panels, r, m[s], warp_sum(l[s], 32), lane);
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
              if (r < nq && c < blk.wd)
                push_elem(racc, blk, panels, share, r * blk.wd + c, acc[mt][i][e]);
            }
        }
      WIDE_PHASE(8);
      cluster.sync();
      WIDE_PHASE(9);
      merge_out<bf16, kWarps>(p, rm, rl, racc, blk, g0, nq);
      WIDE_PHASE(10);
      // before the next pushes, every block is done reading these
      if (g0 + kGroup < p.lq || pass + 1 < npass) cluster.sync();
      WIDE_PHASE(11);
    }
  }
  WIDE_PHASE_FLUSH();
}

// f32 on the CUDA cores, the key loop and push of one query group for a
// warp that owns NS of its rows (row r by warp r % 8, slot r / 8). Per
// 16-key tile: lane l takes key l % 16 over the float4 chunks of half l / 16
// of the panel (the halves added by a shuffle; with panels, the panels'
// partials added through the exchange), the online softmax runs in
// registers and shuffles, p goes to the warp's rows in shared memory, and
// acc += p V over columns lane + 32 i, all in registers across the loop.
template <int NS, bool kPanels>
__device__ __forceinline__ void fwd_f32_group(const FwdParams& p, Block<float, kPanels>& blk,
                                              tc::cg::cluster_group& cluster, Xchg& xg,
                                              char* ring, const float* qs, float* ps, float* rm,
                                              float* rl, float* racc, int dp, int g0, int nq,
                                              int mode, int pass) {
  constexpr int KT = Wide<float>::kKeys, NSA = NS > 0 ? NS : 1;
  const int P = dp + 4, cpl = dp / 32, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int key = lane & 15, half = lane >> 4, panels = kPanels ? p.panels : 1;
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
    const bool exchange = kPanels && mode != kOutput;
    if (exchange && tid == 0)
      hp::mbar_expect_tx(&xg.bar[xg.tick & 1], (panels - 1) * nq * KT * (int)sizeof(float));
    if constexpr (NS > 0) {
      const float* ks = reinterpret_cast<const float*>(tile.st);
      const float* vs = ks + KT * P;
      const float mkv = tile.mask(vs + KT * P, key);
      const int k0 = blk.kv_begin + it * KT;
      const bool live = k0 + key < blk.kv_end;
      float sc[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) sc[s] = 0.f;
      if (mode == kOutput) {
#pragma unroll
        for (int s = 0; s < NS; ++s)
          sc[s] = live ? p.scores[((size_t)block_row() * p.lq + g0 + warp + kWarps * s) * p.lkv + k0 +
                                  key]
                       : 0.f;
      } else {
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
#pragma unroll
        for (int s = 0; s < NS; ++s) sc[s] += __shfl_xor_sync(0xffffffffu, sc[s], 16);
        if constexpr (kPanels) {
          float* own = xg.at(xg.tick & 1, blk.pan, panels);
          if (half == 0)
#pragma unroll
            for (int s = 0; s < NS; ++s)
              share(blk, panels, own + (warp + kWarps * s) * KT + key, &xg.bar[xg.tick & 1],
                    sc[s]);
          __syncwarp();
          WIDE_PHASE(12);
          xchg_wait(xg);
#pragma unroll
          for (int s = 0; s < NS; ++s)
            sc[s] = panel_sum(xg, panels, (warp + kWarps * s) * KT + key);
          if (mode == kScore && blk.pan == 0 && half == 0 && live)
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              float* held =
                  p.scores + ((size_t)block_row() * p.lq + g0 + warp + kWarps * s) * p.lkv + k0 + key;
              *held = (pass > 0 ? *held : 0.f) + sc[s];
            }
        }
      }
      WIDE_PHASE(5);
      if (mode != kScore) {
        float x[NS], mx[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) mx[s] = x[s] = sc[s] * p.scale + (mkv - 1.f) * 1e30f;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
#pragma unroll
          for (int s = 0; s < NS; ++s)
            mx[s] = fmaxf(mx[s], __shfl_xor_sync(0xffffffffu, mx[s], off));
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float m_new = fmaxf(m[s], mx[s]), corr = __expf(m[s] - m_new);
          m[s] = m_new;
          x[s] = __expf(x[s] - m_new) * mkv;
          l[s] = l[s] * corr + x[s];  // the lane's key (twice in the warp); summed at the end
#pragma unroll
          for (int i = 0; i < kMaxCpl; ++i) a[s][i] *= corr;
          if (p.dropout)
            x[s] *= keep(blk.seed, blk.hrow, g0 + warp + kWarps * s, k0 + key, p.threshold,
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
    if (exchange) ++xg.tick;
  }
  tc::cp_async_wait(0);  // only empty groups are left
  if (mode == kScore) return;
  if (p.alias) cluster.sync();
  const int share = (nq * blk.wd + blk.nkr - 1) / blk.nkr;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int r = warp + kWarps * s;
    push_ml(rm, rl, blk, panels, r, m[s], warp_sum(l[s], 16), lane);
#pragma unroll
    for (int i = 0; i < kMaxCpl; ++i) {
      const int c = lane + 32 * i;
      if (i < cpl && c < blk.wd) push_elem(racc, blk, panels, share, r * blk.wd + c, a[s][i]);
    }
  }
}

template <bool kPanels>
__global__ void __launch_bounds__(32 * kWarps, 1) flash_fwd_wide_fma(FwdParams p) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  WIDE_PHASE_INIT();
  const int dp = kPanels ? p.dp : pad_dim(p.d, 32);
  const FwdOffsets L = p.off;
  char* ring = reinterpret_cast<char*>(wide_smem);
  float* qs = reinterpret_cast<float*>(wide_smem + L.qs);
  float* ps = reinterpret_cast<float*>(wide_smem + L.ps);
  float* rm = reinterpret_cast<float*>(wide_smem + L.rm);
  float* rl = reinterpret_cast<float*>(wide_smem + L.rl);
  float* racc = reinterpret_cast<float*>(wide_smem + L.racc);
  tc::cg::cluster_group cluster = tc::cg::this_cluster();
  Block<float, kPanels> blk(p, cluster);
  Xchg xg = make_xchg<kPanels>(wide_smem + L.xb, slot_floats<float>(kGroup, false), blk, cluster);
  const int warp = threadIdx.x >> 5, npass = kPanels ? passes_of(p) : 1;
  for (int g0 = 0; g0 < p.lq; g0 += kGroup) {
    const int nq = min(kGroup, p.lq - g0);
    for (int pass = 0; pass < npass; ++pass) {
      const int mode = kPanels ? mode_of(p, pass) : kFused;
      if constexpr (kPanels) blk.panel(p, pass % p.passes);
      prime_ring<float, kWarps>(p, blk, ring, dp);
      if (mode != kOutput)
        load_rows<float, kWarps>(qs, blk.q, p.q_st, g0, kGroup, p.lq, blk.wd, dp, threadIdx.x);
#define FWD_GROUP(NS)                                                                         \
  fwd_f32_group<NS, kPanels>(p, blk, cluster, xg, ring, qs, ps, rm, rl, racc, dp, g0, nq, mode, \
                             pass)
      switch (slots_of<kWarps>(warp, nq)) {
        case 0: FWD_GROUP(0); break;
        case 1: FWD_GROUP(1); break;
        case 2: FWD_GROUP(2); break;
        case 3: FWD_GROUP(3); break;
        default: FWD_GROUP(4); break;
      }
#undef FWD_GROUP
      if (mode == kScore) {  // the scratch is whole once every panel 0 is done
        if (pass == p.passes - 1)
          cluster.sync();
        else
          __syncthreads();  // every warp is done with the ring and q before the next pass
        continue;
      }
      WIDE_PHASE(8);
      cluster.sync();
      WIDE_PHASE(9);
      merge_out<float, kWarps>(p, rm, rl, racc, blk, g0, nq);
      WIDE_PHASE(10);
      if (g0 + kGroup < p.lq || pass + 1 < npass) cluster.sync();
      WIDE_PHASE(11);
    }
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
  float* scores;       // (2, B*H, lq, lkv) f32 (s, dp) where passes > 1, else null
  BwdOffsets off;      // the shared-memory layout
  int H, lq, lkv, d, dp, panels, passes, units, keys_per_cta, stages, alias, q_chunk, n_chunks;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st, mask_sb;
  float scale;
  int dropout;
  const uint32_t* seed;  // the 32-bit hash seed, in device memory (read once a block)
  uint32_t threshold;
  float keep_scale;
  uint32_t row_offset;  // the hash rows: row_offset + b * head_stride + h
  int head_stride;
};

// The backward's scratch of s (which 0) or dp (1) at (query q, key kv).
__device__ __forceinline__ float* held_at(const BwdParams& p, int which, int row, int q, int kv) {
  return p.scores + (((size_t)which * gridDim.y + row) * p.lq + q) * p.lkv + kv;
}

// dk or dv elements (x0, and x1 where `pair`) of tile key j (key k0 + j;
// at or past kv_end: nothing), columns c and c + 1 of the panel (of wd;
// column c0 + c of the head's ld), summed over this query chunk: carried
// over the chunks in f32 by this thread alone, in chunk order, and on the
// last chunk staged (times `scale`) at stage[j P + c] for the tile's store
// (a stage row's pitch P is odd in 16-byte units, so the rows of one store
// fall on distinct banks).
template <typename T>
__device__ __forceinline__ void put_dkv(T* stage, int P, float* acc, int k0, int j, int kv_end,
                                        int c, int wd, int ld, int c0, float x0, float x1,
                                        bool pair, float scale, bool first, bool last) {
  if (k0 + j >= kv_end || c >= wd) return;
  pair = pair && c + 1 < wd;
  if (acc != nullptr) {
    const size_t off = (size_t)(k0 + j) * ld + c0 + c;
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
// only on the last query chunk, into columns [c0, c0 + wd) of rows of ld: a
// bulk asynchronous copy a row, thread j (< KT) issuing row j of both,
// where the rows start and end on 16 bytes (next_tile waits for them to
// read the stage before it is refilled), else a warp a row.
template <typename T, int NW>
__device__ __forceinline__ void store_dkv(const T* stage, int P, T* dk, T* dv, int k0,
                                          int kv_end, int wd, int ld, int c0, bool last) {
  constexpr int KT = Wide<T>::kKeys;
  if (!last) return;
  const int nk = min(KT, kv_end - k0), bytes = wd * (int)sizeof(T), tid = threadIdx.x;
  T *dv_out = dv + (size_t)k0 * ld + c0, *dk_out = dk + (size_t)k0 * ld + c0;
  const bool bulk = ((reinterpret_cast<uintptr_t>(dv_out) | reinterpret_cast<uintptr_t>(dk_out) |
                      bytes | (ld * (int)sizeof(T))) & 15) == 0;
  if (bulk) tc::fence_proxy_async();
  __syncthreads();
  if (bulk) {
    if (tid < nk) {
      tc::bulk_store(dv_out + (size_t)tid * ld, stage + tid * P, bytes);
      tc::bulk_store(dk_out + (size_t)tid * ld, stage + (KT + tid) * P, bytes);
      tc::bulk_commit();
    }
    return;
  }
  for (int r = tid >> 5; r < 2 * nk; r += NW) {
    const int j = r < nk ? r : r - nk;
    const T* src = stage + (r < nk ? j : KT + j) * P;
    T* dst = (r < nk ? dv_out : dk_out) + (size_t)j * ld;
    for (int c = tid & 31; c < wd; c += 32) dst[c] = src[c];
  }
}

// The chunk's dq on this block's panel after the cluster barrier: the key
// ranges' parts added in range order, scaled once.
template <typename T, int NW, bool kP>
__device__ __forceinline__ void merge_dq(const BwdParams& p, const float* rdq,
                                         const Block<T, kP>& blk, int q0c, int nq) {
  const int wd = blk.wd, ne = nq * wd, share = (ne + blk.nkr - 1) / blk.nkr;
  T* dq = static_cast<T*>(p.dq) + ((size_t)block_row() * p.lq + q0c) * p.d + blk.c0;
  for (int e = blk.kr * share + threadIdx.x; e < min(ne, (blk.kr + 1) * share); e += 32 * NW) {
    float a = 0.f;
    for (int j = 0; j < blk.nkr; ++j) a += rdq[j * share + e - blk.kr * share];
    const int r = e / wd;
    dq[(size_t)r * p.d + e - r * wd] = fv::from_float<T>(a * p.scale);
  }
}

// The per-chunk prologue both backward kernels share: q, dO, lse and delta
// of the chunk's rows on the block's panel (padded queries: q = dO = 0,
// lse = 1e30 so that their probabilities are 0, delta = 0).
template <typename T, int NW, bool kP>
__device__ __forceinline__ void load_chunk(const BwdParams& p, const Block<T, kP>& blk,
                                           const T* dout, T* qs, T* dos, float* lse_s,
                                           float* del_s, int rows, int q0c, int nq, int dp) {
  const int tid = threadIdx.x;
  load_rows<T, NW>(qs, blk.q, p.q_st, q0c, rows, q0c + nq, blk.wd, dp, tid);
  load_rows<T, NW>(dos, dout + blk.c0, p.o_st, q0c, rows, q0c + nq, blk.wd, dp, tid);
  for (int i = tid; i < rows; i += 32 * NW) {
    lse_s[i] = i < nq ? p.lse[(size_t)block_row() * p.lq + q0c + i] : 1e30f;
    del_s[i] = i < nq ? p.delta[(size_t)block_row() * p.lq + q0c + i] : 0.f;
  }
}

// bf16 dv = round(p e)^T dO or dk = round(ds)^T q of the tile's 32 keys on
// the warp's column tiles: keys on M (two m16 tiles), columns on N, the
// chunk's queries on K (A from the [key][query] tile `src`, B from the
// query rows `rows_s`); then carried or staged (times `scale`, put_dkv).
__device__ __forceinline__ void tile_dkdv_tc(const bf16* src, const bf16* rows_s, bf16* stage,
                                             float* acc, int QP, int P, int nmt, int n0, int ntw,
                                             int nt8, int k0, int kv_end, int wd, int ld, int c0,
                                             float scale, bool first, bool last) {
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
          put_dkv<bf16>(stage, P, acc, k0, km * 16 + g + 8 * hr, kv_end, (n0 + i) * 8 + 2 * t, wd,
                        ld, c0, o[km][i][2 * hr], o[km][i][2 * hr + 1], true, scale, first, last);
}

// bf16 on tensor cores. Per 32-key tile and query chunk: s = q K^T and
// dp = dO V^T with warp w on query tile w / 4 and keys 8 (w % 4) .. + 7
// (with panels, summed over the panels through the exchange); p, round(p e)
// and round(ds) from the fragments into [key][query] tiles; then
// dq += round(ds) K, dv and dk of the tile's keys, each on the warp's n8
// column tiles (dq in registers across the key loop, dv and dk finished in
// the tile's visit, staged in the tile's spent ring stage and stored with
// coalesced 16-byte stores).
template <bool kPanels>
__global__ void __launch_bounds__(32 * kWarps, 1) flash_bwd_wide_tc(BwdParams p) {
  constexpr int KT = Wide<bf16>::kKeys, SP = Wide<bf16>::kXPitch;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  WIDE_PHASE_INIT();
  const int dp = kPanels ? p.dp : pad_dim(p.d, 16), P = dp + 8, nt8 = dp / 8;
  const int ntw = (nt8 + kWarps - 1) / kWarps;
  const int rows = chunk_rows<bf16>(p.q_chunk), QP = rows + 8;
  const int panels = kPanels ? p.panels : 1;
  const BwdOffsets L = p.off;
  char* ring = reinterpret_cast<char*>(wide_smem);
  bf16* qs = reinterpret_cast<bf16*>(wide_smem + L.qs);
  bf16* dos = reinterpret_cast<bf16*>(wide_smem + L.dos);
  float* lse_s = reinterpret_cast<float*>(wide_smem + L.lse);
  float* del_s = reinterpret_cast<float*>(wide_smem + L.del);
  bf16* pt = reinterpret_cast<bf16*>(wide_smem + L.pd);  // round(p e) [key][query]
  bf16* dst = pt + KT * QP;                                // round(ds) [key][query]
  float* rdq = reinterpret_cast<float*>(wide_smem + L.rdq);

  tc::cg::cluster_group cluster = tc::cg::this_cluster();
  Block<bf16, kPanels> blk(p, cluster);
  Xchg xg = make_xchg<kPanels>(wide_smem + L.xb, slot_floats<bf16>(rows, true), blk, cluster);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int n0 = warp * ntw, npass = kPanels ? passes_of(p) : 1;
  const bf16* dout = static_cast<const bf16*>(p.dout) + blk.b * p.o_sb + blk.h * p.o_sh;
  bf16* dk = static_cast<bf16*>(p.dk) + (size_t)block_row() * p.lkv * p.d;
  bf16* dv = static_cast<bf16*>(p.dv) + (size_t)block_row() * p.lkv * p.d;
  float* dk_acc = p.dkv_acc ? p.dkv_acc + (size_t)block_row() * p.lkv * p.d : nullptr;
  float* dv_acc = p.dkv_acc ? dk_acc + (size_t)gridDim.y * p.lkv * p.d : nullptr;

  for (int chunk = 0; chunk < p.n_chunks; ++chunk) {
    const int q0c = chunk * p.q_chunk, nq = min(p.q_chunk, p.lq - q0c), nmt = (nq + 15) >> 4;
    const bool first = chunk == 0, last = chunk == p.n_chunks - 1;
    for (int pass = 0; pass < npass; ++pass) {
      const int mode = kPanels ? mode_of(p, pass) : kFused;
      if constexpr (kPanels) blk.panel(p, pass % p.passes);
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
        const bool exchange = kPanels && mode != kOutput;
        if (exchange && tid == 0)
          hp::mbar_expect_tx(&xg.bar[xg.tick & 1],
                             (panels - 1) * nmt * 16 * KT * 2 * (int)sizeof(float));
        {  // s and dp of the warp's 16 queries and 8 keys; p, round(p e), round(ds)
          const int mt = warp >> 2, nk = (warp & 3) * 8;
          if (mt < nmt) {
            float s4[4] = {0.f, 0.f, 0.f, 0.f}, d4[4] = {0.f, 0.f, 0.f, 0.f};
            if (mode == kOutput) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qi = mt * 16 + g + 8 * (e >> 1), kc = nk + 2 * t + (e & 1);
                if (qi < nq && k0 + kc < blk.kv_end) {
                  s4[e] = *held_at(p, 0, block_row(), q0c + qi, k0 + kc);
                  d4[e] = *held_at(p, 1, block_row(), q0c + qi, k0 + kc);
                }
              }
            } else {
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
              if constexpr (kPanels) {
                const int off = (mt * 16 + g) * SP + nk + 2 * t, dpo = rows * SP;
                float* own = xg.at(xg.tick & 1, blk.pan, panels);
                const uint64_t* bar = &xg.bar[xg.tick & 1];
                share(blk, panels, own + off, bar, s4[0], s4[1]);
                share(blk, panels, own + off + 8 * SP, bar, s4[2], s4[3]);
                share(blk, panels, own + dpo + off, bar, d4[0], d4[1]);
                share(blk, panels, own + dpo + off + 8 * SP, bar, d4[2], d4[3]);
                WIDE_PHASE(12);
                xchg_wait(xg);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int at = off + (e >> 1) * 8 * SP + (e & 1);
                  s4[e] = panel_sum(xg, panels, at);
                  d4[e] = panel_sum(xg, panels, dpo + at);
                }
                if (mode == kScore && blk.pan == 0)
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    const int qi = mt * 16 + g + 8 * (e >> 1), kc = nk + 2 * t + (e & 1);
                    if (qi < nq && k0 + kc < blk.kv_end) {
                      float* hs = held_at(p, 0, block_row(), q0c + qi, k0 + kc);
                      float* hd = held_at(p, 1, block_row(), q0c + qi, k0 + kc);
                      *hs = (pass > 0 ? *hs : 0.f) + s4[e];
                      *hd = (pass > 0 ? *hd : 0.f) + d4[e];
                    }
                  }
              }
            }
            if (mode != kScore)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qi = mt * 16 + g + 8 * (e >> 1), kc = nk + 2 * t + (e & 1);
                const float mkv = tile.mask(mk, kc);
                const float sx = s4[e] * p.scale + (mkv - 1.f) * 1e30f;
                const float pr = __expf(sx - lse_s[qi]) * mkv;
                const float ev =
                    p.dropout ? keep(blk.seed, blk.hrow, q0c + qi, k0 + kc, p.threshold, p.keep_scale)
                              : 1.f;
                pt[kc * QP + qi] = __float2bfloat16(pr * ev);
                dst[kc * QP + qi] = __float2bfloat16(pr * (d4[e] * ev - del_s[qi]));
              }
          }
        }
        if (exchange) ++xg.tick;
        if (mode == kScore) continue;
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
        tile_dkdv_tc(pt, dos, sdv, dv_acc, QP, P, nmt, n0, ntw, nt8, k0, blk.kv_end, blk.wd, p.d,
                     blk.c0, 1.f, first, last);
        tile_dkdv_tc(dst, qs, sdv + KT * P, dk_acc, QP, P, nmt, n0, ntw, nt8, k0, blk.kv_end,
                     blk.wd, p.d, blk.c0, p.scale, first, last);
        store_dkv<bf16, kWarps>(sdv, P, dk, dv, k0, blk.kv_end, blk.wd, p.d, blk.c0, last);
        WIDE_PHASE(7);
      }
      tc::cp_async_wait(0);  // only empty groups are left
      if (tid < KT) tc::bulk_wait();  // the tiles' dk and dv are stored
      if (mode == kScore) {  // the scratch is whole once every panel 0 is done
        if (pass == p.passes - 1)
          cluster.sync();
        else
          __syncthreads();  // every warp is done with the ring and q before the next pass
        continue;
      }
      if (p.alias) cluster.sync();  // every ring is idle before the pushes land in it
      const int share = (nq * blk.wd + blk.nkr - 1) / blk.nkr;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < kMaxNt; ++i) {
          const int n = n0 + i;
          if (mt < nmt && i < ntw && n < nt8)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = mt * 16 + g + 8 * (e >> 1), c = n * 8 + 2 * t + (e & 1);
              if (r < nq && c < blk.wd)
                push_elem(rdq, blk, panels, share, r * blk.wd + c, dqa[mt][i][e]);
            }
        }
      WIDE_PHASE(8);
      cluster.sync();
      WIDE_PHASE(9);
      merge_dq<bf16, kWarps>(p, rdq, blk, q0c, nq);
      WIDE_PHASE(10);
      // before the next pushes, every block is done reading these
      if (!last || pass + 1 < npass) cluster.sync();
    }
  }
  WIDE_PHASE_FLUSH();
}

// f32 on the CUDA cores, the key loop and push of one query chunk for a
// warp that owns NS of its rows. Per 16-key tile: s and dp of the warp's
// rows as in the forward (a key a lane over half the panel; with panels,
// summed over them through the exchange), p, round(p e) and round(ds) into
// [query][key] rows, dq += ds K over columns lane + 32 i in registers; after
// a block barrier, thread (warp w, lane l) finishes dv and dk of keys
// 4 (l / 8) .. + 3 on columns 8 w + l % 8 + 128 c over the chunk's queries,
// staged in the tile's spent ring stage for a coalesced store. kCpl: the
// most columns lane + 32 i a lane's dq holds (the panel's dp / 32).
template <int NS, bool kPanels, int kCpl>
__device__ __forceinline__ void bwd_f32_chunk(const BwdParams& p, Block<float, kPanels>& blk,
                                              tc::cg::cluster_group& cluster, Xchg& xg,
                                              char* ring, const float* qs, const float* dos,
                                              const float* lse_s, const float* del_s, float* pd,
                                              float* rdq, float* dk, float* dv, float* dk_acc,
                                              float* dv_acc, int dp, int rows, int q0c, int nq,
                                              bool first, bool last, int mode, int pass) {
  constexpr int KT = Wide<float>::kKeys, NSA = NS > 0 ? NS : 1, NW = kBwdF32Warps;
  constexpr int CS = 8 * NW, CQ = (32 * kCpl + CS - 1) / CS;  // a thread's columns: cb + CS c
  const int P = dp + 4, cpl = dp / 32, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int key = lane & 15, half = lane >> 4, panels = kPanels ? p.panels : 1;
  float* ds = pd + rows * KT;
  float dqa[NSA][kCpl];
#pragma unroll
  for (int s = 0; s < NSA; ++s)
#pragma unroll
    for (int i = 0; i < kCpl; ++i) dqa[s][i] = 0.f;
  WIDE_PHASE(1);
  for (int it = 0; it < blk.ntiles; ++it) {
    const Tile tile = next_tile<float, NW>(p, blk, ring, dp, it);
    char* st = tile.st;
    const float* ks = reinterpret_cast<const float*>(st);
    const float* vs = ks + KT * P;
    const int k0 = blk.kv_begin + it * KT;
    const bool exchange = kPanels && mode != kOutput;
    if (exchange && tid == 0)
      hp::mbar_expect_tx(&xg.bar[xg.tick & 1], (panels - 1) * nq * KT * 2 * (int)sizeof(float));
    if constexpr (NS > 0) {
      const float mkv = tile.mask(vs + KT * P, key);
      const bool live = k0 + key < blk.kv_end;
      float sv[NS], dpv[NS];
      if (mode == kOutput) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int r = warp + NW * s;
          sv[s] = live ? *held_at(p, 0, block_row(), q0c + r, k0 + key) : 0.f;
          dpv[s] = live ? *held_at(p, 1, block_row(), q0c + r, k0 + key) : 0.f;
        }
      } else {
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
          sv[s] = sd[0][s] + __shfl_xor_sync(0xffffffffu, sd[0][s], 16);
          dpv[s] = sd[1][s] + __shfl_xor_sync(0xffffffffu, sd[1][s], 16);
        }
        if constexpr (kPanels) {
          float* own = xg.at(xg.tick & 1, blk.pan, panels);
          if (half == 0)
#pragma unroll
            for (int s = 0; s < NS; ++s)
              share(blk, panels, own + ((warp + NW * s) * KT + key) * 2, &xg.bar[xg.tick & 1],
                    sv[s], dpv[s]);
          __syncwarp();
          WIDE_PHASE(12);
          xchg_wait(xg);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int at = ((warp + NW * s) * KT + key) * 2;
            sv[s] = panel_sum(xg, panels, at);
            dpv[s] = panel_sum(xg, panels, at + 1);
          }
          if (mode == kScore && blk.pan == 0 && half == 0 && live)
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              float* hs = held_at(p, 0, block_row(), q0c + warp + NW * s, k0 + key);
              float* hd = held_at(p, 1, block_row(), q0c + warp + NW * s, k0 + key);
              *hs = (pass > 0 ? *hs : 0.f) + sv[s];
              *hd = (pass > 0 ? *hd : 0.f) + dpv[s];
            }
        }
      }
      if (mode != kScore) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int r = warp + NW * s;
          const float x = sv[s] * p.scale + (mkv - 1.f) * 1e30f;
          const float pr = __expf(x - lse_s[r]) * mkv;
          const float e =
              p.dropout ? keep(blk.seed, blk.hrow, q0c + r, k0 + key, p.threshold, p.keep_scale)
                        : 1.f;
          if (half == 0) {
            pd[r * KT + key] = pr * e;
            ds[r * KT + key] = pr * (dpv[s] * e - del_s[r]);
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
            for (int i = 0; i < kCpl; ++i) {
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
    }
    if (exchange) ++xg.tick;
    if (mode == kScore) continue;
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
        const float4 sv4 = *reinterpret_cast<const float4*>(ds + i * KT + j0);
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          if (cb + CS * c < dp) {
            const float o = dos[i * P + cb + CS * c], x = qs[i * P + cb + CS * c];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              av[jj][c] = fmaf(fv::at(pv, jj), o, av[jj][c]);
              ak[jj][c] = fmaf(fv::at(sv4, jj), x, ak[jj][c]);
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
          put_dkv<float>(sdv, P, dv_acc, k0, j0 + jj, blk.kv_end, ch, blk.wd, p.d, blk.c0,
                         av[jj][c], 0.f, false, 1.f, first, last);
          put_dkv<float>(sdv + KT * P, P, dk_acc, k0, j0 + jj, blk.kv_end, ch, blk.wd, p.d,
                         blk.c0, ak[jj][c], 0.f, false, p.scale, first, last);
        }
      store_dkv<float, NW>(sdv, P, dk, dv, k0, blk.kv_end, blk.wd, p.d, blk.c0, last);
    }
    WIDE_PHASE(7);
  }
  tc::cp_async_wait(0);  // only empty groups are left
  if (tid < KT) tc::bulk_wait();  // the tiles' dk and dv are stored
  if (mode == kScore) return;
  if (p.alias) cluster.sync();
  const int share = (nq * blk.wd + blk.nkr - 1) / blk.nkr;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int r = warp + NW * s;
#pragma unroll
    for (int i = 0; i < kCpl; ++i) {
      const int c = lane + 32 * i;
      if (i < cpl && c < blk.wd) push_elem(rdq, blk, panels, share, r * blk.wd + c, dqa[s][i]);
    }
  }
}

// (kCpl 12: panels of at most 384 columns, whose dq and dv/dk accumulators
// then fit the 128 registers of 512 threads with fewer spills.)
template <bool kPanels, int kCpl = kMaxCpl>
__global__ void __launch_bounds__(32 * kBwdF32Warps, 1) flash_bwd_wide_fma(BwdParams p) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  WIDE_PHASE_INIT();
  const int dp = kPanels ? p.dp : pad_dim(p.d, 32), rows = chunk_rows<float>(p.q_chunk);
  const BwdOffsets L = p.off;
  char* ring = reinterpret_cast<char*>(wide_smem);
  float* qs = reinterpret_cast<float*>(wide_smem + L.qs);
  float* dos = reinterpret_cast<float*>(wide_smem + L.dos);
  float* lse_s = reinterpret_cast<float*>(wide_smem + L.lse);
  float* del_s = reinterpret_cast<float*>(wide_smem + L.del);
  float* pd = reinterpret_cast<float*>(wide_smem + L.pd);
  float* rdq = reinterpret_cast<float*>(wide_smem + L.rdq);
  tc::cg::cluster_group cluster = tc::cg::this_cluster();
  Block<float, kPanels> blk(p, cluster);
  Xchg xg = make_xchg<kPanels>(wide_smem + L.xb, slot_floats<float>(rows, true), blk, cluster);
  const int warp = threadIdx.x >> 5, npass = kPanels ? passes_of(p) : 1;
  const float* dout = static_cast<const float*>(p.dout) + blk.b * p.o_sb + blk.h * p.o_sh;
  float* dk = static_cast<float*>(p.dk) + (size_t)block_row() * p.lkv * p.d;
  float* dv = static_cast<float*>(p.dv) + (size_t)block_row() * p.lkv * p.d;
  float* dk_acc = p.dkv_acc ? p.dkv_acc + (size_t)block_row() * p.lkv * p.d : nullptr;
  float* dv_acc = p.dkv_acc ? dk_acc + (size_t)gridDim.y * p.lkv * p.d : nullptr;

  for (int chunk = 0; chunk < p.n_chunks; ++chunk) {
    const int q0c = chunk * p.q_chunk, nq = min(p.q_chunk, p.lq - q0c);
    const bool first = chunk == 0, last = chunk == p.n_chunks - 1;
    for (int pass = 0; pass < npass; ++pass) {
      const int mode = kPanels ? mode_of(p, pass) : kFused;
      if constexpr (kPanels) blk.panel(p, pass % p.passes);
      prime_ring<float, kBwdF32Warps>(p, blk, ring, dp);
      load_chunk<float, kBwdF32Warps>(p, blk, dout, qs, dos, lse_s, del_s, rows, q0c, nq, dp);
#define BWD_CHUNK(NS)                                                                        \
  bwd_f32_chunk<NS, kPanels, kCpl>(p, blk, cluster, xg, ring, qs, dos, lse_s, del_s, pd, rdq, dk, \
                                   dv, dk_acc, dv_acc, dp, rows, q0c, nq, first, last, mode, pass)
      switch (slots_of<kBwdF32Warps>(warp, nq)) {
        case 0: BWD_CHUNK(0); break;
        case 1: BWD_CHUNK(1); break;
        default: BWD_CHUNK(2); break;
      }
#undef BWD_CHUNK
      if (mode == kScore) {  // the scratch is whole once every panel 0 is done
        if (pass == p.passes - 1)
          cluster.sync();
        else
          __syncthreads();  // every warp is done with the ring and q before the next pass
        continue;
      }
      WIDE_PHASE(8);
      cluster.sync();
      WIDE_PHASE(9);
      merge_dq<float, kBwdF32Warps>(p, rdq, blk, q0c, nq);
      WIDE_PHASE(10);
      if (!last || pass + 1 < npass) cluster.sync();
    }
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

// A call's head geometry: panels a pass and passes (1, 1: the wide kernels),
// the padded width of its widest panel; false where the kernels take no
// such split.
struct Geometry {
  int panels, passes, units, dp;
  bool panel_kernels() const { return panels > 1 || passes > 1; }
};

template <typename T>
bool geometry(int d, int panels, int passes, Geometry* g) {
  if (d < 1 || panels < 1 || panels > kMaxPanels || passes < 1 ||
      panels * passes > head_units<T>(d))
    return false;
  *g = {panels, passes, head_units<T>(d), panel_dp<T>(d, panels, passes)};
  return g->dp <= kMaxD;
}

// The f32 backward's kernel for a geometry: the wide kernel, or the panel
// kernel with the fewest accumulator columns its panels need (at d 576: 12
// of 16, which cut its spills from 214 to 134 bytes and its time by 19%;
// the forward, which does not spill, gained 1% and keeps one).
using BwdKernel = void (*)(BwdParams);
BwdKernel bwd_fma_kernel(const Geometry& g) {
  if (!g.panel_kernels()) return flash_bwd_wide_fma<false>;
  return g.dp <= 384 ? flash_bwd_wide_fma<true, 12> : flash_bwd_wide_fma<true>;
}

template <typename T>
Plan fwd_plan_of(const Geometry& g) {
  return fwd_plan<T>(g.dp, g.panel_kernels() ? g.panels : 1);
}

template <typename T>
Plan bwd_plan_of(const Geometry& g, int q_chunk) {
  return bwd_plan<T>(g.dp, chunk_rows<T>(q_chunk), g.panel_kernels() ? g.panels : 1);
}

// The backward's largest query chunk: 32 rows, else the most (16 for bf16;
// for f32 any count, 23 at d 512) whose layout fits at two stages.
template <typename T>
int bwd_max_queries(const Geometry& g) {
  for (int rows = kGroup; rows > 0; rows -= sizeof(T) == 2 ? 16 : 1)
    if (bwd_plan_of<T>(g, rows).stages > 0) return rows;
  return 0;
}

template <typename T>
int fwd_max_clusters(const Geometry& g, int cluster) {
  const Plan pl = fwd_plan_of<T>(g);
  if (pl.stages == 0) return -1;
  if constexpr (sizeof(T) == 2)
    return g.panel_kernels()
               ? wide_max_clusters<kWarps>(flash_fwd_wide_tc<true>, cluster, pl.smem)
               : wide_max_clusters<kWarps>(flash_fwd_wide_tc<false>, cluster, pl.smem);
  else
    return g.panel_kernels()
               ? wide_max_clusters<kWarps>(flash_fwd_wide_fma<true>, cluster, pl.smem)
               : wide_max_clusters<kWarps>(flash_fwd_wide_fma<false>, cluster, pl.smem);
}

template <typename T>
int bwd_max_clusters(const Geometry& g, int q_chunk, int cluster) {
  const Plan pl = bwd_plan_of<T>(g, q_chunk);
  if (pl.stages == 0) return -1;
  if constexpr (sizeof(T) == 2)
    return g.panel_kernels()
               ? wide_max_clusters<kWarps>(flash_bwd_wide_tc<true>, cluster, pl.smem)
               : wide_max_clusters<kWarps>(flash_bwd_wide_tc<false>, cluster, pl.smem);
  else
    return wide_max_clusters<kBwdF32Warps>(bwd_fma_kernel(g), cluster, pl.smem);
}

bool get_geometry(int d, int is_bf16, int panels, int passes, Geometry* g) {
  return is_bf16 ? geometry<bf16>(d, panels, passes, g) : geometry<float>(d, panels, passes, g);
}

}  // namespace

// The widest head (or panel) a block of these kernels takes, and the most
// panels of one pass.
extern "C" int healnet_flash_wide_max_d() { return kMaxD; }
extern "C" int healnet_flash_wide_max_panels() { return kMaxPanels; }

// Shared memory of the forward (bwd 0) or backward (bwd 1, query chunk
// q_chunk) launch at head dim d in panels x passes; 0 where it does not fit.
extern "C" long long healnet_flash_wide_smem(int d, int is_bf16, int panels, int passes, int bwd,
                                             int q_chunk) {
  Geometry g;
  if (!get_geometry(d, is_bf16, panels, passes, &g) || (bwd && (q_chunk < 1 || q_chunk > kGroup)))
    return 0;
  const Plan pl = bwd ? (is_bf16 ? bwd_plan_of<bf16>(g, q_chunk) : bwd_plan_of<float>(g, q_chunk))
                      : (is_bf16 ? fwd_plan_of<bf16>(g) : fwd_plan_of<float>(g));
  return pl.stages > 0 ? (long long)pl.smem : 0;
}

// Clusters of `cluster` blocks of the forward the card holds at once at head
// dim d in panels x passes (-1 where the query fails or d is out of range).
extern "C" int healnet_flash_wide_fwd_max_clusters(int d, int is_bf16, int cluster, int panels,
                                                   int passes) {
  Geometry g;
  if (!get_geometry(d, is_bf16, panels, passes, &g) || cluster % panels != 0) return -1;
  return is_bf16 ? fwd_max_clusters<bf16>(g, cluster) : fwd_max_clusters<float>(g, cluster);
}

// The most queries a chunk of the backward holds at head dim d in panels x
// passes (0 where d is out of range).
extern "C" int healnet_flash_wide_bwd_max_queries(int d, int is_bf16, int panels, int passes) {
  Geometry g;
  if (!get_geometry(d, is_bf16, panels, passes, &g)) return 0;
  return is_bf16 ? bwd_max_queries<bf16>(g) : bwd_max_queries<float>(g);
}

// Clusters of `cluster` blocks of the backward (query chunk q_chunk) the
// card holds at once.
extern "C" int healnet_flash_wide_bwd_max_clusters(int q_chunk, int d, int is_bf16, int cluster,
                                                   int panels, int passes) {
  Geometry g;
  if (!get_geometry(d, is_bf16, panels, passes, &g) || cluster % panels != 0 || q_chunk < 1 ||
      q_chunk > kGroup)
    return -1;
  return is_bf16 ? bwd_max_clusters<bf16>(g, q_chunk, cluster)
                 : bwd_max_clusters<float>(g, q_chunk, cluster);
}

extern "C" int healnet_flash_wide_forward(
    const void* q, const void* k, const void* v, const float* mask, void* out, float* lse,
    float* scores, int B, int H, int lq, int lkv, int d, int cluster, int keys_per_cta,
    int panels, int passes, long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh, long long v_st,
    long long mask_sb, float scale, int dropout, const void* seed, unsigned int threshold,
    float keep_scale, unsigned int row_offset, int head_stride, int is_bf16, void* stream) {
  if (B * H <= 0 || lq <= 0) return 0;
  Geometry g;
  if (!get_geometry(d, is_bf16, panels, passes, &g) || cluster % panels != 0 ||
      (passes > 1 && scores == nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan pl = is_bf16 ? fwd_plan_of<bf16>(g) : fwd_plan_of<float>(g);
  if (pl.stages == 0) return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.out = out;
  p.lse = lse;
  p.scores = scores;
  p.H = H;
  p.lq = lq;
  p.lkv = lkv;
  p.d = d;
  p.dp = g.dp;
  p.panels = panels;
  p.passes = passes;
  p.units = g.units;
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
  p.seed = static_cast<const uint32_t*>(seed);
  p.threshold = threshold;
  p.keep_scale = keep_scale;
  p.row_offset = row_offset;
  p.head_stride = head_stride;
  const int xp = g.panel_kernels() ? panels : 1;
  p.off = is_bf16 ? offsets(FwdLayout<bf16>(g.dp, pl.stages, pl.alias != 0, xp))
                  : offsets(FwdLayout<float>(g.dp, pl.stages, pl.alias != 0, xp));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool pk = g.panel_kernels();
  cudaError_t e;
  if (is_bf16)
    e = pk ? wide_launch<kWarps>(flash_fwd_wide_tc<true>, p, cluster, B * H, pl.smem, s)
           : wide_launch<kWarps>(flash_fwd_wide_tc<false>, p, cluster, B * H, pl.smem, s);
  else
    e = pk ? wide_launch<kWarps>(flash_fwd_wide_fma<true>, p, cluster, B * H, pl.smem, s)
           : wide_launch<kWarps>(flash_fwd_wide_fma<false>, p, cluster, B * H, pl.smem, s);
  return static_cast<int>(e);
}

extern "C" int healnet_flash_wide_backward(
    const void* q, const void* k, const void* v, const float* mask, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv, float* dkv_acc,
    float* scores, int B, int H, int lq, int lkv, int d, int cluster, int keys_per_cta,
    int q_chunk, int n_chunks, int panels, int passes, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long o_sb, long long o_sh, long long o_st,
    long long mask_sb, float scale, int dropout, const void* seed, unsigned int threshold,
    float keep_scale, unsigned int row_offset, int head_stride, int is_bf16, void* stream) {
  if (B * H <= 0 || lq <= 0) return 0;
  Geometry g;
  if (!get_geometry(d, is_bf16, panels, passes, &g) || cluster % panels != 0 || q_chunk < 1 ||
      q_chunk > kGroup || n_chunks < 1 || (is_bf16 && q_chunk % 16 != 0) ||
      (n_chunks > 1 && dkv_acc == nullptr) || (passes > 1 && scores == nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan pl = is_bf16 ? bwd_plan_of<bf16>(g, q_chunk) : bwd_plan_of<float>(g, q_chunk);
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
  p.scores = scores;
  p.H = H;
  p.lq = lq;
  p.lkv = lkv;
  p.d = d;
  p.dp = g.dp;
  p.panels = panels;
  p.passes = passes;
  p.units = g.units;
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
  p.seed = static_cast<const uint32_t*>(seed);
  p.threshold = threshold;
  p.keep_scale = keep_scale;
  p.row_offset = row_offset;
  p.head_stride = head_stride;
  const int xp = g.panel_kernels() ? panels : 1, rows = is_bf16 ? chunk_rows<bf16>(q_chunk)
                                                              : chunk_rows<float>(q_chunk);
  p.off = is_bf16 ? offsets(BwdLayout<bf16>(g.dp, rows, pl.stages, pl.alias != 0, xp))
                  : offsets(BwdLayout<float>(g.dp, rows, pl.stages, pl.alias != 0, xp));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool pk = g.panel_kernels();
  cudaError_t e;
  if (is_bf16)
    e = pk ? wide_launch<kWarps>(flash_bwd_wide_tc<true>, p, cluster, B * H, pl.smem, s)
           : wide_launch<kWarps>(flash_bwd_wide_tc<false>, p, cluster, B * H, pl.smem, s);
  else
    e = wide_launch<kBwdF32Warps>(bwd_fma_kernel(g), p, cluster, B * H, pl.smem, s);
  return static_cast<int>(e);
}

extern "C" const char* healnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
