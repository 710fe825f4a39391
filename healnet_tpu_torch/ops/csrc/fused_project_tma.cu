// Fused merged-KV projection forward for Hopper: the row statistics, the
// GEMM against the merged folded weights and the folded LayerNorm from one
// pass over the context, on TMA and wgmma.
//
// Replaces: healnet_tpu/ops/fused_project.py::_kernel (the Pallas kernel
// launched by _pallas_call) for bf16 compute, bf16 and int8 contexts: rows
// TMA can describe (a 16-byte aligned base and row pitch: C = 2000, 2048 and
// 1024 in either type) as they are, and rows at any byte offset (C = 4095,
// 2001, 203, 3, a misaligned view: the generic route) as 16-byte hulls that
// the consumers realign (below). f32 compute takes fused_project_f32.cu, and
// generic calls of few rows the split kernel of fused_project.cu; the
// wrapper routes a call by ops/fused_project.py::project_route and
// project_generic_plan.
//
// What it computes (per row r, token tok = r % T), with the rounding
// contract of fused_project.cu and the JAX kernel:
//   s1 = sum_c x + encs[0, tok], s2 = sum_c x^2 + encs[1, tok] (int8: the
//   sums of q and q^2 exact in int32, then s * sum q, (s * s) * sum q^2)
//   mu = s1 / D, inv = rsqrt(s2 / D - mu^2 + eps)
//   low = round(round(acc) [* s, rounded] + encp[tok, n])
//   kv[r, n] = inv * (low - mu * aux[0, n]) + aux[1, n]
//
// Bound on an H100 SXM at the serving shape (8 x 4096 x 2048 bf16, F 252):
// 134 MB of context against 33.8 GFLOP, 46 us of bytes against 34 us of
// bf16 tensor-core time, so bytes bound it and the tensor cores must run at
// three quarters of their peak for the bytes to stay the limit. int8 halves
// the context (67 MB, 20 us): its tensor-core time binds.
//
// Design (each point answers a cause of the time of a plain mma.sync kernel
// that streams 128 rows a block through registers):
// - Persistent, warp-specialised blocks of 288 threads, one per SM: one
//   producer warp issues TMA copies into a ring of 2-4 stages (as many as
//   shared memory holds), each a 128-row x 64-channel context tile and the
//   64-channel slice of the weights for the block's output columns, with
//   mbarrier completion; two consumer warpgroups take 64 rows each.
// - All of F in one block up to 272 columns (one wgmma N-tile of up to 256,
//   or two of 136: brca and trimodal 252 -> 256, kirp 270 -> 272), so each
//   context row leaves HBM once. Wider F takes ceil(F / 272) column passes,
//   each reading the context again. The limit is the register budget: ptxas
//   gives a wgmma kernel of 288 or 384 threads 168 registers a thread (it
//   does not raise the budget for setmaxnreg), 136 of which hold the
//   accumulators at 272 columns; past that it serialises every wgmma.
// - The weights are laid out as k-slices (nk, F, 64), each contiguous, so
//   that a k-step's weight tile is one block of device memory.
// - wgmma m64nNk16 with both operands in shared memory. A bf16 context tile
//   is A as TMA wrote it (128-byte swizzle); the row sums read the same tile
//   while the products run. An int8 tile (64-byte swizzle) is converted by
//   its warpgroup into a bf16 tile (exact for |q| <= 127) in a double buffer,
//   the row sums taken on the way by dp4a, exact in int32. (A fragments in
//   registers would leave too few for the accumulators, and ptxas would
//   serialise the products.) B (the weights) is the ring's weight tile.
// - Each block loads every k-step's weight tile itself, from L2 (about
//   268 MB a call at brca, against 134 MB of context from HBM). Multicasting
//   it over clusters of 2 or 4 blocks cut that traffic 2x or 4x and bought
//   nothing on an H100 SXM (clusters of 4 were 40% slower: each block waits
//   on its peers' releases), so the kernel takes no clusters.
// - Rows at any byte offset (the hull kinds): rows r and r + P lie at the
//   same offset mod 16 bytes, where P = 16 / gcd(row pitch, 16) (8 for a
//   bf16 row of odd C), so the rows of each of the P classes are one
//   2-D TMA tensor whose row stride (P pitches) is a multiple of 16 and
//   whose base is the class's first row rounded down to 16 bytes. A k-step
//   copies, per class, the 16-byte hull of each of its rows of the tile
//   (72 bf16 / 80 int8 elements from channel k0 - shift: 144 or 80 bytes,
//   unswizzled, so 8 consecutive rows of a class fall on 8 distinct bank
//   groups). TMA zero-fills past the class's extent (its shift plus C
//   elements), so the channels at or past C read as zeros, not as the next
//   row's values, and no copy reads past the context. The consumers shift
//   each staged row by its class's offset (funnel shifts of 16-byte words)
//   into the swizzled bf16 tile wgmma reads, the double buffer the int8
//   kind converts into, taking the row sums on the way (int8: converted in
//   the same pass, the sums exact by dp4a). A thread realigns one half of
//   one row, its output chunks in an order rotated per lane so that both
//   the reads and the swizzled writes of a quarter warp fall on 8 distinct
//   bank groups at P = 8; the row sums reach the epilogue's threads through
//   shared memory.
// - Epilogue over 8 rows of a warp at a time, staged in shared memory (in a
//   region of their own, or where that would cost a ring stage, as at kirp,
//   in the tile's second-to-last ring stage, held back from the producer
//   until the epilogue is done) at pitch F (even; F + 1 for an odd F)
//   exactly as they lie in device memory (8 consecutive rows start on 16
//   bytes): their encoding projection is
//   copied into the staged rows asynchronously (the first 8 rows' while the
//   tile's last products run), each thread finishes its accumulators in
//   place over those values (the rounded product, the encoding term, the
//   folded normalisation), and whole rows leave by 16-byte stores. s1 and
//   s2 are written once per row. The producer keeps loading the next tile
//   meanwhile. (Encoding values loaded into registers would leave too few
//   for the accumulators, and loaded where they are used they leave each
//   warp waiting on one L2 round trip after another.)

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

namespace hw = healnet::hopper;

constexpr int kRows = 128;          // context rows per tile
constexpr int kWgRows = 64;         // rows of a consumer warpgroup
constexpr int kBK = 64;             // context channels per k-step
constexpr int kThreads = 288;       // consumer warpgroups 0 and 1, then the producer warp
constexpr int kConsumers = 256;     // consumer threads
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kWRowBytes = kBK * 2;  // one weight row (or bf16 context row) of a k-step
constexpr int kConvBytes = kWgRows * kWRowBytes;  // a warpgroup's converted int8 tile
constexpr int kStageRows = 8;       // rows a warp stages at once in the epilogue
constexpr size_t kMaxSmem = 232448;
constexpr int kMaxClasses = 16;     // row classes of one offset mod 16 bytes (int8, odd C)

// bytes of a row's staged 16-byte hull per k-step: 64 channels and 16 bytes
__host__ __device__ constexpr uint32_t hull_bytes(int itemsize) { return kBK * itemsize + 16; }

struct Params {
  CUtensorMap ctx_map;  // context (M, C): bf16 128-byte swizzle, int8 64-byte swizzle
  CUtensorMap w_map;    // weights (nk, F, 64) bf16, K-major k-slices, 128-byte swizzle
  const __nv_bfloat16* encp;  // (T, F) encoding projection
  const float* encs;          // (2, T) encoding row sums, sums of squares
  const float* aux;           // (2, F) [colsum(W); folded bias]
  const float* scale;         // (M) int8 per-row scales, or null
  __nv_bfloat16* kv;          // (M, F)
  float* s1;                  // (M)
  float* s2;                  // (M)
  int M, F, T, nk, row_tiles, total, stages, box_rows, nbox, pitch, held_staging;
  uint32_t ctx_bytes, stage_bytes, tx_bytes, conv_off, epi_off, aux_off, bar_off;
  float d_total, eps;
  // the hull kinds (appended, so the other kinds see the fields above where
  // they always lay): log2 of the row classes, a class's rows in a tile,
  // bytes of a staged hull row, the first row's offset mod 16 and the
  // pitch's, the row sums' offset, and one unswizzled map per row class
  // in place of ctx_map
  int class_bits, class_rows, hull_bytes, shift0, shift_step;
  uint32_t sums_off;
  CUtensorMap class_maps[kMaxClasses];
};

// Byte offsets into the block's shared memory, from a 1024-byte aligned
// base (the 1024 bytes of slack that alignment may take are in `total`):
// the ring of stages (context tile, 128 hull rows for the hull kinds, then
// the weight rows); for an int8 context and the hull kinds each consumer
// warpgroup's two converted bf16 tiles; for the hull kinds the row sums of
// two tiles; the warps' 8 staged output rows each, unless the epilogue
// stages them in one of the tile's spent ring stages (held); [colsum;
// bias] of the block's columns; then the full and empty barriers.
// ops/fused_project.py (project_smem) mirrors it.
struct Layout {
  uint32_t ctx_bytes, stage_bytes, conv_off, sums_off, epi_off, aux_off, bar_off;
  size_t total;
  Layout(int nb, int itemsize, int stages, int pitch, int held, int hull) {
    ctx_bytes = kRows * (hull ? hull_bytes(itemsize) : kBK * itemsize);
    stage_bytes = ctx_bytes + nb * kWRowBytes;
    conv_off = stages * stage_bytes;
    sums_off = conv_off + (itemsize == 1 || hull ? 2 * 2 * kConvBytes : 0);
    epi_off = sums_off + (hull ? 2 * kRows * 2 * 4 : 0);
    aux_off = epi_off + (held ? 0 : (kConsumerWarps * kStageRows * pitch * 2 + 15) & ~15u);
    bar_off = aux_off + 2 * nb * sizeof(float);
    total = bar_off + 2 * stages * sizeof(uint64_t) + 1024;
  }
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// two f32 rounded to bf16, `lo` at the lower address
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Bytes 2 i and 2 i + 1 (i = 0, 1) of four signed int8 values as a bf16
// pair: each byte, offset by 128, becomes the low mantissa byte of
// 2^23 + u, and 2^23 + 128 is taken off (exact).
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t x, int i) {
  const uint32_t u = x ^ 0x80808080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + 2 * i)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441 + 2 * i)) - 8388736.f;
  return pack_bf16(lo, hi);
}

// Thread (g, t) of a warp owns rows wrow + g and wrow + g + 8 of its
// warpgroup's 64 (h = 0, 1), channels 16 t .. 16 t + 15 of each k-step:
// the row sums of its warp quad cover a row, and a quad shuffle ends them.
//
// bf16: the warpgroup's rows of the TMA tile, 128 bytes each, 16-byte chunk
// c of row r at c ^ (r % 8).
__device__ __forceinline__ void row_sums(const unsigned char* tile, int wrow, int g, int t,
                                         float (&s1)[2], float (&s2)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + g + 8 * h;
#pragma unroll
    for (int c = 2 * t; c < 2 * t + 2; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(tile + r * 128 + ((c ^ (r & 7)) << 4));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lo = __uint_as_float(w[i] << 16), hi = __uint_as_float(w[i] & 0xFFFF0000u);
        s1[h] += lo + hi;
        s2[h] = fmaf(lo, lo, fmaf(hi, hi, s2[h]));
      }
    }
  }
}

// int8: the warpgroup's rows of the TMA tile, 64 bytes each, 16-byte chunk
// c of row r at c ^ ((r / 2) % 4), into the bf16 tile `conv` in the layout
// TMA gives a bf16 tile; the row sums exact by dp4a on the way.
__device__ __forceinline__ void convert_int8(const unsigned char* tile, unsigned char* conv,
                                             int wrow, int g, int t, int (&s1)[2],
                                             int (&s2)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + g + 8 * h;
    const uint4 q = *reinterpret_cast<const uint4*>(tile + r * 64 + ((t ^ ((r >> 1) & 3)) << 4));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s1[h] = __dp4a(static_cast<int>(w[i]), 0x01010101, s1[h]);
      s2[h] = __dp4a(static_cast<int>(w[i]), static_cast<int>(w[i]), s2[h]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // channels 16 t + 8 half .. + 7
      const uint32_t a = w[2 * half], b = w[2 * half + 1];
      const uint4 out = make_uint4(s8x2_to_bf16x2(a, 0), s8x2_to_bf16x2(a, 1),
                                   s8x2_to_bf16x2(b, 0), s8x2_to_bf16x2(b, 1));
      *reinterpret_cast<uint4*>(conv + r * 128 + (((2 * t + half) ^ (r & 7)) << 4)) = out;
    }
  }
}

// ------------------------------------------------- rows at any byte offset

// Where this consumer thread realigns (the hull kinds): one half (32
// channels) of row `row` of its warpgroup's 64. A quarter warp holds 4
// consecutive rows x 2 halves; in step k a thread writes output chunk
// 4 half + (k ^ rot) of its row (rot a permutation of the row's place in the
// quarter with rot ^ place a permutation too), so at P = 8, where the
// quarter's 4 rows share a slot of their class boxes and their row % 8
// bits above 2, its 8 hull reads and 8 swizzled writes each fall on 8
// distinct bank groups.
struct Hull {
  uint32_t off;  // the row's staged hull within a stage's context region
  int row, half, rot, shift;
};

__device__ __forceinline__ Hull hull_slot(const Params& p, int wg, int warp, int lane) {
  const int e = lane & 7;
  Hull h;
  h.row = 4 * ((warp & 3) * 4 + (lane >> 3)) + (e & 3);
  h.half = e >> 2;
  h.rot = (0x2130 >> (4 * (e & 3))) & 3;
  const int r = wg * kWgRows + h.row;  // the tile's row: its class, its slot in the class box
  const int cls = r & ((1 << p.class_bits) - 1), slot = r >> p.class_bits;
  h.off = static_cast<uint32_t>((cls * p.class_rows + slot) * p.hull_bytes);
  h.shift = (p.shift0 + cls * p.shift_step) & 15;
  return h;
}

// bytes s .. s + 15 of the 32 bytes a:b (s < 16)
__device__ __forceinline__ uint4 shift16(const uint4& a, const uint4& b, int s) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const uint32_t bits = (s & 3) * 8;
  uint32_t u[6], v[5];
#pragma unroll
  for (int i = 0; i < 6; ++i) u[i] = (s & 8) ? w[i + 2] : w[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) v[i] = (s & 4) ? u[i + 1] : u[i];
  return make_uint4(__funnelshift_r(v[0], v[1], bits), __funnelshift_r(v[1], v[2], bits),
                    __funnelshift_r(v[2], v[3], bits), __funnelshift_r(v[3], v[4], bits));
}

// bytes s .. s + 7 of the 16 bytes a:b (s < 8)
__device__ __forceinline__ uint2 shift8(const uint2& a, const uint2& b, int s) {
  const uint32_t w[4] = {a.x, a.y, b.x, b.y};
  const uint32_t bits = (s & 3) * 8;
  uint32_t v[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = (s & 4) ? w[i + 1] : w[i];
  return make_uint2(__funnelshift_r(v[0], v[1], bits), __funnelshift_r(v[1], v[2], bits));
}

// One k-step of the thread's half row: its hull `row` (16-byte aligned,
// channel c of the k-step at byte shift + c * itemsize) shifted into the
// bf16 tile `conv` (128-byte swizzle, as TMA lays a bf16 tile), an int8
// row converted on the way (exact for |q| <= 127); the row sums of the
// values as written, f32 for bf16, exact int32 by dp4a for int8.
__device__ __forceinline__ void realign(const unsigned char* row, unsigned char* conv,
                                        const Hull& h, float& s1, float& s2) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = 4 * h.half + (k ^ h.rot);
    const uint4 v = shift16(*reinterpret_cast<const uint4*>(row + 16 * q),
                            *reinterpret_cast<const uint4*>(row + 16 * q + 16), h.shift);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = __uint_as_float(w[i] << 16), hi = __uint_as_float(w[i] & 0xFFFF0000u);
      s1 += lo + hi;
      s2 = fmaf(lo, lo, fmaf(hi, hi, s2));
    }
    *reinterpret_cast<uint4*>(conv + h.row * 128 + ((q ^ (h.row & 7)) << 4)) = v;
  }
}

__device__ __forceinline__ void realign(const unsigned char* row, unsigned char* conv,
                                        const Hull& h, int& s1, int& s2) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = 4 * h.half + (k ^ h.rot);
    const int o = 8 * q + h.shift;  // the chunk's 8 channels, 8 bytes from here
    const unsigned char* src = row + (o & ~7);
    const uint2 x = shift8(*reinterpret_cast<const uint2*>(src),
                           *reinterpret_cast<const uint2*>(src + 8), o & 7);
    s1 = __dp4a(static_cast<int>(x.x), 0x01010101, s1);
    s1 = __dp4a(static_cast<int>(x.y), 0x01010101, s1);
    s2 = __dp4a(static_cast<int>(x.x), static_cast<int>(x.x), s2);
    s2 = __dp4a(static_cast<int>(x.y), static_cast<int>(x.y), s2);
    *reinterpret_cast<uint4*>(conv + h.row * 128 + ((q ^ (h.row & 7)) << 4)) =
        make_uint4(s8x2_to_bf16x2(x.x, 0), s8x2_to_bf16x2(x.x, 1), s8x2_to_bf16x2(x.y, 0),
                   s8x2_to_bf16x2(x.y, 1));
  }
}

// NB columns as one wgmma N-tile, or past 256 as two equal ones (272 = 136
// + 136: a narrow second tile such as n16 runs far below the tensor cores'
// rate)
template <int NB>
struct Accum {
  static constexpr int N1 = NB > 256 ? NB / 2 : NB, N2 = NB - N1;
  float d1[N1 / 2];
  float d2[N2 > 0 ? N2 / 2 : 1];
};

template <int NB>
__device__ __forceinline__ void fence_acc(Accum<NB>& acc) {
  hw::fence_operands(acc.d1);
  if constexpr (Accum<NB>::N2 > 0) hw::fence_operands(acc.d2);
}

// acc += A W over one k-step: the warpgroup's 64 x 64 A tile and the
// block's NB weight rows, both 128-byte-swizzled K-major tiles (one
// committed wgmma group, left in flight).
template <int NB>
__device__ __forceinline__ void mma_step(Accum<NB>& acc, const unsigned char* a,
                                         const unsigned char* w, bool accumulate) {
  constexpr int N1 = Accum<NB>::N1, N2 = Accum<NB>::N2;
  fence_acc(acc);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int keep = accumulate || kk > 0;
    const uint64_t ad = hw::desc_k128(a + kk * 32);
    hw::Wgmma<N1>::mma(acc.d1, ad, hw::desc_k128(w + kk * 32), keep);
    if constexpr (N2 > 0)
      hw::Wgmma<N2>::mma(acc.d2, ad, hw::desc_k128(w + N1 * kWRowBytes + kk * 32), keep);
  }
  hw::wgmma_commit();
  fence_acc(acc);
}

// A position in the ring: the stage, and the parity of its phase.
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The consumers' release of a stage: each warp's lane 0 arrives on the
// stage's empty barrier.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  if (lane == 0) hw::mbar_arrive(empty);
}

__device__ __forceinline__ float normalise(float low, float enc, float mu, float inv,
                                           float colsum, float bias) {
  return inv * (round_bf16(low + enc) - mu * colsum) + bias;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(hw::smem_u32(dst)), "l"(src)
               : "memory");
}

// The encoding projection's values of the pass's columns for the warp's
// rows rbase .. rbase + nr - 1 into its staged rows: copied asynchronously
// in pairs (no registers held while they travel; wait with cp.async.wait_all),
// or loaded one by one where F is odd.
__device__ __forceinline__ void fetch_encoding(const Params& p, __nv_bfloat16* stg, int rbase,
                                               int nr, int col0, int ncols, int lane) {
  for (int r = 0; r < nr; ++r) {
    const __nv_bfloat16* src = p.encp + static_cast<size_t>((rbase + r) % p.T) * p.F + col0;
    __nv_bfloat16* dst = stg + r * p.pitch;
    if ((p.F & 1) == 0) {
      for (int n = 2 * lane; n < ncols; n += 64) cp_async4(dst + n, src + n);
    } else {
      for (int n = lane; n < ncols; n += 32) dst[n] = src[n];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Columns n0 + 8 j + 2 t (+1) of row g (h = 0) or g + 8 (h = 1) of the
// warp, in place in the staged row that holds their encoding values: the
// product rounded to bf16 (int8: widened, times the row's scale, rounded
// again), the encoding term, the folded normalisation.
template <int N, bool Q>
__device__ __forceinline__ void finish_products(const float (&acc)[N / 2], int n0, int h, int t,
                                                __nv_bfloat16* row, const float* aux_s, int nb,
                                                int ncols, float sc, float mu, float inv) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    if (n >= ncols) continue;
    float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
    if (Q) {
      a0 = round_bf16(a0) * sc;
      a1 = round_bf16(a1) * sc;
    }
    const float2 lo = __bfloat1622float2(__floats2bfloat162_rn(a0, a1));
    uint32_t* slot = reinterpret_cast<uint32_t*>(row + n);
    const float2 e = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(slot));
    const float2 cs = *reinterpret_cast<const float2*>(aux_s + n);
    const float2 bs = *reinterpret_cast<const float2*>(aux_s + nb + n);
    *slot = pack_bf16(normalise(lo.x, e.x, mu, inv, cs.x, bs.x),
                      normalise(lo.y, e.y, mu, inv, cs.y, bs.y));
  }
}

// The producer: one thread walks the same tiles as the consumers and keeps
// the ring full. A stage holds the block's context tile (for the hull
// kinds one box of hull rows per row class, class-major) and the pass's NB
// weight rows, in one TMA box or two (272 = 136 + 136).
template <int NB, bool HULL>
__device__ __forceinline__ void produce(const Params& p, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty) {
  RingPos pos;
  for (int ct = blockIdx.x; ct < p.total; ct += gridDim.x) {
    const int col0 = (ct / p.row_tiles) * NB, row_tile = ct % p.row_tiles;
    for (int ks = 0; ks < p.nk; ++ks) {
      hw::mbar_wait(&empty[pos.stage], pos.phase ^ 1);
      unsigned char* st = smem + pos.stage * p.stage_bytes;
      hw::mbar_expect_tx(&full[pos.stage], p.tx_bytes);
      if constexpr (HULL) {
        for (int j = 0; j < (1 << p.class_bits); ++j)
          hw::tma_load(st + j * p.class_rows * p.hull_bytes, &p.class_maps[j], &full[pos.stage],
                       ks * kBK, row_tile * p.class_rows);
      } else {
        hw::tma_load(st, &p.ctx_map, &full[pos.stage], ks * kBK, row_tile * kRows);
      }
      for (int b = 0; b < p.nbox; ++b) {
        const int r = b * p.box_rows;
        hw::tma_load(st + p.ctx_bytes + r * kWRowBytes, &p.w_map, &full[pos.stage], 0, col0 + r,
                     ks);
      }
      pos.next(p.stages);
    }
  }
}

// The consumers: warpgroup wg takes tile rows 64 wg .. 64 wg + 63, warp w
// of it rows 16 w .. 16 w + 15 of those (thread (g, t) rows g and g + 8,
// which is also how the accumulators of wgmma lie). The hull kinds realign
// by another split of the warpgroup's rows (hull_slot) and hand the row
// sums over in shared memory.
template <int NB, bool Q, bool HULL>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int warp, int lane) {
  using Sum = typename std::conditional<Q, int, float>::type;
  constexpr int N1 = Accum<NB>::N1, N2 = Accum<NB>::N2;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wrow = (warp & 3) * 16;  // rows within the warpgroup's 64
  unsigned char* conv_area = smem + p.conv_off + wg * 2 * kConvBytes;
  float* aux_s = reinterpret_cast<float*>(smem + p.aux_off);
  const uint32_t a_off = wg * kWgRows * (Q ? kBK : kWRowBytes);  // the warpgroup's rows in a tile
  const Hull hull = HULL ? hull_slot(p, wg, warp, lane) : Hull{};
  // the hull kinds' row sums [tile parity][row of the tile][s1, s2]: a
  // tile's are written at its last k-step, read after it; the next tile
  // writes the other half, and the one after only once every thread of the
  // warpgroup has passed the next tile's first barrier
  Sum* sums = reinterpret_cast<Sum*>(smem + p.sums_off);
  int aux_col = -1, parity = 0;
  RingPos pos;

  for (int ct = blockIdx.x; ct < p.total; ct += gridDim.x, parity ^= 1) {
    const int col0 = (ct / p.row_tiles) * NB;
    const int row0 = (ct % p.row_tiles) * kRows + wg * kWgRows;
    const int ncols = min(NB, p.F - col0);
    if (col0 != aux_col) {  // [colsum; bias] of the pass's columns
      hw::named_sync(1, kConsumers);  // every consumer warp is done with aux_s
      for (int i = threadIdx.x; i < NB; i += kConsumers) {
        aux_s[i] = i < ncols ? p.aux[col0 + i] : 0.f;
        aux_s[NB + i] = i < ncols ? p.aux[p.F + col0 + i] : 0.f;
      }
      hw::named_sync(1, kConsumers);
      aux_col = col0;
    }

    // a tile's own accumulators: nothing of them lives on through the
    // epilogue into the next tile's products
    Accum<NB> acc;
    Sum s1[2] = {0, 0}, s2[2] = {0, 0};
    int prev = 0, held = -1;
    for (int ks = 0; ks < p.nk; ++ks) {
      hw::mbar_wait(&full[pos.stage], pos.phase);
      const unsigned char* st = smem + pos.stage * p.stage_bytes;
      if constexpr (HULL) {
        // the conversion buffers alternate as for int8 (below)
        unsigned char* conv = conv_area + (ks & 1) * kConvBytes;
        realign(st + hull.off, conv, hull, s1[0], s2[0]);
        if (ks == p.nk - 1) {  // the row's two halves, for the epilogue
          const Sum a = s1[0] + __shfl_xor_sync(0xFFFFFFFFu, s1[0], 4);
          const Sum b = s2[0] + __shfl_xor_sync(0xFFFFFFFFu, s2[0], 4);
          if (hull.half == 0) {
            Sum* dst = sums + 2 * (parity * kRows + wg * kWgRows + hull.row);
            dst[0] = a;
            dst[1] = b;
          }
        }
        hw::fence_proxy_async();
        hw::named_sync(2 + wg, 128);  // the warpgroup's tile is realigned (and its sums out)
        mma_step<NB>(acc, conv, st + p.ctx_bytes, ks > 0);
      } else if constexpr (Q) {
        // the two buffers alternate: this one's last reader, the products
        // of k-step ks - 2, finished at the wait of k-step ks - 1
        unsigned char* conv = conv_area + (ks & 1) * kConvBytes;
        convert_int8(st + a_off, conv, wrow, g, t, s1, s2);
        hw::fence_proxy_async();
        hw::named_sync(2 + wg, 128);  // the warpgroup's tile is converted
        mma_step<NB>(acc, conv, st + p.ctx_bytes, ks > 0);
      } else {
        mma_step<NB>(acc, st + a_off, st + p.ctx_bytes, ks > 0);
        row_sums(st + a_off, wrow, g, t, s1, s2);
      }
      hw::wgmma_wait<1>();  // the last k-step's products are done with its stage
      fence_acc(acc);
      if (ks > 0) {
        if (p.held_staging && ks == p.nk - 1)
          held = prev;  // kept from the producer: the epilogue stages its rows there
        else
          release(&empty[prev], lane);
      }
      prev = pos.stage;
      pos.next(p.stages);
    }
    // The staged output rows, 8 rows x pitch a warp: in their own region, or
    // where that would cost a ring stage, from the start of the tile's
    // second-to-last stage (its last with one k-step), held from the
    // producer until they have left (the host checks that the 8 warps' rows
    // fit in a stage).
    uint32_t stg_off = p.epi_off;
    if (p.held_staging) {
      if (held < 0) {
        hw::wgmma_wait<0>();
        fence_acc(acc);
        held = prev;
      }
      hw::named_sync(1, kConsumers);  // neither warpgroup reads the held stage any more
      stg_off = held * p.stage_bytes;
    }
    __nv_bfloat16* stg =
        reinterpret_cast<__nv_bfloat16*>(smem + stg_off) + warp * kStageRows * p.pitch;
    // the first 8 rows' encoding values travel while the last products run
    const int r0 = row0 + wrow;
    fetch_encoding(p, stg, r0, max(0, min(kStageRows, p.M - r0)), col0, ncols, lane);
    // and the rest of the row statistics' inputs
    float e1[2], e2[2], sc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h, tok = row % p.T;
      e1[h] = p.encs[tok];
      e2[h] = p.encs[p.T + tok];
      sc[h] = Q && row < p.M ? p.scale[row] : 1.f;
    }
    hw::wgmma_wait<0>();
    fence_acc(acc);
    if (!p.held_staging) release(&empty[prev], lane);

    if constexpr (HULL) {  // each row's sums, from the threads that realigned it
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Sum* src = sums + 2 * (parity * kRows + wg * kWgRows + wrow + g + 8 * h);
        s1[h] = t == 0 ? src[0] : Sum(0);
        s2[h] = t == 0 ? src[1] : Sum(0);
      }
    }
    // the row statistics: the quad's partial sums, rescaled, with the encoding's
    float mu[2], inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s1[h] += __shfl_xor_sync(0xFFFFFFFFu, s1[h], 1);
      s1[h] += __shfl_xor_sync(0xFFFFFFFFu, s1[h], 2);
      s2[h] += __shfl_xor_sync(0xFFFFFFFFu, s2[h], 1);
      s2[h] += __shfl_xor_sync(0xFFFFFFFFu, s2[h], 2);
      const int row = r0 + g + 8 * h;
      const float v1 = sc[h] * static_cast<float>(s1[h]) + e1[h];
      const float v2 = sc[h] * sc[h] * static_cast<float>(s2[h]) + e2[h];
      if (row < p.M && col0 == 0 && t == 0) {
        p.s1[row] = v1;
        p.s2[row] = v2;
      }
      mu[h] = v1 / p.d_total;
      inv[h] = rsqrtf(v2 / p.d_total - mu[h] * mu[h] + p.eps);
    }

    // the outputs, 8 rows of the warp at a time (row g + 8 h of the warp in
    // staged row g), finished in place over their encoding values, then
    // written as whole rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rbase = r0 + kStageRows * h;
      const int nr = max(0, min(kStageRows, p.M - rbase));
      if (h == 1) fetch_encoding(p, stg, rbase, nr, col0, ncols, lane);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncwarp();
      __nv_bfloat16* row = stg + g * p.pitch;
      finish_products<N1, Q>(acc.d1, 0, h, t, row, aux_s, NB, ncols, sc[h], mu[h], inv[h]);
      if constexpr (N2 > 0)
        finish_products<N2, Q>(acc.d2, N1, h, t, row, aux_s, NB, ncols, sc[h], mu[h], inv[h]);
      __syncwarp();
      if (p.pitch == p.F) {  // the rows are contiguous, and start on 16 bytes
        const int n = nr * p.F, n16 = n / 8;
        __nv_bfloat16* out = p.kv + static_cast<size_t>(rbase) * p.F;
        for (int i = lane; i < n16; i += 32)
          reinterpret_cast<uint4*>(out)[i] = reinterpret_cast<const uint4*>(stg)[i];
        for (int i = n16 * 8 + lane; i < n; i += 32) out[i] = stg[i];
      } else {
        for (int r = 0; r < nr; ++r)
          for (int n = lane; n < ncols; n += 32)
            p.kv[static_cast<size_t>(rbase + r) * p.F + col0 + n] = stg[r * p.pitch + n];
      }
      __syncwarp();
    }
    if (p.held_staging) {
      release(&empty[held], lane);
      if (held != prev) release(&empty[prev], lane);
    }
  }
}

template <int NB, bool Q, bool HULL>
__global__ void __launch_bounds__(kThreads, 1) project_tma(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hw::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + p.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], kConsumerWarps);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();  // the barriers are set before any arrival or copy
  if (warp == kConsumerWarps) {
    if (lane == 0) produce<NB, HULL>(p, smem, full, empty);
    __syncwarp();
  } else {
    consume<NB, Q, HULL>(p, smem, full, empty, warp, lane);
  }
}

// --------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, reached through the runtime so that
// the library links against nothing but cudart.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A map of `rank` (2 or 3) dimensions, the innermost first, with the byte
// strides of the outer ones; boxes of `box`, zero-filled out of bounds.
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
            CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lets `kern` take all of a block's shared memory; once per kernel and
// device (a small table: ten kernels per device).
template <typename Kernel>
cudaError_t configure(Kernel kern) {
  struct Entry {
    const void* kern;
    int dev;
  };
  static Entry done[64];
  static int n = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* key = reinterpret_cast<const void*>(kern);
  for (int i = 0; i < n; ++i)
    if (done[i].kern == key && done[i].dev == dev) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (e == cudaSuccess && n < 64) done[n++] = {key, dev};
  return e;
}

// Calls fn(kernel) for a column-pass width the kernel is built for (the
// wrapper's PROJECT_WIDTHS); a null kernel for any other.
template <bool Q, bool HULL, typename Fn>
auto with_width(int nb, Fn&& fn) {
  switch (nb) {
    case 64: return fn(project_tma<64, Q, HULL>);
    case 128: return fn(project_tma<128, Q, HULL>);
    case 256: return fn(project_tma<256, Q, HULL>);
    case 272: return fn(project_tma<272, Q, HULL>);
    default: return fn(static_cast<void (*)(Params)>(nullptr));
  }
}

template <typename Fn>
auto with_kernel(int nb, int is_int8, int hull, Fn&& fn) {
  if (hull) return is_int8 ? with_width<true, true>(nb, fn) : with_width<false, true>(nb, fn);
  return is_int8 ? with_width<true, false>(nb, fn) : with_width<false, false>(nb, fn);
}

int gcd16(long long x) {
  int g = 16;
  while (x % g != 0) g /= 2;
  return g;
}

// The context's maps. Rows TMA can describe: one map of (M, C), boxes of
// 128 rows x 64 channels, swizzled. Rows at any byte offset (hull): the P
// classes of rows at one offset mod 16 bytes, P = 16 / gcd(pitch, 16), row
// r in class r % P at its row r / P; class j's map starts at its first
// row rounded down to 16 bytes, `shift` elements before channel 0, spans
// shift + C elements (zeros past them) and P pitches a row; boxes of
// 128 / P rows x (64 + 16 / itemsize) elements, unswizzled.
bool encode_context(Params& p, const void* dat, int M, int C, int itemsize, int hull) {
  const CUtensorMapDataType type =
      itemsize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long pitch = static_cast<long long>(C) * itemsize;
  p.class_bits = p.class_rows = p.hull_bytes = p.shift0 = p.shift_step = 0;
  if (!hull) {
    const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)pitch};
    const cuuint32_t box[2] = {kBK, kRows};
    return encode(&p.ctx_map, type, dat, 2, dims, strides, box,
                  itemsize == 1 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  }
  const int classes = 16 / gcd16(pitch);
  if (M < classes) return false;  // every class has a row
  while ((1 << p.class_bits) < classes) ++p.class_bits;
  p.class_rows = kRows / classes;
  p.hull_bytes = static_cast<int>(hull_bytes(itemsize));
  const uintptr_t base = reinterpret_cast<uintptr_t>(dat);
  p.shift0 = static_cast<int>(base & 15);
  p.shift_step = static_cast<int>(pitch & 15);
  for (int j = 0; j < classes; ++j) {
    const uintptr_t first = base + static_cast<uintptr_t>(j * pitch);
    const int shift = static_cast<int>(first & 15) / itemsize;
    const cuuint64_t dims[2] = {(cuuint64_t)(shift + C), (cuuint64_t)((M - j + classes - 1) / classes)};
    const cuuint64_t strides[1] = {(cuuint64_t)(classes * pitch)};
    const cuuint32_t box[2] = {(cuuint32_t)(p.hull_bytes / itemsize), (cuuint32_t)p.class_rows};
    if (!encode(&p.class_maps[j], type, reinterpret_cast<const void*>(first & ~uintptr_t(15)), 2,
                dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
      return false;
  }
  return true;
}

}  // namespace

// Blocks (with `smem` bytes each) of the kernel for column width nb that the
// current device holds at once; -1 where the query fails.
extern "C" int healnet_fused_project_tma_max_blocks(int nb, int is_int8, int hull,
                                                     long long smem) {
  return with_kernel(nb, is_int8, hull, [&](auto kern) -> int {
    int per_sm = 0, dev = 0, sms = 0;
    if (kern == nullptr || configure(kern) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, (size_t)smem) !=
            cudaSuccess ||
        cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      cudaGetLastError();
      return -1;
    }
    return per_sm * sms;
  });
}

// Bytes of dynamic shared memory a block takes under a plan (Layout), for
// the host's check of ops/fused_project.py::project_smem.
extern "C" long long healnet_fused_project_tma_smem(int nb, int itemsize, int stages, int pitch,
                                                     int held_staging, int hull) {
  return static_cast<long long>(Layout(nb, itemsize, stages, pitch, held_staging, hull).total);
}

// One launch over (M, C) context rows: dat bf16 or int8 (is_int8, with
// `scale`), rows TMA can describe or (hull) at any byte offset, w_t
// (nk, F, 64) bf16: the weights' k-slices of 64 channels (zero past C),
// each K-major, so that a slice is one contiguous block; output (M, F)
// bf16 and s1, s2 (M) f32; n_blocks persistent blocks. The plan (nb,
// n_col, stages, pitch, held_staging) is ops/fused_project.py::project_plan's.
extern "C" int healnet_fused_project_tma(
    const void* dat, const void* w_t, const void* encp, const float* encs, const float* aux,
    const float* scale, void* kv, float* s1, float* s2, int M, int C, int F, int T,
    float d_total, float eps, int is_int8, int nb, int n_col, int n_blocks, int stages,
    int pitch, int held_staging, int hull, void* stream) {
  if (M <= 0 || F <= 0) return 0;
  const int itemsize = is_int8 ? 1 : 2;
  const Layout L(nb, itemsize, stages, pitch, held_staging, hull);
  // a TMA box takes at most 256 rows: 272 columns load as two of 136
  const int box_rows = nb > 256 ? nb / 2 : nb;
  if (stages < 2 || pitch % 2 != 0 || pitch < (n_col == 1 ? F : nb) ||
      kConsumerWarps * kStageRows * pitch * 2 > (int)L.stage_bytes || L.total > kMaxSmem ||
      n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  const int nk = (C + kBK - 1) / kBK;
  const cuuint64_t w_dims[3] = {kBK, (cuuint64_t)F, (cuuint64_t)nk};
  const cuuint64_t w_strides[2] = {kWRowBytes, (cuuint64_t)F * kWRowBytes};
  const cuuint32_t w_box[3] = {kBK, (cuuint32_t)box_rows, 1};
  if (!encode_context(p, dat, M, C, itemsize, hull) ||
      !encode(&p.w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w_t, 3, w_dims, w_strides, w_box,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  p.encp = static_cast<const __nv_bfloat16*>(encp);
  p.encs = encs;
  p.aux = aux;
  p.scale = is_int8 ? scale : nullptr;
  p.kv = static_cast<__nv_bfloat16*>(kv);
  p.s1 = s1;
  p.s2 = s2;
  p.M = M;
  p.F = F;
  p.T = T;
  p.nk = nk;
  p.row_tiles = (M + kRows - 1) / kRows;
  p.total = p.row_tiles * n_col;
  p.stages = stages;
  p.box_rows = box_rows;
  p.nbox = nb / box_rows;
  p.pitch = pitch;
  p.held_staging = held_staging != 0;
  p.ctx_bytes = L.ctx_bytes;
  p.stage_bytes = L.stage_bytes;
  p.tx_bytes = L.stage_bytes;
  p.conv_off = L.conv_off;
  p.sums_off = L.sums_off;
  p.epi_off = L.epi_off;
  p.aux_off = L.aux_off;
  p.bar_off = L.bar_off;
  p.d_total = d_total;
  p.eps = eps;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return static_cast<int>(with_kernel(nb, is_int8, hull, [&](auto kern) -> cudaError_t {
    if (kern == nullptr) return cudaErrorInvalidValue;
    cudaError_t e = configure(kern);
    if (e != cudaSuccess) return e;
    kern<<<n_blocks, kThreads, L.total, s>>>(p);
    return cudaGetLastError();
  }));
}

extern "C" const char* healnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
