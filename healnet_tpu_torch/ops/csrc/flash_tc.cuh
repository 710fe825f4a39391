// Building blocks of the flash kernels (flash_attention.cu and
// flash_attention_bwd.cu). For the tensor-core variants (bf16, head dims up
// to 128): bf16 mma.sync m16n8k16 with f32 accumulators, ldmatrix fragment
// loads, a cp.async ring that stages 64-key tiles of K, V and the key mask.
// For both variants: the thread-block cluster launch and distributed
// shared memory stores. For the FMA variants (f32, and bf16 heads wider
// than 128): namespace fmav at the end of the file.
//
// K and V are column slices of the merged KV buffer: rows of d bf16 values
// at any 2-byte-aligned address with any row stride (brca: pitch 252, V at
// element offset 63; kirp: pitch 270, offsets at multiples of 27; odd
// pitches in self-attention). TMA cannot take them, and a 16-byte copy of
// the row itself would be misaligned. A stage copies each row as the
// 16-byte chunks that cover it (its 16-byte-aligned hull: up to 7 elements
// before and after the row, inside chunks that hold part of it, so inside
// its page), and unpack_tile shifts each row by its offset in the hull
// into a 16-byte-aligned, zero-padded bf16 tile that ldmatrix reads.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace healnet {
namespace tc {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kKeyTile = 64;   // keys per tile; each warp owns 16 of them
constexpr int kQGroup = 32;    // queries per pass: two m16 tiles
constexpr int kMaxStages = 4;
constexpr int kMaxCluster = 16;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use
// a block small enough for two on an SM (228 KB, 1 KB reserved per block)
constexpr size_t kHalfSmem = 113 * 1024;
constexpr float kNegBig = -1e30f;

template <int DP>
struct Dims {
  // row pitch (bf16) of an aligned tile: the 8 rows an ldmatrix reads land
  // on distinct banks, and every row starts on 16 bytes
  static constexpr int kPitch = DP + 8;
  // row pitch (f32) of a block's accumulator tile in shared memory: the
  // float2 of an m16n8 fragment's 8 rows (16 threads) land on distinct banks
  static constexpr int kAccPitch = DP + 8;
  static constexpr int kHullChunks = DP / 8 + 1;  // staged 16-byte chunks per row
  static constexpr int kHullWords = 4 * kHullChunks;
  static constexpr int kStageWords = 2 * kKeyTile * kHullWords + kKeyTile;  // K, V, mask
};

static_assert(kThreads == 4 * kKeyTile, "two threads unpack one K or V row");

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0..3) of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n >= 3) {
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  } else if (n == 2) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16 operands, f32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): c[0..1] row g, columns 2t, 2t+1;
// c[2..3] row g + 8; a[0] (row g, k 2t..), a[1] (row g+8), a[2] (row g,
// k 2t+8..), a[3] (row g+8, k 2t+8..); b0 (k 2t.., column g), b1 (k 2t+8..)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Store v at `p`'s place (an address in this block's shared memory) in the
// shared memory of block `rank` of the cluster (distributed shared memory).
// It is visible there after the next cluster barrier.
__device__ __forceinline__ void st_cluster(float* p, int rank, float v) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}

// Order this thread's writes to shared memory before the reads of a bulk
// copy (the async proxy) issued after the next barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One bulk asynchronous copy of `bytes` (a multiple of 16) from shared
// memory to device memory, both 16-byte aligned, in this thread's current
// bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until this thread's bulk copies have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wait until this thread's bulk copies are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// two f32 rounded to bf16, `lo` at the lower address
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ const __nv_bfloat16* kv_row(const __nv_bfloat16* k, long long k_st,
                                                       const __nv_bfloat16* v, long long v_st,
                                                       int which, int key) {
  return which ? v + key * v_st : k + key * k_st;
}

// Issue the copies of keys [k0, min(k0 + 64, kv_end)) of K and V and of
// their mask values into one ring stage. Stage row r is K (r < 64) or V
// of key k0 + r % 64, copied as the 16-byte chunks that cover it (its
// 16-byte-aligned hull; a chunk that holds one byte of the row lies in the
// row's page, so the hull never faults). Consecutive threads take
// consecutive chunks of a row, so the copies of one warp touch three or
// four rows, not 32.
template <int DP>
__device__ __forceinline__ void stage_tile(uint32_t* st, const __nv_bfloat16* k, long long k_st,
                                           const __nv_bfloat16* v, long long v_st,
                                           const float* mask, int k0, int kv_end, int d,
                                           int tid) {
  constexpr int HC = Dims<DP>::kHullChunks, HW = Dims<DP>::kHullWords;
  constexpr int N = 2 * kKeyTile * HC;
#pragma unroll
  for (int n = 0; n < (N + kThreads - 1) / kThreads; ++n) {
    const int i = tid + n * kThreads, r = i / HC, c = i - r * HC;
    const int key = k0 + r % kKeyTile;
    if (i < N && key < kv_end) {
      const uintptr_t row =
          reinterpret_cast<uintptr_t>(kv_row(k, k_st, v, v_st, r / kKeyTile, key));
      if (c < (int)(((row >> 1) & 7) + d + 7) >> 3)  // a chunk holding part of the row
        cp_async16(st + r * HW + 4 * c,
                   reinterpret_cast<const char*>(row & ~uintptr_t(15)) + 16 * c);
    }
  }
  if (mask != nullptr && tid < kKeyTile && k0 + tid < kv_end)
    cp_async4(st + 2 * kKeyTile * HW + tid, mask + k0 + tid);
}

// Unpack a landed stage into the aligned tiles ks, vs (64 x kPitch bf16)
// and the tile's mask mk (64 floats). Threads tid and tid + 128 take row
// tid % 128 of the stage, every other 16-byte chunk each. Output chunk c
// of a row is its hull's bytes [2 s + 16 c, 2 s + 16 c + 16), s (0-7) the
// row's offset in its hull: two aligned 16-byte reads of hull chunks c and
// c + 1, words picked by s / 2, halves by s % 2. Consecutive rows lie an
// odd number of 16-byte slots apart (DP / 8 + 1), so the 16-byte reads and
// writes of a quarter warp fall on distinct banks. Keys at or past kv_end, and
// columns d..DP-1, are zero; so is their mask.
template <int DP>
__device__ __forceinline__ void unpack_tile(const uint32_t* st, __nv_bfloat16* ks,
                                            __nv_bfloat16* vs, float* mk,
                                            const __nv_bfloat16* k, long long k_st,
                                            const __nv_bfloat16* v, long long v_st,
                                            bool has_mask, int k0, int kv_end, int d, int tid) {
  constexpr int HW = Dims<DP>::kHullWords, P = Dims<DP>::kPitch;
  const int r = tid % (2 * kKeyTile), part = tid / (2 * kKeyTile);
  const int which = r / kKeyTile, j = r % kKeyTile, key = k0 + j;
  uint4* out = reinterpret_cast<uint4*>((which ? vs : ks) + j * P);
  const uint4* hull = reinterpret_cast<const uint4*>(st + r * HW);
  int shift = 0;
  if (key < kv_end)
    shift = (int)((reinterpret_cast<uintptr_t>(kv_row(k, k_st, v, v_st, which, key)) >> 1) & 7);
  const bool two = shift & 4, one = shift & 2, odd = shift & 1;
#pragma unroll
  for (int c0 = 0; c0 < DP / 8; c0 += 2) {
    const int c = c0 + part;
    if (c < DP / 8) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (key < kv_end) {
        const uint4 a = hull[c], b = hull[c + 1];
        const uint32_t win[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        uint32_t sel[5];  // hull words shift / 2 + e of the window
#pragma unroll
        for (int e = 0; e < 5; ++e) {
          const uint32_t lo = two ? win[e + 2] : win[e];
          const uint32_t hi = two ? win[e + 3] : win[e + 1];
          sel[e] = one ? hi : lo;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * c + e;  // output elements 2i, 2i + 1
          const uint32_t val = odd ? __byte_perm(sel[e], sel[e + 1], 0x5432) : sel[e];
          w[e] = 2 * i + 1 < d ? val : 2 * i < d ? (val & 0xFFFFu) : 0u;
        }
      }
      out[c] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  if (tid < kKeyTile) {
    const int kt = k0 + tid;
    mk[tid] = kt >= kv_end ? 0.f
              : has_mask   ? __uint_as_float(st[2 * kKeyTile * HW + tid])
                           : 1.f;
  }
}

// The number of ring stages (4 at most, 2 at least) for a block whose
// shared memory is layout(stages) bytes: as many as leave room for two
// blocks on an SM, else as many as fit.
template <typename Layout>
int pick_stages(Layout layout) {
  for (int s = kMaxStages; s >= 2; --s)
    if (layout(s) <= kHalfSmem) return s;
  for (int s = kMaxStages; s > 2; --s)
    if (layout(s) <= kMaxSmem) return s;
  return 2;
}

// Rows [r0, r0 + 32) of a strided (rows x d) bf16 matrix into a tile of 32
// rows (pitch kPitch); rows at or past `rows` and columns d..DP-1 are zero.
// Every load of a thread is issued before the first store.
template <int DP>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long st, int r0, int rows, int d, int tid) {
  constexpr int N = kQGroup * DP / kThreads;
  __nv_bfloat16 val[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = tid + n * kThreads, r = i / DP, c = i % DP;
    val[n] = (r0 + r < rows && c < d) ? src[(r0 + r) * st + c] : __float2bfloat16(0.f);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = tid + n * kThreads;
    dst[(i / DP) * Dims<DP>::kPitch + i % DP] = val[n];
  }
}

// n contiguous bf16 values from shared memory (src, 16-byte aligned) to
// device memory (dst, 2-byte aligned), consecutive threads on consecutive
// addresses: 16-byte stores where dst is 16-byte aligned, 4-byte stores
// where it is 4-byte aligned, else 2-byte stores.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int n,
                                           int tid) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  int done = 0;
  if ((a & 15) == 0) {
    for (int i = tid; i < n / 8; i += kThreads)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    done = n / 8 * 8;
  } else if ((a & 3) == 0) {
    for (int i = tid; i < n / 2; i += kThreads)
      reinterpret_cast<uint32_t*>(dst)[i] = reinterpret_cast<const uint32_t*>(src)[i];
    done = n / 2 * 2;
  }
  for (int i = done + tid; i < n; i += kThreads) dst[i] = src[i];
}

// Calls fn(std::integral_constant<int, DP>) with d padded to a multiple of
// 16 (d <= 128).
template <typename Fn>
auto with_dp(int d, Fn&& fn) {
  switch ((d + 15) / 16) {
    case 1: return fn(std::integral_constant<int, 16>{});
    case 2: return fn(std::integral_constant<int, 32>{});
    case 3: return fn(std::integral_constant<int, 48>{});
    case 4: return fn(std::integral_constant<int, 64>{});
    case 5: return fn(std::integral_constant<int, 80>{});
    case 6: return fn(std::integral_constant<int, 96>{});
    case 7: return fn(std::integral_constant<int, 112>{});
    default: return fn(std::integral_constant<int, 128>{});
  }
}

// Whether `kern` is configured on device `dev` (a small table; one entry
// per kernel instantiation and device).
inline bool& configured(const void* kern, int dev) {
  struct Entry {
    const void* kern;
    int dev;
    bool done;
  };
  static Entry table[256];
  static int n = 0;
  for (int i = 0; i < n; ++i)
    if (table[i].kern == kern && table[i].dev == dev) return table[i].done;
  static bool spare;
  if (n == 256) return spare = false;
  table[n] = {kern, dev, false};
  return table[n++].done;
}

// Lets `kern` take all of a block's shared memory and clusters of 16; once
// per kernel and device.
template <typename Kernel>
cudaError_t configure(Kernel kern) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  bool& done = configured(reinterpret_cast<const void*>(kern), dev);
  if (done) return cudaSuccess;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e == cudaSuccess)  // what static shared memory leaves
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(kMaxSmem - attr.sharedSizeBytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = e == cudaSuccess;
  return e;
}

template <typename Kernel>
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int cluster, int rows, size_t smem,
                                  cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, rows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `cluster` blocks of `kern` (with `smem` bytes each) that the
// card holds at once; -1 where the query fails (its error is cleared).
template <typename Kernel>
int max_active_clusters(Kernel kern, int cluster, size_t smem) {
  if (configure(kern) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config<Kernel>(attr, cluster, 1, smem, nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)kern, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}

// One launch: grid (cluster, rows), one cluster of `cluster` blocks per row.
template <typename Kernel, typename Params>
cudaError_t launch_clustered(Kernel kern, const Params& p, int cluster, int rows, size_t smem,
                             cudaStream_t s) {
  cudaError_t e = configure(kern);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config<Kernel>(attr, cluster, rows, smem, s);
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ------------------------------------------- the FMA kernels' pieces (f32)
//
// The FMA variants (f32, and bf16 heads wider than 128) compute in full f32
// on the CUDA cores. A head of d channels is padded to DP, a multiple of 32
// (at most 256); keys come in tiles of 32. An f32 slice with DP <= 128 is
// staged by a cp.async ring as the 16-byte chunks that cover each row (its
// hull, as stage_tile does for bf16: brca's V at element 63 and kirp's
// pitch 270 leave rows at 4-byte offsets that no 16-byte copy of the row
// itself can take), and the next tile is shifted out of its hull into an
// aligned f32 tile (pitch DP + 4: float4 reads of 8 consecutive rows fall
// on distinct banks, columns d..DP-1 zero) while this one is computed:
// aligned tiles are double-buffered, so one block barrier a tile serves
// the ring and both buffers. bf16 rows and wider f32 heads are loaded,
// converted and stored into the aligned tile by the threads, with no ring.
// Query rows are owned by warps: row r of a group of kGroup queries by warp
// r % 8, in its slot r / 8; the lanes split a tile's keys for the scores
// and the head dim for the products with a tile (P V, dS K).
namespace fmav {

constexpr int kSlots = 4;                // query rows a warp owns at most
constexpr int kGroup = kWarps * kSlots;  // queries a block holds at once
constexpr int kMaxD = 256;
constexpr int kKeys = 32;                // keys per tile, one a lane

template <typename T, int DP>
struct Shape {
  static_assert(DP % 32 == 0 && DP <= kMaxD, "DP: a multiple of 32, at most 256");
  // whether the slice is staged by the cp.async ring (else loaded by the threads)
  static constexpr bool kRing = std::is_same<T, float>::value && DP <= 128;
  static constexpr int kPitch = DP + 4;    // an aligned row; a hull row has DP / 4 + 1 chunks
  static constexpr int kChPerLane = DP / 32;  // a lane's channels of a row
  static constexpr int kTileFloats = 2 * kKeys * kPitch + kKeys;  // K, V, mask
};
static_assert(kKeys == 4 * kWarps, "the backward's dk/dv products take four keys a warp");

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

// N consecutive floats from shared memory at p, as wide as its alignment
// allows (16 bytes where N % 4 == 0, 8 where N % 2 == 0)
template <int N>
__device__ __forceinline__ void ld_floats(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      x[i] = t.x, x[i + 1] = t.y, x[i + 2] = t.z, x[i + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + i);
      x[i] = t.x, x[i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T>
__device__ __forceinline__ const T* kv_row_of(const T* k, long long k_st, const T* v,
                                              long long v_st, int r, int key) {
  return r < kKeys ? k + key * k_st : v + key * v_st;
}

// A thread's share of the ring's copies and of the unpacking, the same for
// every tile of a block: its tiles start a multiple of 32 keys apart, and
// 32 rows of any f32 slice move a row's 16-byte phase by a multiple of 16
// bytes. Ring row r is K (r < 32) or V of key k0 + r % 32, copied as the
// 16-byte chunks that hold part of it (its hull: a chunk that holds one
// byte of the row lies in the row's page, so the hull never faults);
// consecutive threads take consecutive chunks of a row.
template <typename T, int DP>
struct RingCopies {
  static constexpr int HC = DP / 4 + 1, P = Shape<T, DP>::kPitch, N = 2 * kKeys * HC;
  static constexpr int NP = (N + kThreads - 1) / kThreads;
  int off[NP];     // the chunk's byte offset from the start of its tile's first row
  int packed[NP];  // -1, or the ring float offset | row key << 16 | V << 21
  int shift;       // the 4-byte phase of the row this thread unpacks (row tid % 64)

  __device__ RingCopies(const T* k, long long k_st, const T* v, long long v_st, int kv_begin,
                        int d, int tid) {
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const int i = tid + n * kThreads, r = i / HC, c = i - r * HC, j = r % kKeys;
      const long long st = r < kKeys ? k_st : v_st;
      const uintptr_t base =
          reinterpret_cast<uintptr_t>(r < kKeys ? (const void*)k : (const void*)v) +
          st * 4 * kv_begin;
      const uintptr_t row = base + st * 4 * j;
      off[n] = (int)((long long)(row & ~uintptr_t(15)) + 16 * c - (long long)base);
      const bool part = i < N && c < (int)(((row >> 2) & 3) + d + 3) >> 2;
      packed[n] = part ? (r * P + 4 * c) | (j << 16) | ((r >= kKeys) << 21) : -1;
    }
    const int r = tid % (2 * kKeys);
    shift = (int)(((reinterpret_cast<uintptr_t>(r < kKeys ? (const void*)k : (const void*)v)) +
                   (r < kKeys ? k_st : v_st) * 4 * (kv_begin + r % kKeys)) >> 2 & 3);
  }

  // Issue the copies of the tile of keys k0 onwards (a multiple of 32 past
  // the block's first key; those at or past kv_end left out) and of its
  // mask values into ring stage raw.
  __device__ __forceinline__ void issue(float* raw, const T* k, long long k_st, const T* v,
                                        long long v_st, const float* mask, int k0, int kv_end,
                                        int tid) const {
    const char* kb = reinterpret_cast<const char*>(k) + k_st * 4 * k0;
    const char* vb = reinterpret_cast<const char*>(v) + v_st * 4 * k0;
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const int q = packed[n];
      if (q >= 0 && k0 + ((q >> 16) & 31) < kv_end)
        cp_async16(raw + (q & 0xFFFF), ((q >> 21) ? vb : kb) + off[n]);
    }
    if (mask != nullptr && tid < kKeys && k0 + tid < kv_end)
      cp_async4(raw + 2 * kKeys * P + tid, mask + k0 + tid);
  }
};

// Fill the aligned tile `tile` with keys [k0, k0 + 32): K rows, V rows at
// tile + 32 * kPitch, the mask after them (1 without a mask, 0 past
// kv_end). Ring: each row shifted out of its landed hull in `raw` by its
// phase (four threads a row, a float4 each step); columns d..DP-1 and keys
// past kv_end are zero. Otherwise loaded, converted and stored by the
// threads.
template <typename T, int DP>
__device__ __forceinline__ void unpack(float* tile, const float* raw, int shift, const T* k,
                                       long long k_st, const T* v, long long v_st,
                                       const float* mask, int k0, int kv_end, int d, int tid) {
  using S = Shape<T, DP>;
  constexpr int P = S::kPitch;
  if constexpr (S::kRing) {
    const int r = tid % (2 * kKeys), part = tid / (2 * kKeys), s = shift;
    const bool ok = k0 + r % kKeys < kv_end;
    const float4* hull = reinterpret_cast<const float4*>(raw + r * P);
    float4* out = reinterpret_cast<float4*>(tile + r * P);
#pragma unroll
    for (int c = part; c < DP / 4; c += kThreads / (2 * kKeys)) {
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) {
        const float4 a = hull[c], b = hull[c + 1];
        o.x = s == 0 ? a.x : s == 1 ? a.y : s == 2 ? a.z : a.w;
        o.y = s == 0 ? a.y : s == 1 ? a.z : s == 2 ? a.w : b.x;
        o.z = s == 0 ? a.z : s == 1 ? a.w : s == 2 ? b.x : b.y;
        o.w = s == 0 ? a.w : s == 1 ? b.x : s == 2 ? b.y : b.z;
        if (4 * c + 3 >= d) {
          o.x = 4 * c < d ? o.x : 0.f;
          o.y = 4 * c + 1 < d ? o.y : 0.f;
          o.z = 4 * c + 2 < d ? o.z : 0.f;
          o.w = 0.f;
        }
      }
      out[c] = o;
    }
    if (tid < kKeys) {
      const int kt = k0 + tid;
      tile[2 * kKeys * P + tid] = kt >= kv_end     ? 0.f
                                  : mask != nullptr ? raw[2 * kKeys * P + tid]
                                                    : 1.f;
    }
  } else {
    const int lane = tid & 31, warp = tid >> 5;
    for (int r = warp; r < 2 * kKeys; r += kWarps) {
      const int key = k0 + r % kKeys;
      const T* src = kv_row_of(k, k_st, v, v_st, r, key);
#pragma unroll
      for (int c = lane; c < DP; c += 32)
        tile[r * P + c] = (key < kv_end && c < d) ? to_float(src[c]) : 0.f;
    }
    if (tid < kKeys) {
      const int kt = k0 + tid;
      tile[2 * kKeys * P + tid] = kt >= kv_end ? 0.f : mask != nullptr ? mask[kt] : 1.f;
    }
  }
}

// The warp's dot products with a tile: for matrix m (NM of them) and slot
// s, out[m][s] = a_m[warp + 8 s] . b_m[lane] over the DP padded channels,
// rows of both at pitch kPitch. a_m rows are read as broadcast float4s,
// the lane's b_m row as one float4 (distinct banks).
template <int DP, int NS, int NM>
__device__ __forceinline__ void tile_dots(float (&out)[NM][NS], const float* a0, const float* a1,
                                          const float* b0, const float* b1, int warp, int lane) {
  constexpr int P = DP + 4;
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int s = 0; s < NS; ++s) out[m][s] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const float* a = m ? a1 : a0;
      const float4 bv = *reinterpret_cast<const float4*>((m ? b1 : b0) + lane * P + c);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float4 av = *reinterpret_cast<const float4*>(a + (warp + kWarps * s) * P + c);
        float x = out[m][s];
        x = fmaf(av.x, bv.x, x);
        x = fmaf(av.y, bv.y, x);
        x = fmaf(av.z, bv.z, x);
        x = fmaf(av.w, bv.w, x);
        out[m][s] = x;
      }
    }
  }
}

// acc[s][i] += sum_j w[s][j] tile[j][lane * DP / 32 + i] over a tile's
// keys: slot s's weights at w + s * w_stride (read as broadcast float4s),
// the lane's channels of a tile row as one vector load.
template <int DP, int NS>
__device__ __forceinline__ void tile_axpy(float (&acc)[NS][DP / 32], const float* w, int w_stride,
                                          const float* tile, int lane) {
  constexpr int P = DP + 4, CPL = DP / 32;
#pragma unroll 2
  for (int j = 0; j < kKeys; j += 4) {
    float4 wv[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) wv[s] = *reinterpret_cast<const float4*>(w + s * w_stride + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float t[CPL];
      ld_floats<CPL>(t, tile + (j + jj) * P + lane * CPL);
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int i = 0; i < CPL; ++i) acc[s][i] = fmaf(at(wv[s], jj), t[i], acc[s][i]);
    }
  }
}

// Rows [r0, r0 + rows) of a strided (n x d) matrix as f32 rows at pitch
// DP + 4; rows at or past n, and columns d..DP-1, are zero.
template <int DP, typename T>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* src, long long st, int r0,
                                              int rows, int n, int d, int tid) {
  for (int i = tid; i < rows * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    dst[r * (DP + 4) + c] = (r0 + r < n && c < d) ? to_float(src[(r0 + r) * st + c]) : 0.f;
  }
}

// The slots of warp `warp` among n query rows (row r in warp r % 8).
__device__ __forceinline__ int slots_of(int warp, int n) {
  return warp < n ? (n - 1 - warp) / kWarps + 1 : 0;
}

// Calls fn(std::integral_constant<int, DP>) with d padded to a multiple of
// 32 (d <= 256).
template <typename Fn>
auto with_dp32(int d, Fn&& fn) {
  switch ((d + 31) / 32) {
    case 1: return fn(std::integral_constant<int, 32>{});
    case 2: return fn(std::integral_constant<int, 64>{});
    case 3: return fn(std::integral_constant<int, 96>{});
    case 4: return fn(std::integral_constant<int, 128>{});
    case 5: return fn(std::integral_constant<int, 160>{});
    case 6: return fn(std::integral_constant<int, 192>{});
    case 7: return fn(std::integral_constant<int, 224>{});
    default: return fn(std::integral_constant<int, 256>{});
  }
}

// The ring's depth: 0 where the slice takes no ring, else pick_stages's
// (the most stages that leave room for two blocks on an SM, else the most
// that fit one).
template <typename T, int DP, typename Layout>
int ring_stages(Layout layout) {
  return Shape<T, DP>::kRing ? pick_stages(layout) : 0;
}

// Blocks an SM should hold: two where a slice's tiles are narrow enough for
// two blocks' layouts (and 128 registers a thread), so that clusters of 16
// stay resident for every row.
template <int DP>
constexpr int min_blocks() {
  return DP <= 64 ? 2 : 1;
}

}  // namespace fmav

}  // namespace tc
}  // namespace healnet
