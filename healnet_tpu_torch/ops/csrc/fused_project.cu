// Fused merged-KV projection forward for few rows: the row statistics, the
// GEMM against the merged folded weights and the folded LayerNorm, split
// over the channels across a thread-block cluster.
//
// Replaces: healnet_tpu/ops/fused_project.py::_kernel (the Pallas kernel
// launched by _pallas_call) for bf16 compute over bf16 and int8 contexts of
// few rows at any byte offset: the omic vector (8, 1, C) of a cohort whose
// omic width is not a multiple of 8. ops/fused_project.py routes a call
// here by project_route ("generic") and project_generic_plan (at most
// SPLIT_MAX_ROWS rows; more take the hull kinds of fused_project_tma.cu)
// and counts the launches in `launches_generic_split`.
//
// What it computes, per context row r (token tok = r % T), with the
// rounding contract of fused_project_tma.cu and the JAX kernel:
//   s1 = sum_c x[r, c] + encs[0, tok], s2 = sum_c x[r, c]^2 + encs[1, tok]
//   (int8, x = q with a per-row scale s: the sums of q and q^2 exact in
//   int32, then s * sum q, (s * s) * sum q^2)
//   mu = s1 / D, inv = rsqrt(s2 / D - mu^2 + eps)
//   acc[r, n] = sum_c x[r, c] * W[c, n]          (f32 accumulation)
//   low = round(round(acc) [* s, rounded] + encp[tok, n])
//   kv[r, n] = inv * (low - mu * aux[0, n]) + aux[1, n]
//
// Bound on an H100 SXM at the omic vector (8 x 1 x 2001 bf16, F 252): the
// weights are 1 MB of the 1.05 MB the function must move (0.3 us at
// 3.35 TB/s) against 8 MFLOP; what a call costs is its latency, and one
// block walking all of C (the tiled kernel's one row tile on one SM) pays
// every k-step's load latency in turn. Design:
// - The channels are split over a cluster of up to 16 blocks and the
//   columns over blocks of 64 (and the rows over blocks of 8): a block
//   reads its 64-channel k-slices of the weights (the wrapper's (nk, F, 64)
//   layout, a slice row of a column one contiguous 128 bytes) once, 16
//   bytes a load, all of a thread's loads in flight before the context
//   arrives.
// - Each warp stages one row's 16-byte hull of the block's channels with
//   16-byte loads (only the context's last row may end inside a 16-byte
//   word: those bytes are loaded one by one up to its end, never past it),
//   then widens it to f32 in shared memory, taking the row sums on the way
//   and zeroing the channels at or past C.
// - The products are f32 FMAs on the CUDA cores (bf16 and int8 products
//   are exact in f32): thread (column, part) sums a quarter of the block's
//   channels for the 8 rows; the parts add up in shared memory in a fixed
//   order, then block 0 of the cluster adds the blocks' partial products
//   and row sums through distributed shared memory, in rank order, and runs
//   the epilogue. No atomics: two calls give the same bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;          // rows a block (a warp stages each)
constexpr int kCols = 64;         // columns a block
constexpr int kParts = 4;         // threads over a column's channels
constexpr int kSlice = 64;        // channels of a weight k-slice
constexpr int kGroupSlices = 4;   // k-slices staged at once
constexpr int kGroup = kGroupSlices * kSlice;
constexpr int kChunksPerThread = kGroup / 8 / kParts;  // 16-byte weight loads a group
constexpr int kMaxCluster = 16;

// Shared memory (static; ops/fused_project.py::SPLIT_SMEM mirrors it): the
// staged hulls (a row's bf16 channels of a group and 32 bytes of slack:
// alignment and the 16-byte tail), the rows widened to f32, the parts'
// products, the block's sums and its row sums.
struct Smem {
  alignas(16) unsigned char hull[kRows][kGroup * 2 + 32];
  alignas(16) float xs[kRows][kGroup];
  alignas(16) float red[kRows][kCols][kParts];
  float part[kRows][kCols];
  float stats[kRows][2];  // f32 sums, or int32 ones by their bits
};

struct SplitParams {
  const unsigned char* dat;   // (M, C) context, bf16 or int8, any byte offset
  const unsigned char* end;   // one past the context's last byte (dat + M C itemsize)
  const __nv_bfloat16* w;     // (nk, F, 64) weight k-slices, zero past C
  const __nv_bfloat16* encp;  // (T, F) encoding projection
  const float* encs;          // (2, T) encoding row sums, sums of squares
  const float* aux;           // (2, F) [colsum(W); folded bias]
  const float* scale;         // (M) int8 per-row scales, or null
  __nv_bfloat16* kv;          // (M, F)
  float* s1;                  // (M)
  float* s2;                  // (M)
  int M, C, F, T, nk, slices;  // slices: k-slices a block of the cluster takes
  float d_total, eps;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename TIn>
struct Input;
template <>
struct Input<__nv_bfloat16> {
  using Sum = float;
  static constexpr int kSize = 2;
  static __device__ __forceinline__ float value(const unsigned char* p) {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  }
  static __device__ __forceinline__ void add(float v, float& s1, float& s2) {
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
  static __device__ __forceinline__ float pack(float s) { return s; }
  static __device__ __forceinline__ float unpack(float s) { return s; }
};
template <>
struct Input<int8_t> {
  using Sum = int;
  static constexpr int kSize = 1;
  static __device__ __forceinline__ float value(const unsigned char* p) {
    return static_cast<float>(*reinterpret_cast<const int8_t*>(p));
  }
  static __device__ __forceinline__ void add(float v, int& s1, int& s2) {
    const int q = static_cast<int>(v);
    s1 += q;
    s2 += q * q;
  }
  static __device__ __forceinline__ float pack(int s) { return __int_as_float(s); }
  static __device__ __forceinline__ int unpack(float s) { return __float_as_int(s); }
};

template <typename Sum>
__device__ __forceinline__ Sum warp_sum(Sum v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// Bytes [lo, hi) of the context into `dst` (lo 16-byte aligned, hi <= lo
// + kGroup * 2 + 32) by the warp's lanes, 16 bytes a load; where a 16-byte
// word runs past the context's end, its bytes up to the end one by one.
__device__ __forceinline__ void stage_hull(unsigned char* dst, const unsigned char* lo,
                                           const unsigned char* hi, const unsigned char* end,
                                           int lane) {
  const int words = static_cast<int>((hi - lo + 15) >> 4);
  for (int k = lane; k < words; k += 32) {
    const unsigned char* src = lo + 16 * k;
    if (src + 16 <= end) {
      *reinterpret_cast<uint4*>(dst + 16 * k) = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      for (int b = 0; b < 16; ++b) dst[16 * k + b] = src + b < end ? src[b] : 0;
    }
  }
}

template <typename TIn>
__global__ void __launch_bounds__(kThreads) project_split(const SplitParams p) {
  using In = Input<TIn>;
  using Sum = typename In::Sum;
  __shared__ Smem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.y * kCols, row0 = blockIdx.z * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = tid / kParts, part = tid % kParts;  // this thread's column and channel part
  const int ks0 = rank * p.slices, ks1 = min(p.nk, ks0 + p.slices);
  const int my_row = row0 + warp;  // the row this warp stages
  const bool row_ok = my_row < p.M;
  const size_t pitch = static_cast<size_t>(p.C) * In::kSize;

  float acc[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) acc[m] = 0.f;
  Sum st1 = 0, st2 = 0;

  for (int g0 = ks0; g0 < ks1; g0 += kGroupSlices) {
    const int c_begin = g0 * kSlice;
    const int c_len = min(ks1 - g0, kGroupSlices) * kSlice;  // channels of the group
    const int c_valid = max(0, min(p.C - c_begin, c_len));   // of them before C
    // this thread's weights of the group, in flight while the context comes
    uint4 wv[kChunksPerThread];
#pragma unroll
    for (int i = 0; i < kChunksPerThread; ++i) {
      const int q = part + kParts * i;  // 8-channel chunk of the group
      wv[i] = make_uint4(0u, 0u, 0u, 0u);
      if (8 * q < c_len && n0 + n < p.F)
        wv[i] = __ldg(reinterpret_cast<const uint4*>(
            p.w + ((static_cast<size_t>(g0 + q / 8) * p.F + n0 + n) * kSlice + (q % 8) * 8)));
    }
    // the warp's row: its hull, then its values widened, zero past C
    int off = 0;
    if (row_ok && c_valid > 0) {
      const unsigned char* first = p.dat + my_row * pitch + static_cast<size_t>(c_begin) * In::kSize;
      const unsigned char* lo = reinterpret_cast<const unsigned char*>(
          reinterpret_cast<uintptr_t>(first) & ~uintptr_t(15));
      off = static_cast<int>(first - lo);
      stage_hull(sm.hull[warp], lo, first + c_valid * In::kSize, p.end, lane);
    }
    __syncwarp();
    for (int c = lane; c < c_len; c += 32) {
      float v = 0.f;
      if (row_ok && c < c_valid) {
        v = In::value(&sm.hull[warp][off + c * In::kSize]);
        In::add(v, st1, st2);
      }
      sm.xs[warp][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kChunksPerThread; ++i) {
      const int q = part + kParts * i;
      if (8 * q >= c_len) continue;
      const uint32_t w[4] = {wv[i].x, wv[i].y, wv[i].z, wv[i].w};
      float wf[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wf[2 * j] = __uint_as_float(w[j] << 16);
        wf[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
      }
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const float4 x0 = *reinterpret_cast<const float4*>(&sm.xs[m][8 * q]);
        const float4 x1 = *reinterpret_cast<const float4*>(&sm.xs[m][8 * q + 4]);
        float a = acc[m];
        a = fmaf(x0.x, wf[0], a);
        a = fmaf(x0.y, wf[1], a);
        a = fmaf(x0.z, wf[2], a);
        a = fmaf(x0.w, wf[3], a);
        a = fmaf(x1.x, wf[4], a);
        a = fmaf(x1.y, wf[5], a);
        a = fmaf(x1.z, wf[6], a);
        a = fmaf(x1.w, wf[7], a);
        acc[m] = a;
      }
    }
    __syncthreads();  // the group's hulls and rows are spent
  }

  // the block's partial products (its parts added in order) and row sums
#pragma unroll
  for (int m = 0; m < kRows; ++m) sm.red[m][n][part] = acc[m];
  st1 = warp_sum(st1);
  st2 = warp_sum(st2);
  if (lane == 0) {
    sm.stats[warp][0] = In::pack(st1);
    sm.stats[warp][1] = In::pack(st2);
  }
  __syncthreads();
  for (int i = tid; i < kRows * kCols; i += kThreads) {
    const int m = i / kCols, c = i % kCols;
    const float4 r = *reinterpret_cast<const float4*>(sm.red[m][c]);
    sm.part[m][c] = ((r.x + r.y) + r.z) + r.w;
  }
  cluster.sync();  // every block's partials are out

  if (rank == 0) {  // the cluster's sums, in rank order, and the epilogue
    const int blocks = static_cast<int>(cluster.num_blocks());
    for (int i = tid; i < kRows * kCols; i += kThreads) {
      const int m = i / kCols, c = i % kCols;
      const int row = row0 + m, col = n0 + c;
      if (row >= p.M || col >= p.F) continue;
      float a = 0.f;
      Sum t1 = 0, t2 = 0;
      for (int r = 0; r < blocks; ++r) {
        const float* peer_stats = cluster.map_shared_rank(&sm.stats[m][0], r);
        a += *cluster.map_shared_rank(&sm.part[m][c], r);
        t1 += In::unpack(peer_stats[0]);
        t2 += In::unpack(peer_stats[1]);
      }
      const int tok = row % p.T;
      const float sc = p.scale != nullptr ? p.scale[row] : 1.f;
      const float v1 = sc * static_cast<float>(t1) + p.encs[tok];
      const float v2 = sc * sc * static_cast<float>(t2) + p.encs[p.T + tok];
      if (blockIdx.y == 0 && c == 0) {
        p.s1[row] = v1;
        p.s2[row] = v2;
      }
      const float mu = v1 / p.d_total;
      const float inv = rsqrtf(v2 / p.d_total - mu * mu + p.eps);
      float lowp = round_bf16(a);
      if (p.scale != nullptr) lowp = round_bf16(lowp * sc);
      const float low = round_bf16(lowp + __bfloat162float(p.encp[static_cast<size_t>(tok) * p.F + col]));
      p.kv[static_cast<size_t>(row) * p.F + col] =
          __float2bfloat16(inv * (low - mu * p.aux[col]) + p.aux[p.F + col]);
    }
  }
  cluster.sync();  // block 0 is done with the others' shared memory
}

template <typename TIn>
cudaError_t launch(const SplitParams& p, int cluster, cudaStream_t s) {
  auto kern = project_split<TIn>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (p.F + kCols - 1) / kCols, (p.M + kRows - 1) / kRows);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// Bytes of static shared memory a block of the split kernel takes, as the
// compiler laid it out (the host checks project_split_smem against it);
// -1 where the query fails.
extern "C" long long healnet_fused_project_split_smem(int is_int8) {
  cudaFuncAttributes attr;
  const cudaError_t e = is_int8 ? cudaFuncGetAttributes(&attr, project_split<int8_t>)
                                : cudaFuncGetAttributes(&attr, project_split<__nv_bfloat16>);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return static_cast<long long>(attr.sharedSizeBytes);
}

// One launch over (M, C) context rows at any byte offset: dat bf16 or int8
// (is_int8, with `scale`), contiguous; w_t (nk, F, 64) bf16 k-slices (zero past C); output (M, F) bf16 and s1,
// s2 (M) f32. Clusters of `cluster` blocks over the channels, `slices`
// k-slices a block (ops/fused_project.py::project_generic_plan).
extern "C" int healnet_fused_project_split(const void* dat, const void* w_t,
                                           const void* encp, const float* encs, const float* aux,
                                           const float* scale, void* kv, float* s1, float* s2,
                                           int M, int C, int F, int T, float d_total, float eps,
                                           int is_int8, int cluster, int slices, void* stream) {
  if (M <= 0 || F <= 0) return 0;
  const int nk = (C + kSlice - 1) / kSlice;
  if (cluster < 1 || cluster > kMaxCluster || slices < 1 || (cluster - 1) * slices >= nk ||
      cluster * slices < nk)
    return static_cast<int>(cudaErrorInvalidValue);
  SplitParams p;
  p.dat = static_cast<const unsigned char*>(dat);
  p.end = p.dat + static_cast<size_t>(M) * C * (is_int8 ? 1 : 2);
  p.w = static_cast<const __nv_bfloat16*>(w_t);
  p.encp = static_cast<const __nv_bfloat16*>(encp);
  p.encs = encs;
  p.aux = aux;
  p.scale = is_int8 ? scale : nullptr;
  p.kv = static_cast<__nv_bfloat16*>(kv);
  p.s1 = s1;
  p.s2 = s2;
  p.M = M;
  p.C = C;
  p.F = F;
  p.T = T;
  p.nk = nk;
  p.slices = slices;
  p.d_total = d_total;
  p.eps = eps;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return static_cast<int>(is_int8 ? launch<int8_t>(p, cluster, s)
                                  : launch<__nv_bfloat16>(p, cluster, s));
}

extern "C" const char* healnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
