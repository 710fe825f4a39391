// Fused KV projection backward, the cotangent pass: one read of the
// projection's cotangent g gives d_raw, the two column sums that make d_bias
// and d_colsum, and (optionally) the batch-sum that makes the encoding
// weights' gradient.
//
// Replaces: healnet_tpu/ops/fused_project.py::_bwd_kernel (the Pallas kernel
// launched by _pallas_bwd_call), for bf16 and f32 cotangents, with or
// without the per-token scale of an int8 context and the with_bsum output.
//
// Per row r = (b, t) of the (B*T, F) cotangent, from the saved row
// statistics (and the context's scale s, 1 when there is none):
//   mu = s1[r] / D, inv = rsqrt(s2[r] / D - mu^2 + eps)
//   d_raw[r, n] = round_T((s * inv) * g[r, n])      (scale and inv first)
//   dsum2[0, n] = sum_r g[r, n],  dsum2[1, n] = sum_r inv * mu * g[r, n]
//   bsum[t, n]  = sum_b round_T(inv * g[(b, t), n])  (f32, unscaled)
// so dsum2 = [d_bias; -d_colsum] and enc^T bsum is the encoding weights'
// gradient. bsum rounds each term to T before the f32 sum, as the JAX
// package's default backward (its _BWD_KERNEL = False path, the one it
// runs) does; its Pallas kernel sums the unrounded terms.
//
// Bound on an H100 SXM at the training shape (B = 8, T = 4096, F = 252,
// bf16): 16.5 MB of g read and 16.5 MB of d_raw written, plus 4.1 MB of
// bsum for an int8 context, about 10-11 us at 3.35 TB/s; the arithmetic is a
// few operations per element. So it is bound by bytes, and the design is
// about keeping enough bytes in flight (about 20-25 KB an SM at ~1 us of
// latency) in one launch:
// - persistent blocks of 512 threads, one an SM, walk tiles of tokens; a
//   thread owns one vector of VEC columns (as wide as the row pitch and F
//   allow, up to 4 columns: 8 bytes at brca's 504-byte bf16 rows, 16 in
//   f32, 4 at kirp's 540) and U tokens of the tile (1, 2 or 4 for 16-,
//   8- and narrower vectors), and walks its (token, batch element) rows 8 batch elements a
//   step;
// - each thread copies its own rows of the next steps into a ring of 3-4
//   stages in shared memory by cp.async (4-16 bytes; 2-byte vectors by
//   plain loads), so 64-128 KB an SM are in flight whatever the registers,
//   and no barrier is needed: a thread reads back only what it copied;
// - a row's mu and inv are computed from s1 and s2 (copied into the ring
//   with the step's vectors) where they are used, so the batch is not
//   bounded by a table, once a warp (a lane a row) and handed to the other
//   lanes by shuffles;
// - the batch-sum of a (token, column) is a register sum over the batch,
//   in batch order; the column sums stay in registers over the block's
//   steps, are reduced over the block's token rows in shared memory in a
//   fixed order, and written as the block's partial;
// - the partials are finished in the same launch: blocks take integer
//   tickets from a counter per group of 16 blocks; the last of a group adds
//   the group's partials in block order (all 16 loads issued before the
//   adds), and the last group to finish adds the groups' sums in group
//   order into dsum2 (and resets the counters). No float atomics: two calls
//   on one card are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 8;   // batch elements of a step
constexpr int kGroup = 16;  // blocks per first-level group of the column sums
constexpr int kRingBytes = 210 * 1024;  // shared memory the ring may take (3 f32 stages)

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

// VEC elements of T as one aligned access
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// copy one vector into shared memory: cp.async for 4-16 bytes (zeros where
// `valid` is false), a plain load and store for 2
template <int N>
__device__ __forceinline__ void copy_vec(void* dst, const void* src, bool valid) {
  if constexpr (N >= 4) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    if constexpr (N == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                   "r"(valid ? 16 : 0) : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(N),
                   "r"(valid ? N : 0) : "memory");
    }
  } else {
    *static_cast<uint16_t*>(dst) = valid ? *static_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Shape {
  int B, Tok, F;
  int W;       // threads a token row of the block spans (a multiple of 32)
  int RY;      // token rows of the block (kThreads / W)
  int nvec;    // column vectors of a row (F / VEC)
  float d_total, eps;
};

// the block's writes so far, then one ticket from `counter`: the barrier
// orders every thread's writes before thread 0's fence, whose cumulativity
// makes them visible to the block that takes a later ticket (and only
// thread 0 waits on its stores draining); the fence after the atomic lets
// the block read what earlier ticket holders wrote
__device__ __forceinline__ unsigned int take_ticket(unsigned int* counter,
                                                    unsigned int* ticket) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *ticket = atomicAdd(counter, 1u);
    __threadfence();
  }
  __syncthreads();
  return *ticket;
}

template <typename T, int VEC, int U>
struct Ring {
  static constexpr int kRows = U * kChunk;  // a thread's rows in a step
  static constexpr int kVec = (int)sizeof(T) * VEC;
  // the thread's vectors of a step, then its row's [s1, s2, scale] (lane l
  // copies those of row l % kRows, which it computes the factors of)
  static constexpr int kStage = kRows * kThreads * kVec + 3 * kThreads * 4;
  static constexpr int kStages = kRingBytes / kStage > 4 ? 4 : kRingBytes / kStage;
  static constexpr int kBytes = kStages * kStage;
};

// the block's column chunk starts at column vector blockIdx.y * W
template <typename T, int VEC, int U>
__global__ void __launch_bounds__(kThreads, 1)
    project_bwd(const T* __restrict__ g, const float* __restrict__ s1,
                const float* __restrict__ s2, const float* __restrict__ scale,
                T* __restrict__ d_raw, float* __restrict__ bsum, float* __restrict__ part,
                float* __restrict__ dsum2, unsigned int* __restrict__ counters, Shape sh) {
  using R = Ring<T, VEC, U>;
  using V = Vec<T, VEC>;
  static_assert(R::kRows <= 32, "a warp's lanes compute a step's row factors, one row a lane");
  constexpr int S = R::kStages;
  extern __shared__ __align__(16) unsigned char ring[];  // [stage][row][thread], stats
  __shared__ float red[2 * kThreads * VEC];  // [token row][which sum][column]
  __shared__ unsigned int ticket;
  const int B = sh.B, Tok = sh.Tok, F = sh.F;
  const int tx = threadIdx.x % sh.W, ty = threadIdx.x / sh.W, lane = threadIdx.x & 31;
  const int cv = blockIdx.y * sh.W + tx;  // the thread's column vector
  // a warp lies in one token row (W is a multiple of 32) and walks its
  // steps whole: lanes past the last column vector copy and store nothing
  const bool col_ok = cv < sh.nvec;
  const int col = col_ok ? cv * VEC : 0;
  const int tile_tokens = sh.RY * U;
  const int n_tiles = (Tok + tile_tokens - 1) / tile_tokens;
  const int chunks = (B + kChunk - 1) / kChunk;
  const int my_tiles = blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int steps = ty < sh.RY ? my_tiles * chunks : 0;
  // step i: tile blockIdx.x + (i / chunks) * gridDim.x, batch elements from (i % chunks) * kChunk
  auto token = [&](int i, int u) {
    return (blockIdx.x + (i / chunks) * gridDim.x) * tile_tokens + u * sh.RY + ty;
  };
  auto slot = [&](int i, int row) {
    return reinterpret_cast<V*>(ring + (i % S) * R::kStage) + row * kThreads + threadIdx.x;
  };
  auto stat = [&](int i, int which) {  // which: 0 s1, 1 s2, 2 scale
    return reinterpret_cast<float*>(ring + (i % S) * R::kStage + R::kRows * kThreads * R::kVec) +
           which * kThreads + threadIdx.x;
  };
  const int my_q = lane % R::kRows;  // the row of a step whose factors this lane computes
  auto issue = [&](int i) {
    if (i < steps) {
      const int b0 = (i % chunks) * kChunk;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = token(i, u);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const bool ok = col_ok && b0 + k < B && t < Tok;
          const T* src = ok ? g + ((size_t)(b0 + k) * Tok + t) * F + col : g;
          copy_vec<R::kVec>(slot(i, u * kChunk + k), src, ok);
        }
      }
      const int t = token(i, my_q / kChunk), b = b0 + my_q % kChunk;
      const bool ok = b < B && t < Tok;
      const size_t r = ok ? (size_t)b * Tok + t : 0;
      copy_vec<4>(stat(i, 0), s1 + r, ok);
      copy_vec<4>(stat(i, 1), s2 + r, ok);
      if (scale != nullptr) copy_vec<4>(stat(i, 2), scale + r, ok);
    }
    cp_async_commit();  // an empty group past the end keeps the counts even
  };

  float sum_g[VEC], sum_img[VEC], bs[U][VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) sum_g[e] = sum_img[e] = 0.f;

#pragma unroll
  for (int i = 0; i < S - 1; ++i) issue(i);
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<S - 2>();  // this thread's copies of step i have landed
    issue(i + S - 1);        // into the slot of step i - 1, read by this thread only
    const int b0 = (i % chunks) * kChunk;
    if (b0 == 0) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e) bs[u][e] = 0.f;
    }
    // the step's row factors, computed once a warp: lane l takes row l % R
    // (of the R = U x kChunk rows every lane of the warp walks), and the
    // lanes read them from each other
    float my_inv = 0.f, my_imu = 0.f, my_fac = 0.f;
    if (b0 + my_q % kChunk < B && token(i, my_q / kChunk) < Tok) {
      const float mu = *stat(i, 0) / sh.d_total;
      my_inv = rsqrtf(*stat(i, 1) / sh.d_total - mu * mu + sh.eps);
      my_imu = my_inv * mu;
      my_fac = scale != nullptr ? *stat(i, 2) * my_inv : my_inv;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = token(i, u);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int q = u * kChunk + k;
        const float inv = __shfl_sync(0xffffffffu, my_inv, q);
        const float imu = __shfl_sync(0xffffffffu, my_imu, q);
        const float fac = scale != nullptr ? __shfl_sync(0xffffffffu, my_fac, q) : inv;
        if (col_ok && b0 + k < B && t < Tok) {
          const size_t r = (size_t)(b0 + k) * Tok + t;
          const V x = *slot(i, q);
          V o;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float xf = to_float(x.v[e]);
            o.v[e] = from_float<T>(fac * xf);
            sum_g[e] += xf;
            sum_img[e] = fmaf(imu, xf, sum_img[e]);
            if (bsum != nullptr) bs[u][e] += to_float(from_float<T>(inv * xf));
          }
          *reinterpret_cast<V*>(d_raw + r * F + col) = o;
        }
      }
    }
    if (bsum != nullptr && col_ok && b0 + kChunk >= B) {  // the token's last batch elements
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = token(i, u);
        if (t >= Tok) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e) bsum[(size_t)t * F + col + e] = bs[u][e];
      }
    }
  }
  cp_async_wait<0>();

  // the block's column sums: its token rows' registers, added in row order
  const int chunk_cols = sh.W * VEC;  // columns of the block's chunk, padded
  const int col0 = blockIdx.y * chunk_cols;
  if (ty < sh.RY) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      red[(ty * 2) * chunk_cols + tx * VEC + e] = sum_g[e];
      red[(ty * 2 + 1) * chunk_cols + tx * VEC + e] = sum_img[e];
    }
  }
  __syncthreads();
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  const int n_blocks = gridDim.x * gridDim.y;
  for (int j = threadIdx.x; j < 2 * chunk_cols; j += kThreads) {
    const int which = j / chunk_cols, c = j % chunk_cols;
    if (col0 + c >= F) continue;
    float a = 0.f;
    for (int y = 0; y < sh.RY; ++y) a += red[(y * 2 + which) * chunk_cols + c];
    part[(size_t)block * 2 * F + which * F + col0 + c] = a;
  }

  // first level: the last block of each group of kGroup adds its group's
  // partials in block order. A group is kGroup consecutive blocks of one
  // column chunk, so every partial it adds covers the same columns.
  const int per_chunk = gridDim.x;
  const int groups_per_chunk = (per_chunk + kGroup - 1) / kGroup;
  const int grp = blockIdx.y * groups_per_chunk + blockIdx.x / kGroup;
  const int g_first = blockIdx.x / kGroup * kGroup;
  const int g_size = min(kGroup, per_chunk - g_first);
  const int n_groups = groups_per_chunk * gridDim.y;
  float* gpart = part + (size_t)n_blocks * 2 * F;  // (n_groups, 2, F)
  if (take_ticket(&counters[grp], &ticket) != (unsigned)g_size - 1) return;
  for (int j = threadIdx.x; j < 2 * chunk_cols; j += kThreads) {
    const int which = j / chunk_cols, c = j % chunk_cols;
    if (col0 + c >= F) continue;
    const size_t at = (size_t)which * F + col0 + c;
    const float* src = part + (size_t)(blockIdx.y * per_chunk + g_first) * 2 * F + at;
    float v[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) v[k] = k < g_size ? __ldcg(src + (size_t)k * 2 * F) : 0.f;
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) a += v[k];
    gpart[(size_t)grp * 2 * F + at] = a;
  }
  if (threadIdx.x == 0) counters[grp] = 0u;  // for the next call

  // second level: the last group to finish adds the groups' sums of each
  // column's chunk, in group order, kGroup loads in flight at a time
  if (take_ticket(&counters[n_groups], &ticket) != (unsigned)n_groups - 1) return;
  for (int j = threadIdx.x; j < 2 * F; j += kThreads) {
    const int which = j / F, c = j % F;
    const float* src = gpart + (size_t)(c / chunk_cols * groups_per_chunk) * 2 * F + which * F + c;
    float a = 0.f;
    for (int k0 = 0; k0 < groups_per_chunk; k0 += kGroup) {
      float v[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        v[k] = k0 + k < groups_per_chunk ? __ldcg(src + (size_t)(k0 + k) * 2 * F) : 0.f;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) a += v[k];
    }
    dsum2[j] = a;
  }
  if (threadIdx.x == 0) counters[n_groups] = 0u;
}

template <typename T, int VEC, int U>
cudaError_t launch(const void* g, const float* s1, const float* s2, const float* scale,
                   void* d_raw, float* bsum, float* part, float* dsum2, unsigned int* counters,
                   Shape sh, int grid_x, int grid_y, cudaStream_t st) {
  constexpr int bytes = Ring<T, VEC, U>::kBytes;
  auto kernel = project_bwd<T, VEC, U>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(grid_x, grid_y), kThreads, bytes, st>>>(
      static_cast<const T*>(g), s1, s2, scale, static_cast<T*>(d_raw), bsum, part, dsum2,
      counters, sh);
  return cudaGetLastError();
}

// VEC -> U tokens a thread: 1 for 16-byte vectors, 2 for 8-byte ones, 4 for
// narrower, so a step's copies carry 64-128 bytes a thread (at brca's 8-byte
// bf16 vectors 2 tokens measured 0.0198 ms against 0.0223 for 1; at kirp's
// 4-byte ones 4 tokens 0.0311 against 0.0331 for 2)
template <typename T>
cudaError_t dispatch(int vec, const void* g, const float* s1, const float* s2,
                     const float* scale, void* d_raw, float* bsum, float* part, float* dsum2,
                     unsigned int* counters, Shape sh, int gx, int gy, cudaStream_t st) {
  constexpr int kSize = (int)sizeof(T);
#define HEALNET_BWD_CASE(V)                                                         \
  case V:                                                                           \
    return launch<T, V, (V * kSize >= 16 ? 1 : V * kSize >= 8 ? 2 : 4)>(            \
        g, s1, s2, scale, d_raw, bsum, part, dsum2, counters, sh, gx, gy, st);
  switch (vec) {
    HEALNET_BWD_CASE(1)
    HEALNET_BWD_CASE(2)
    HEALNET_BWD_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef HEALNET_BWD_CASE
}

}  // namespace

// The launch as ops/fused_project.py::project_bwd_plan sizes it. vec:
// elements per column vector (1, 2 or 4; F % vec == 0, g's base aligned to
// a vector); w: threads a token row spans; grid_x blocks over tokens for
// each of grid_y column chunks. part: (grid_x * grid_y + n_groups, 2, F) f32
// scratch, n_groups = ceil(grid_x / 16) * grid_y; counters: n_groups + 1
// zeros, left zero.
extern "C" int healnet_fused_project_bwd(const void* g, const float* s1, const float* s2,
                                         const float* scale, void* d_raw, float* part,
                                         float* dsum2, float* bsum, unsigned int* counters,
                                         int B, int Tok, int F, float d_total, float eps,
                                         int is_bf16, int vec, int w, int grid_x, int grid_y,
                                         void* stream) {
  if (B <= 0 || Tok <= 0 || F <= 0) return 0;
  if (w <= 0 || w > kThreads || w % 32 != 0 || F % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape sh;
  sh.B = B;
  sh.Tok = Tok;
  sh.F = F;
  sh.W = w;
  sh.RY = kThreads / w;
  sh.nvec = F / vec;
  sh.d_total = d_total;
  sh.eps = eps;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(vec, g, s1, s2, scale, d_raw, bsum, part, dsum2,
                                        counters, sh, grid_x, grid_y, st)
              : dispatch<float>(vec, g, s1, s2, scale, d_raw, bsum, part, dsum2, counters, sh,
                                grid_x, grid_y, st);
  return static_cast<int>(e);
}

extern "C" const char* healnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
