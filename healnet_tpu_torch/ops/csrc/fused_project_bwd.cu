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
// few operations per element. So it is bound by bytes. The design: each
// block owns a tile of tokens for every batch element (16 tokens x 8 = 128
// rows at that shape, 256 blocks) and walks its rows with one thread per
// column (neighbouring threads on neighbouring addresses), token by token
// and, inside a token, batch element by batch element, so the batch-sum of a
// (token, column) is a register sum over consecutive iterations. Both
// column sums stay in registers, and each block writes its partial (2, F)
// sums; a second kernel adds the partials in block order. The fixed orders
// make every sum deterministic, and no float atomics are used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;        // rows per block when the batch is at most this
constexpr int kMaxBatch = 4096;   // shared row table: 3 floats a row, 48 KB

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

// tokens per block: enough for about kRows rows, at least one
__host__ __device__ __forceinline__ int tokens_per_block(int B) { return B >= kRows ? 1 : kRows / B; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    project_bwd_tokens(const T* __restrict__ g, const float* __restrict__ s1,
                       const float* __restrict__ s2, const float* __restrict__ scale,
                       T* __restrict__ d_raw, float* __restrict__ part, float* __restrict__ bsum,
                       int B, int Tok, int F, float d_total, float eps) {
  extern __shared__ float rows[];  // [inv | inv * mu | (scale *) inv], row i = tt * B + b
  const int per = tokens_per_block(B);
  const int t0 = blockIdx.x * per;
  const int toks = min(per, Tok - t0);
  const int n_rows = toks * B;
  float* row_inv = rows;
  float* row_imu = rows + n_rows;
  float* row_fac = rows + 2 * n_rows;
  for (int i = threadIdx.x; i < n_rows; i += kThreads) {
    const size_t r = (size_t)(i % B) * Tok + t0 + i / B;
    const float mu = s1[r] / d_total;
    const float inv = rsqrtf(s2[r] / d_total - mu * mu + eps);
    row_inv[i] = inv;
    row_imu[i] = inv * mu;
    row_fac[i] = scale != nullptr ? scale[r] * inv : inv;
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * 2 * F;
  for (int n = threadIdx.x; n < F; n += kThreads) {
    float sum_g = 0.f, sum_img = 0.f;
    for (int tt = 0; tt < toks; ++tt) {
      const size_t base = (size_t)(t0 + tt) * F + n;  // (b = 0, t, n)
      float acc_b = 0.f;
#pragma unroll 4
      for (int b = 0; b < B; ++b) {
        const int i = tt * B + b;
        const size_t at = (size_t)b * Tok * F + base;
        const float x = to_float(g[at]);
        d_raw[at] = from_float<T>(row_fac[i] * x);
        sum_g += x;
        sum_img = fmaf(row_imu[i], x, sum_img);
        if (bsum != nullptr) acc_b += to_float(from_float<T>(row_inv[i] * x));
      }
      if (bsum != nullptr) bsum[base] = acc_b;
    }
    out[n] = sum_g;
    out[F + n] = sum_img;
  }
}

// dsum2[j] = sum over blocks b (in order) of part[b][j], j < 2F
__global__ void __launch_bounds__(kThreads)
    project_bwd_merge(const float* __restrict__ part, float* __restrict__ dsum2, int tiles,
                      int F) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= 2 * F) return;
  float a = 0.f;
  for (int b = 0; b < tiles; ++b) a += part[(size_t)b * 2 * F + j];
  dsum2[j] = a;
}

template <typename T>
cudaError_t launch(const void* g, const float* s1, const float* s2, const float* scale,
                   void* d_raw, float* part, float* bsum, int B, int Tok, int F, float d_total,
                   float eps, int tiles, cudaStream_t s) {
  const size_t smem = 3 * sizeof(float) * (size_t)tokens_per_block(B) * B;
  project_bwd_tokens<T><<<tiles, kThreads, smem, s>>>(
      static_cast<const T*>(g), s1, s2, scale, static_cast<T*>(d_raw), part, bsum, B, Tok, F,
      d_total, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int healnet_fused_project_bwd_max_batch() { return kMaxBatch; }

extern "C" int healnet_fused_project_bwd_tiles(int B, int Tok) {
  const int per = tokens_per_block(B);
  return (Tok + per - 1) / per;
}

// scale: the int8 context's per-row scale, or null; bsum: the (Tok, F)
// batch-sum output, or null. B <= kMaxBatch (the wrapper checks).
extern "C" int healnet_fused_project_bwd(const void* g, const float* s1, const float* s2,
                                         const float* scale, void* d_raw, float* part,
                                         float* dsum2, float* bsum, int B, int Tok, int F,
                                         float d_total, float eps, int is_bf16, void* stream) {
  if (B <= 0 || Tok <= 0 || F <= 0) return 0;
  if (B > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int tiles = healnet_fused_project_bwd_tiles(B, Tok);
  const cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(g, s1, s2, scale, d_raw, part, bsum, B, Tok, F, d_total,
                                      eps, tiles, s)
              : launch<float>(g, s1, s2, scale, d_raw, part, bsum, B, Tok, F, d_total, eps,
                              tiles, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  project_bwd_merge<<<(2 * F + kThreads - 1) / kThreads, kThreads, 0, s>>>(part, dsum2, tiles,
                                                                          F);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* healnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
