// Fused KV projection backward, the cotangent pass: one read of the
// projection's cotangent g gives d_raw and the two column sums that make
// d_bias and d_colsum.
//
// Replaces: healnet_tpu/ops/fused_project.py::_bwd_kernel (the Pallas kernel
// launched by _pallas_bwd_call), for bf16 and f32 contexts; the int8 scale
// and the batch-sum output (with_bsum) are not ported.
//
// Per row r of the (M = b*t, F) cotangent, from the saved row statistics:
//   mu = s1[r] / D, inv = rsqrt(s2[r] / D - mu^2 + eps)
//   d_raw[r, n] = round_T(inv * g[r, n])
//   dsum2[0, n] = sum_r g[r, n],  dsum2[1, n] = sum_r inv * mu * g[r, n]
// so dsum2 = [d_bias; -d_colsum].
//
// Bound on an H100 SXM at the training shape (M = 32768, F = 252, bf16):
// 16.5 MB of g read and 16.5 MB of d_raw written, about 10 us at 3.35 TB/s;
// the arithmetic is a few operations per element. So it is bound by bytes.
// The design: each block owns kRows whole rows and walks them with one
// thread per column (neighbouring threads on neighbouring addresses), keeps
// both column sums in registers, and writes its partial (2, F) sums; a
// second kernel adds the partials in block order. The fixed order makes the
// sums deterministic, and no float atomics are used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;  // rows per block

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
__global__ void __launch_bounds__(kThreads)
    project_bwd_rows(const T* __restrict__ g, const float* __restrict__ s1,
                     const float* __restrict__ s2, T* __restrict__ d_raw,
                     float* __restrict__ part, int M, int F, float d_total, float eps) {
  __shared__ float row_inv[kRows], row_imu[kRows];
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, M - r0);
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const float mu = s1[r0 + i] / d_total;
    const float inv = rsqrtf(s2[r0 + i] / d_total - mu * mu + eps);
    row_inv[i] = inv;
    row_imu[i] = inv * mu;
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * 2 * F;
  for (int n = threadIdx.x; n < F; n += kThreads) {
    const T* gc = g + (size_t)r0 * F + n;
    T* dc = d_raw + (size_t)r0 * F + n;
    float sum_g = 0.f, sum_img = 0.f;
#pragma unroll 8
    for (int i = 0; i < rows; ++i) {
      const float x = to_float(gc[(size_t)i * F]);
      dc[(size_t)i * F] = from_float<T>(row_inv[i] * x);
      sum_g += x;
      sum_img = fmaf(row_imu[i], x, sum_img);
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

}  // namespace

extern "C" int healnet_fused_project_bwd_tiles(int M) { return (M + kRows - 1) / kRows; }

extern "C" int healnet_fused_project_bwd(const void* g, const float* s1, const float* s2,
                                         void* d_raw, float* part, float* dsum2, int M, int F,
                                         float d_total, float eps, int is_bf16, void* stream) {
  if (M <= 0 || F <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int tiles = healnet_fused_project_bwd_tiles(M);
  if (is_bf16) {
    project_bwd_rows<__nv_bfloat16><<<tiles, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), s1, s2, static_cast<__nv_bfloat16*>(d_raw), part,
        M, F, d_total, eps);
  } else {
    project_bwd_rows<float><<<tiles, kThreads, 0, s>>>(static_cast<const float*>(g), s1, s2,
                                                      static_cast<float*>(d_raw), part, M, F,
                                                      d_total, eps);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  project_bwd_merge<<<(2 * F + kThreads - 1) / kThreads, kThreads, 0, s>>>(part, dsum2, tiles,
                                                                          F);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* healnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
