// Fused merged-KV projection forward, the generic kernel: one read of the
// context for the row statistics, the GEMM against the merged folded
// weights, and the folded LayerNorm.
//
// Replaces: healnet_tpu/ops/fused_project.py::_kernel (the Pallas kernel
// launched by _pallas_call), its bf16 contexts and its int8 (quantized
// context) branch, computed in bf16. Forward only. The model's bf16 calls
// take the Hopper kernel of fused_project_tma.cu, f32 compute takes
// fused_project_f32.cu; this one takes bf16 rows TMA cannot describe (a base
// or row pitch off 16 bytes, such as C = 203). The wrapper routes by
// ops/fused_project.py::project_route and counts these launches in
// `launches_generic`.
//
// What it computes, per context row r (token tok = r % T):
//   s1 = sum_c x[r, c] + encs[0, tok]        (f32 sums of the stored values)
//   s2 = sum_c x[r, c]^2 + encs[1, tok]
//   mu = s1 / D, inv = rsqrt(s2 / D - mu^2 + eps)
//   acc[r, n] = sum_c x[r, c] * W[c, n]      (f32 accumulation)
//   low = round_cdt(round_cdt(acc) + encp[tok, n])   (the rounding contract)
//   kv[r, n] = inv * (low - mu * aux[0, n]) + aux[1, n]
// For an int8 context x = q (|q| <= 127) with a per-row f32 scale s, the
// sums of q and q^2 are taken exactly in int32 and rescaled,
//   s1 = s * sum q + encs[0, tok],  s2 = (s * s) * sum q^2 + encs[1, tok],
// and the scale applies on the accumulator, rounded on both sides:
//   low = round_cdt(round_cdt(round_cdt(acc) * s) + encp[tok, n]).
// The JAX package sums q^2 in f32 (order-dependent past 2^24); the integer
// sum is exact, so s2 may differ from it in its last bits.
//
// Bound on an H100 SXM at the serving shape (8 x 4096 x 2048 bf16 context,
// F = 252): the context read is 134 MB of the ~154 MB the function must move,
// about 46 us at 3.35 TB/s, against 33.8 GFLOP, about 34 us at 989 TFLOP/s
// bf16 -- so it is bound by bytes, and only if the GEMM runs on the tensor
// cores. The design answers both: each block (512 threads) owns 128 whole
// rows and up to 256 output columns, so it streams its rows of the context
// exactly once (the statistics are taken from the same registers that feed
// shared memory), runs the product with mma.sync m16n8k16 bf16 -> f32 (B
// fragments by ldmatrix.trans from a row-major tile), and applies the
// normalization in the epilogue on the accumulators. F is not padded: the
// ragged column edge is masked in the loads and the stores. The weights
// (about 1 MB) are re-read from L2 by every block, which the 128-row tile
// halves against a 64-row one; only the next tile is prefetched, into
// registers (fused_project_tma.cu answers both on the model's path).
//
// int8 contexts: a thread loads its 8 channels of a row as one 8-byte word
// (16 bytes for bf16), so the context read is halved: about 67 MB at the
// serving shape against 33.8 GFLOP, which makes the bound the tensor cores'
// (about 34 us), not the bytes. The values are converted to bf16 (exact for
// |q| <= 127) in registers before shared memory, so the product runs as for
// a bf16 context.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 256;  // output columns per block
constexpr int kRows = 128;       // context rows per block (4 threads a row)
constexpr int kBK = 32;   // context channels per k-step
constexpr int kPad = 8;   // bf16 padding per shared row: conflict-free fragments

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Reduces a row's partial sums over the 4 lanes that loaded it (f32 sums of
// bf16/f32 values, exact int32 sums of int8 ones), rescales an int8 row,
// adds the encoding statistics, stores s1/s2 (first column block only) and
// the row's (mu, inv, scale) for the epilogue.
template <typename Acc>
__device__ __forceinline__ void finish_row_stats(Acc st1, Acc st2, int tid, int row,
                                                 int local_row, int M, int T,
                                                 const float* encs, const float* scale,
                                                 float* s1_out, float* s2_out, float d_total,
                                                 float eps, float* row_mu, float* row_inv,
                                                 float* row_scale) {
  st1 += __shfl_xor_sync(0xffffffffu, st1, 1);
  st1 += __shfl_xor_sync(0xffffffffu, st1, 2);
  st2 += __shfl_xor_sync(0xffffffffu, st2, 1);
  st2 += __shfl_xor_sync(0xffffffffu, st2, 2);
  if ((tid & 3) == 0) {
    float mu = 0.f, inv = 0.f, sc = 1.f;
    if (row < M) {
      const int tok = row % T;
      float a = static_cast<float>(st1), q = static_cast<float>(st2);
      if (scale != nullptr) {
        sc = scale[row];
        a = sc * a;
        q = sc * sc * q;
      }
      const float s1 = a + encs[tok];
      const float s2 = q + encs[T + tok];
      if (blockIdx.y == 0) {
        s1_out[row] = s1;
        s2_out[row] = s2;
      }
      mu = s1 / d_total;
      inv = rsqrtf(s2 / d_total - mu * mu + eps);
    }
    row_mu[local_row] = mu;
    row_inv[local_row] = inv;
    row_scale[local_row] = sc;
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 8 consecutive channels of one context row (zeros past the row's end): 16
// bytes of bf16, or 8 bytes of int8
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* row, bool valid, int c, int C,
                                       int vec) {
  union {
    uint4 u;
    __nv_bfloat16 h[8];
  } r;
  if (valid && vec && c < C) {
    r.u = *reinterpret_cast<const uint4*>(row + c);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) r.h[e] = (valid && c + e < C) ? row[c + e] : __float2bfloat16(0.f);
  }
  return r.u;
}

union I8x8 {
  uint2 u;
  int8_t q[8];
};

__device__ __forceinline__ uint2 load8(const int8_t* row, bool valid, int c, int C, int vec) {
  I8x8 r;
  if (valid && vec && c < C) {
    r.u = *reinterpret_cast<const uint2*>(row + c);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) r.q[e] = (valid && c + e < C) ? row[c + e] : int8_t(0);
  }
  return r.u;
}

// the 8 loaded values as bf16 for shared memory (int8 converts exactly), and
// their contribution to the row sums
__device__ __forceinline__ uint4 as_bf16x8(uint4 x) { return x; }

__device__ __forceinline__ uint4 as_bf16x8(uint2 x) {
  I8x8 in;
  in.u = x;
  union {
    uint4 u;
    __nv_bfloat16 h[8];
  } out;
#pragma unroll
  for (int e = 0; e < 8; ++e) out.h[e] = __float2bfloat16(static_cast<float>(in.q[e]));
  return out.u;
}

__device__ __forceinline__ void add_stats(uint4 x, float& st1, float& st2) {
  union {
    uint4 u;
    __nv_bfloat16 h[8];
  } v;
  v.u = x;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float f = __bfloat162float(v.h[e]);
    st1 += f;
    st2 += f * f;
  }
}

__device__ __forceinline__ void add_stats(uint2 x, int& st1, int& st2) {
  I8x8 v;
  v.u = x;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int q = v.q[e];
    st1 += q;
    st2 += q * q;
  }
}

// input type -> (what a thread loads per k-step, how its row sums add up)
template <typename TIn>
struct Input;
template <>
struct Input<__nv_bfloat16> {
  using Raw = uint4;
  using Acc = float;
  static constexpr bool kQuant = false;
};
template <>
struct Input<int8_t> {
  using Raw = uint2;
  using Acc = int;
  static constexpr bool kQuant = true;
};

// weights W[gk, gn:gn+2] packed in one word (zeros past the edges)
__device__ __forceinline__ uint32_t load_w2(const __nv_bfloat16* w, int gk, int gn, int C,
                                            int F, bool pair_ok) {
  if (gk >= C) return 0u;
  const __nv_bfloat16* src = w + (size_t)gk * F + gn;
  if (pair_ok) return *reinterpret_cast<const uint32_t*>(src);
  union {
    uint32_t u;
    __nv_bfloat16 h[2];
  } r;
  r.u = 0u;  // +0.0 in both halves
  if (gn < F) r.h[0] = src[0];
  if (gn + 1 < F) r.h[1] = src[1];
  return r.u;
}

template <int BM, typename TIn>
__global__ void __launch_bounds__(BM * 4, 128 / BM)
    project_generic_bf16(const TIn* __restrict__ dat, const __nv_bfloat16* __restrict__ w,
                         const __nv_bfloat16* __restrict__ encp, const float* __restrict__ encs,
                         const float* __restrict__ aux, const float* __restrict__ scale,
                         __nv_bfloat16* __restrict__ kv, float* __restrict__ s1_out,
                         float* __restrict__ s2_out, int M, int C, int F, int T, float d_total,
                         float eps, int vec_a) {
  using Acc = typename Input<TIn>::Acc;
  constexpr bool kQuant = Input<TIn>::kQuant;
  constexpr int kRowsPerPass = BM / 32;  // weight rows one pass of the block loads
  __shared__ __align__(16) __nv_bfloat16 As[BM][kBK + kPad];
  __shared__ __align__(16) __nv_bfloat16 Bs[kBK][kBN + kPad];  // row-major [k][n]
  __shared__ float row_mu[BM], row_inv[BM], row_scale[BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // (BM / 32) x 4 warps over BM x 256
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * kBN;

  // A loader: 8 consecutive channels of one row per thread
  const int a_r = tid >> 2, a_c = (tid & 3) * 8;
  const int a_row = row0 + a_r;
  const bool a_valid = a_row < M;
  const TIn* a_src = dat + (size_t)(a_valid ? a_row : 0) * C;
  // B loader: one pair of output columns, k rows b_k + kRowsPerPass * i
  const int b_n = (tid & 127) * 2, b_k = tid >> 7;
  const int gn = col0 + b_n;
  const bool pair_ok = ((F & 1) == 0) && (gn + 1 < F);

  Acc st1 = 0, st2 = 0;
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  typename Input<TIn>::Raw a_reg = load8(a_src, a_valid, a_c, C, vec_a);
  uint32_t b_reg[kBK / kRowsPerPass];
#pragma unroll
  for (int i = 0; i < kBK / kRowsPerPass; ++i)
    b_reg[i] = load_w2(w, b_k + kRowsPerPass * i, gn, C, F, pair_ok);

  for (int k0 = 0; k0 < C; k0 += kBK) {
    *reinterpret_cast<uint4*>(&As[a_r][a_c]) = as_bf16x8(a_reg);
    add_stats(a_reg, st1, st2);
#pragma unroll
    for (int i = 0; i < kBK / kRowsPerPass; ++i)
      *reinterpret_cast<uint32_t*>(&Bs[b_k + kRowsPerPass * i][b_n]) = b_reg[i];
    __syncthreads();
    if (k0 + kBK < C) {  // next tile in flight during the MMAs
      a_reg = load8(a_src, a_valid, k0 + kBK + a_c, C, vec_a);
#pragma unroll
      for (int i = 0; i < kBK / kRowsPerPass; ++i)
        b_reg[i] = load_w2(w, k0 + kBK + b_k + kRowsPerPass * i, gn, C, F, pair_ok);
    }

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + gid;
        af[mi][0] = ld32(&As[r][kk + tig * 2]);
        af[mi][1] = ld32(&As[r + 8][kk + tig * 2]);
        af[mi][2] = ld32(&As[r][kk + tig * 2 + 8]);
        af[mi][3] = ld32(&As[r + 8][kk + tig * 2 + 8]);
      }
      const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {  // two n8 tiles per ldmatrix
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &Bs[krow][wn * 64 + (nj * 2 + (lane >> 4)) * 8]);
        mma_bf16(acc[0][2 * nj], af[0], bf[0], bf[1]);
        mma_bf16(acc[1][2 * nj], af[1], bf[0], bf[1]);
        mma_bf16(acc[0][2 * nj + 1], af[0], bf[2], bf[3]);
        mma_bf16(acc[1][2 * nj + 1], af[1], bf[2], bf[3]);
      }
    }
    __syncthreads();
  }

  finish_row_stats(st1, st2, tid, a_row, a_r, M, T, encs, kQuant ? scale : nullptr, s1_out,
                   s2_out, d_total, eps, row_mu, row_inv, row_scale);
  __syncthreads();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = wm * 32 + mi * 16 + gid + half * 8;
      const int r = row0 + lr;
      if (r >= M) continue;
      const int tok = r % T;
      const float mu = row_mu[lr], inv = row_inv[lr], sc = row_scale[lr];
      const __nv_bfloat16* ep = encp + (size_t)tok * F;
      __nv_bfloat16* out = kv + (size_t)r * F;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = col0 + wn * 64 + ni * 8 + tig * 2 + j;
          if (n >= F) continue;
          float a = round_bf16(acc[mi][ni][half * 2 + j]);
          if (kQuant) a = round_bf16(a * sc);
          const float low = round_bf16(a + __bfloat162float(ep[n]));
          out[n] = __float2bfloat16(inv * (low - mu * aux[n]) + aux[F + n]);
        }
      }
    }
  }
}

template <typename TIn>
void launch_bf16(const void* dat, const void* w, const void* encp, const float* encs,
                 const float* aux, const float* scale, void* kv, float* s1, float* s2, int M,
                 int C, int F, int T, float d_total, float eps, int vec_a, cudaStream_t s) {
  const dim3 grid((M + kRows - 1) / kRows, (F + kBN - 1) / kBN);
  project_generic_bf16<kRows, TIn><<<grid, kRows * 4, 0, s>>>(
      static_cast<const TIn*>(dat), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(encp), encs, aux, scale,
      static_cast<__nv_bfloat16*>(kv), s1, s2, M, C, F, T, d_total, eps, vec_a);
}

}  // namespace

// bf16 compute and output; is_int8: the context is int8 with a per-row
// scale, else bf16.
extern "C" int healnet_fused_project_generic(const void* dat, const void* w, const void* encp,
                                             const float* encs, const float* aux,
                                             const float* scale, void* kv, float* s1, float* s2,
                                             int M, int C, int F, int T, float d_total, float eps,
                                             int is_int8, int vec_a, void* stream) {
  if (M <= 0 || F <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_int8) {
    launch_bf16<int8_t>(dat, w, encp, encs, aux, scale, kv, s1, s2, M, C, F, T, d_total, eps,
                        vec_a, s);
  } else {
    launch_bf16<__nv_bfloat16>(dat, w, encp, encs, aux, nullptr, kv, s1, s2, M, C, F, T,
                               d_total, eps, vec_a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* healnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
