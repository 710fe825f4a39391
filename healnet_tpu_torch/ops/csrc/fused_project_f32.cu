// Fused merged-KV projection forward, the f32 route: one read of the context
// for the row statistics, the product against the merged folded weights in
// full f32 on the CUDA cores, and the folded LayerNorm.
//
// Replaces: healnet_tpu/ops/fused_project.py::_kernel (the Pallas kernel
// launched by _pallas_call) wherever the compute dtype is f32: f32 contexts,
// and int8 contexts (its quantized branch) computed in f32. The wrapper
// routes these calls here (ops/fused_project.py::project_route, "f32") and
// counts them in `launches_f32` (f32 contexts) and `launches_f32_int8`.
//
// What it computes, per context row r (token tok = r % T), as
// fused_project.cu does:
//   s1 = sum_c x[r, c] + encs[0, tok],  s2 = sum_c x[r, c]^2 + encs[1, tok]
//   mu = s1 / D, inv = rsqrt(s2 / D - mu^2 + eps)
//   acc[r, n] = sum_c x[r, c] * W[c, n]           (f32 FMA, no TF32)
//   kv[r, n] = inv * (acc (* s) + encp[tok, n] - mu * aux[0, n]) + aux[1, n]
// For an int8 row (values q, scale s) the sums of q and q^2 are exact in
// int32 and rescaled, s1 = s * sum q + ..., s2 = (s * s) * sum q^2 + ...,
// and the scale multiplies the f32 accumulator (rounded once, in f32).
//
// Bound on an H100 SXM at brca (8 x 4096 x 2048 f32 context, F = 252): 33.8
// GFLOP of f32 FMA at 67 TFLOP/s, about 0.50 ms, against 268 MB of context,
// about 0.08 ms at 3.35 TB/s: bound by operations, so the design is about
// keeping the FMA pipe fed:
// - a block (256 threads) owns 128 rows and a column pass of up to 272
//   columns (kirp's F = 270 reads the context once; wider F takes ceil(F /
//   272) passes on the grid's y axis);
// - each thread keeps an 8 x 16 (8 x 17 at 272) register microtile: rows
//   4 ty + e and 64 + 4 ty + e, columns 4 (tx + 16 g) + e and, at 272,
//   256 + tx; a warp spans 4 ty by 8 tx, so each of its 128-bit operand
//   loads reads 64-128 distinct bytes of shared memory (one pass of the
//   pipe) and broadcasts them;
// - operands go straight into a shared-memory ring by 16-byte cp.async
//   (3 stages of 32 channels for f32, 4 for int8); one k-step ahead, one
//   thread per half row takes the row sums of the staged tile (exact int32
//   sums for int8) and writes it, as f32, channel-major into one of two
//   tiles the products read: one barrier per k-step;
// - per channel a thread issues 2 + 4 128-bit shared loads and one 32-bit
//   one for 8 x 17 FMAs, and loads channel k + 2's operands before it
//   issues channel k's FMAs.
// Rows whose base or pitch is off 16 bytes (C = 203) are staged by plain
// loads and shared stores instead of cp.async; the rest is the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;  // context rows per block
constexpr int kBK = 32;     // channels per k-step

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or zeros where `valid` is false (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// staged context rows: f32 rows padded to 36 floats, int8 rows to 48
// bytes, so 8 consecutive rows' 16-byte reads fall in distinct banks
template <typename TIn>
struct Input;
template <>
struct Input<float> {
  using Acc = float;
  static constexpr bool kQuant = false;
  static constexpr int kStages = 3;
  static constexpr int kPitch = kBK + 4;  // elements
};
template <>
struct Input<int8_t> {
  using Acc = int;
  static constexpr bool kQuant = true;
  static constexpr int kStages = 4;
  static constexpr int kPitch = kBK + 16;
};

// shared memory of one block: the ring (context tile, weight tile per
// stage) and the two channel-major f32 context tiles the products read
template <typename TIn, int NB>
struct Layout {
  static constexpr int kA = kRows * Input<TIn>::kPitch * (int)sizeof(TIn);
  static constexpr int kB = kBK * NB * 4;
  static constexpr int kStage = kA + kB;
  static constexpr int kTile = kBK * kRows * 4;
  static constexpr int kBytes = Input<TIn>::kStages * kStage + 2 * kTile;
};

// one k-step's context tile into ring slot `a` (kRows x kBK values, zeros
// past M rows and C channels)
template <typename TIn>
__device__ __forceinline__ void load_context(TIn* a, const TIn* dat, int row0, int k0, int M,
                                             int C, int vec, int tid) {
  constexpr int kPitch = Input<TIn>::kPitch;
  if (vec) {  // 16-byte chunks
    constexpr int kPerRow = kBK * (int)sizeof(TIn) / 16;  // 8 for f32, 2 for int8
    constexpr int kElems = 16 / (int)sizeof(TIn);
#pragma unroll
    for (int q = tid; q < kRows * kPerRow; q += kThreads) {
      const int r = q / kPerRow, c = (q % kPerRow) * kElems;
      const bool ok = row0 + r < M && k0 + c < C;
      const TIn* src = ok ? dat + (size_t)(row0 + r) * C + k0 + c : dat;
      cp_async16(a + r * kPitch + c, src, ok);
    }
  } else {  // element by element, stored at once
#pragma unroll
    for (int q = tid; q < kRows * kBK; q += kThreads) {
      const int r = q / kBK, c = q % kBK;
      const bool ok = row0 + r < M && k0 + c < C;
      a[r * kPitch + c] = ok ? dat[(size_t)(row0 + r) * C + k0 + c] : TIn(0);
    }
  }
}

// the weights of one k-step: kBK rows of NB floats, contiguous in the
// (n_col, ceil(C / kBK) * kBK, NB) layout of ops/fused_project.py::_prep
template <int NB>
__device__ __forceinline__ void load_weights(float* b, const float* w, int tid) {
#pragma unroll
  for (int q = tid; q < kBK * NB / 4; q += kThreads) cp_async16(b + 4 * q, w + 4 * q, true);
}

// a staged tile's half row (row tid % 128, channels (tid / 128) * 16 ..)
// into the channel-major f32 tile `out` [kBK][kRows], with its
// contribution to the row sums
__device__ __forceinline__ void stage_tile(const float* raw, float* out, int tid, float& st1,
                                           float& st2) {
  const int r = tid & (kRows - 1), c0 = (tid >> 7) * (kBK / 2);
  const float* p = raw + r * Input<float>::kPitch + c0;
#pragma unroll
  for (int h = 0; h < kBK / 8; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * h);
    st1 += (v.x + v.y) + (v.z + v.w);
    st2 = fmaf(v.x, v.x, st2);
    st2 = fmaf(v.y, v.y, st2);
    st2 = fmaf(v.z, v.z, st2);
    st2 = fmaf(v.w, v.w, st2);
    out[(c0 + 4 * h) * kRows + r] = v.x;
    out[(c0 + 4 * h + 1) * kRows + r] = v.y;
    out[(c0 + 4 * h + 2) * kRows + r] = v.z;
    out[(c0 + 4 * h + 3) * kRows + r] = v.w;
  }
}

// the same for int8: converted to f32 (exact), integer sums
__device__ __forceinline__ void stage_tile(const int8_t* raw, float* out, int tid, int& st1,
                                           int& st2) {
  const int r = tid & (kRows - 1), c0 = (tid >> 7) * (kBK / 2);
  union {
    uint4 u;
    int8_t q[16];
  } v;
  v.u = *reinterpret_cast<const uint4*>(raw + r * Input<int8_t>::kPitch + c0);
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int q = v.q[e];
    st1 += q;
    st2 += q * q;
    out[(c0 + e) * kRows + r] = static_cast<float>(q);
  }
}

// one k of a thread's microtile operands: its 8 rows' context values (two
// 128-bit loads) and its TN columns' weights (4 G by 128-bit loads, X more
// by one 32-bit load)
template <int G, int X, int NB>
__device__ __forceinline__ void load_frag(float (&av)[8], float (&bv)[4 * G + X], const float* a,
                                          const float* b, int k, int tx, int ty) {
  const float4 lo = *reinterpret_cast<const float4*>(a + k * kRows + 4 * ty);
  const float4 hi = *reinterpret_cast<const float4*>(a + k * kRows + 64 + 4 * ty);
  av[0] = lo.x;
  av[1] = lo.y;
  av[2] = lo.z;
  av[3] = lo.w;
  av[4] = hi.x;
  av[5] = hi.y;
  av[6] = hi.z;
  av[7] = hi.w;
  const float* brow = b + k * NB;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float4 v = *reinterpret_cast<const float4*>(brow + 4 * (tx + 16 * g));
    bv[4 * g] = v.x;
    bv[4 * g + 1] = v.y;
    bv[4 * g + 2] = v.z;
    bv[4 * g + 3] = v.w;
  }
  if constexpr (X == 1) bv[4 * G] = brow[64 * G + tx];
}

// G float4 column groups of 64 columns and X (0 or 1) extra columns a
// thread: NB = 64 G + 16 X
template <typename TIn, int G, int X>
__global__ void __launch_bounds__(kThreads, 1)
    project_f32(const TIn* __restrict__ dat, const float* __restrict__ w,
                const float* __restrict__ encp, const float* __restrict__ encs,
                const float* __restrict__ aux, const float* __restrict__ scale,
                float* __restrict__ kv, float* __restrict__ s1_out, float* __restrict__ s2_out,
                int M, int C, int F, int T, float d_total, float eps, int vec) {
  using In = Input<TIn>;
  using Acc = typename In::Acc;
  constexpr int NB = 64 * G + 16 * X, TN = 4 * G + X, S = In::kStages;
  using L = Layout<TIn, NB>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float row_mu[kRows], row_inv[kRows], row_sc[kRows];
  __shared__ Acc half_sums[2][2][kRows];  // [half][s1, s2][row]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);
  const int row0 = blockIdx.x * kRows, col0 = blockIdx.y * NB;
  const int nk = (C + kBK - 1) / kBK;
  const float* wp = w + (size_t)blockIdx.y * nk * kBK * NB;
  auto slot_a = [&](int s) { return reinterpret_cast<TIn*>(smem + (s % S) * L::kStage); };
  auto slot_b = [&](int s) {
    return reinterpret_cast<float*>(smem + (s % S) * L::kStage + L::kA);
  };
  auto tile = [&](int s) {
    return reinterpret_cast<float*>(smem + S * L::kStage + (s & 1) * L::kTile);
  };

  auto issue = [&](int s) {
    if (s < nk) {
      load_context(slot_a(s), dat, row0, s * kBK, M, C, vec, tid);
      load_weights<NB>(slot_b(s), wp + (size_t)s * kBK * NB, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the counts even
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  Acc st1 = 0, st2 = 0;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);
  cp_async_wait<S - 2>();
  __syncthreads();
  stage_tile(slot_a(0), tile(0), tid, st1, st2);

  for (int s = 0; s < nk; ++s) {
    // step s + 1 has landed, and step s's tile is staged
    cp_async_wait<S - 3>();
    __syncthreads();
    issue(s + S - 1);  // into the slot step s - 1 used
    if (s + 1 < nk) stage_tile(slot_a(s + 1), tile(s + 1), tid, st1, st2);
    const float* a = tile(s);
    const float* b = slot_b(s);
    // the operands of k + kAhead are loaded before the products of k, so
    // the shared-memory loads run under the FMAs of the channels before
    constexpr int kAhead = 2, kBufs = kAhead + 1;
    float av[kBufs][8], bv[kBufs][TN];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) load_frag<G, X, NB>(av[k], bv[k], a, b, k, tx, ty);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      if (k + kAhead < kBK)
        load_frag<G, X, NB>(av[(k + kAhead) % kBufs], bv[(k + kAhead) % kBufs], a, b, k + kAhead,
                            tx, ty);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(av[k % kBufs][i], bv[k % kBufs][j], acc[i][j]);
    }
  }

  // the row statistics: the two half rows' sums, rescaled, plus the encoding's
  half_sums[tid >> 7][0][tid & (kRows - 1)] = st1;
  half_sums[tid >> 7][1][tid & (kRows - 1)] = st2;
  __syncthreads();
  if (tid < kRows) {
    const int r = row0 + tid;
    float mu = 0.f, inv = 0.f, sc = 1.f;
    if (r < M) {
      const int tok = r % T;
      float a1 = static_cast<float>(half_sums[0][0][tid] + half_sums[1][0][tid]);
      float a2 = static_cast<float>(half_sums[0][1][tid] + half_sums[1][1][tid]);
      if (In::kQuant) {
        sc = scale[r];
        a1 = sc * a1;
        a2 = sc * sc * a2;
      }
      const float s1 = a1 + encs[tok], s2 = a2 + encs[T + tok];
      if (blockIdx.y == 0) {
        s1_out[r] = s1;
        s2_out[r] = s2;
      }
      mu = s1 / d_total;
      inv = rsqrtf(s2 / d_total - mu * mu + eps);
    }
    row_mu[tid] = mu;
    row_inv[tid] = inv;
    row_sc[tid] = sc;
  }
  __syncthreads();

  const bool vec_out = (F & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lr = (i < 4 ? 0 : 64) + 4 * ty + (i & 3), r = row0 + lr;
    if (r >= M) continue;
    const float mu = row_mu[lr], inv = row_inv[lr], sc = row_sc[lr];
    const float* ep = encp + (size_t)(r % T) * F;
    float* out = kv + (size_t)r * F;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = col0 + (j < 4 * G ? 4 * (tx + 16 * (j / 4)) + j % 4 : 64 * G + tx);
      if (vec_out && j < 4 * G) {  // a float4 of columns n .. n + 3, whole or not at all
        if (j % 4 != 0 || n >= F) continue;
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = In::kQuant ? __fmul_rn(acc[i][j + e], sc) : acc[i][j + e];
          o[e] = inv * ((x + ep[n + e]) - mu * aux[n + e]) + aux[F + n + e];
        }
        *reinterpret_cast<float4*>(out + n) = make_float4(o[0], o[1], o[2], o[3]);
      } else if (n < F) {
        const float x = In::kQuant ? __fmul_rn(acc[i][j], sc) : acc[i][j];
        out[n] = inv * ((x + ep[n]) - mu * aux[n]) + aux[F + n];
      }
    }
  }
}

template <typename TIn, int G, int X>
cudaError_t launch(const void* dat, const float* w, const float* encp, const float* encs,
                   const float* aux, const float* scale, float* kv, float* s1, float* s2, int M,
                   int C, int F, int T, float d_total, float eps, int n_col, int vec,
                   cudaStream_t st) {
  constexpr int bytes = Layout<TIn, 64 * G + 16 * X>::kBytes;
  auto kernel = project_f32<TIn, G, X>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kRows - 1) / kRows, n_col);
  kernel<<<grid, kThreads, bytes, st>>>(static_cast<const TIn*>(dat), w, encp, encs, aux, scale,
                                        kv, s1, s2, M, C, F, T, d_total, eps, vec);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t launch_width(int nb, const void* dat, const float* w, const float* encp,
                         const float* encs, const float* aux, const float* scale, float* kv,
                         float* s1, float* s2, int M, int C, int F, int T, float d_total,
                         float eps, int n_col, int vec, cudaStream_t st) {
  switch (nb) {
    case 64:
      return launch<TIn, 1, 0>(dat, w, encp, encs, aux, scale, kv, s1, s2, M, C, F, T, d_total,
                               eps, n_col, vec, st);
    case 128:
      return launch<TIn, 2, 0>(dat, w, encp, encs, aux, scale, kv, s1, s2, M, C, F, T, d_total,
                               eps, n_col, vec, st);
    case 256:
      return launch<TIn, 4, 0>(dat, w, encp, encs, aux, scale, kv, s1, s2, M, C, F, T, d_total,
                               eps, n_col, vec, st);
    case 272:
      return launch<TIn, 4, 1>(dat, w, encp, encs, aux, scale, kv, s1, s2, M, C, F, T, d_total,
                               eps, n_col, vec, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory bytes of a block of the f32 route (checked against
// ops/fused_project.py::project_f32_plan by chip_smoke.py).
extern "C" int healnet_fused_project_f32_smem(int nb, int is_int8) {
  switch (nb * 2 + (is_int8 ? 1 : 0)) {
    case 128: return Layout<float, 64>::kBytes;
    case 129: return Layout<int8_t, 64>::kBytes;
    case 256: return Layout<float, 128>::kBytes;
    case 257: return Layout<int8_t, 128>::kBytes;
    case 512: return Layout<float, 256>::kBytes;
    case 513: return Layout<int8_t, 256>::kBytes;
    case 544: return Layout<float, 272>::kBytes;
    case 545: return Layout<int8_t, 272>::kBytes;
    default: return -1;
  }
}

// dat: (M, C) f32, or int8 with scale (M,); w: (n_col, ceil(C / 32) * 32,
// nb) f32, zero-padded; encp (T, F) f32; encs (2, T); aux (2, F); kv (M, F)
// f32; vec: 16-byte staging (rows and base on 16 bytes), else element loads.
extern "C" int healnet_fused_project_f32(const void* dat, const float* w, const float* encp,
                                         const float* encs, const float* aux, const float* scale,
                                         float* kv, float* s1, float* s2, int M, int C, int F,
                                         int T, float d_total, float eps, int is_int8, int nb,
                                         int n_col, int vec, void* stream) {
  if (M <= 0 || F <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_int8 ? launch_width<int8_t>(nb, dat, w, encp, encs, aux, scale, kv, s1, s2, M, C, F, T,
                                     d_total, eps, n_col, vec, st)
              : launch_width<float>(nb, dat, w, encp, encs, aux, nullptr, kv, s1, s2, M, C, F,
                                    T, d_total, eps, n_col, vec, st);
  return static_cast<int>(e);
}

extern "C" const char* healnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
