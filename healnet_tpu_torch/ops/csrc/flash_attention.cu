// Flash cross-attention forward: online softmax over KV tiles, with the
// scale/temperature folded in, a float key mask, and coordinate-hash dropout
// on the normalised probabilities.
//
// Replaces: healnet_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas
// kernel launched by _fwd_call). Forward only.
//
// Semantics kept from the TPU kernel:
//   - a masked key scores s * scale - 1e30 and its probability is multiplied
//     by the mask, so a fully masked tile contributes exactly zero;
//   - the softmax denominator is taken before dropout; dropout multiplies the
//     probability by keep / (1 - rate), keep from hash_keep over the absolute
//     coordinates (batch*head row, query, key);
//   - probabilities are rounded to the value dtype before the product with V;
//   - the output divides by max(l, 1e-30): a row whose keys are all masked
//     outputs 0. The per-row log-sum-exp is written beside the output.
//
// Bound on an H100 SXM at the serving shape (b*h = 8, lq = 17, lkv = 4096,
// d = 63, bf16): 8.3 MB of K and V, about 2.5 us at 3.35 TB/s, against
// 0.14 GFLOP. So nothing in the work itself is slow: the kernel is bound by
// latency and occupancy, because 8 (batch*head) rows are far fewer than the
// 132 SMs. The design splits the keys of each row over blocks (grid = rows x
// splits, chosen by the caller to put two blocks on every SM), each block
// keeping its own (m, l, acc) in shared memory, and a second small kernel
// merges the splits (flash-decoding). K and V arrive as strided column slices
// of the merged KV buffer (element offsets 0, 63, 126, 189 with row stride
// 252 in bf16, not 16-byte aligned), so they are loaded element by element
// with their strides and no copy is made. Scores and the value product run
// as f32 FMA from shared memory: lq = 17 and d = 63 are far from tensor-core
// tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_dropout.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // keys per tile: one per lane in the softmax step
constexpr float kNegBig = -1e30f;

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;  // (B, lkv) or null
  float* part_acc;    // (B*H, n_split, lq, d)
  float* part_ml;     // (B*H, n_split, 2, lq)
  void* out;          // (B, lq, H, d)
  float* lse;         // (B*H, lq)
  int H, lq, lkv, d, n_split, split_len;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, mask_sb;
  float scale;
  int dropout;
  uint32_t seed, threshold;
  float keep_scale;
};

__host__ __device__ inline int key_pitch(int d) { return (d & 1) ? d : d + 1; }

__host__ inline size_t split_smem_bytes(int lq, int d) {
  return sizeof(float) *
         (size_t)(2 * lq * d + kTile * key_pitch(d) + kTile * d + lq * kTile + kTile + 3 * lq);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_split(Params p) {
  extern __shared__ float smem[];
  const int lq = p.lq, d = p.d, kp = key_pitch(d);
  float* qs = smem;              // lq * d
  float* acc = qs + lq * d;      // lq * d
  float* ks = acc + lq * d;      // kTile * kp
  float* vs = ks + kTile * kp;   // kTile * d
  float* ps = vs + kTile * d;    // lq * kTile
  float* mk = ps + lq * kTile;   // kTile
  float* m_s = mk + kTile;       // lq
  float* l_s = m_s + lq;         // lq
  float* c_s = l_s + lq;         // lq

  const int row = blockIdx.x, split = blockIdx.y;
  const int b = row / p.H, h = row - (row / p.H) * p.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* mask = p.mask ? p.mask + b * p.mask_sb : nullptr;
  const int kv_begin = split * p.split_len;
  const int kv_end = min(p.lkv, kv_begin + p.split_len);

  for (int i = tid; i < lq * d; i += kThreads) {
    const int qi = i / d, dd = i - qi * d;
    qs[i] = to_float(q[qi * p.q_st + dd]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < lq; i += kThreads) {
    m_s[i] = kNegBig;
    l_s[i] = 0.f;
  }
  __syncthreads();

  for (int k0 = kv_begin; k0 < kv_end; k0 += kTile) {
    // one key row per warp, lanes along d: coalesced reads, no division
    for (int j = warp; j < kTile; j += kWarps) {
      const int key = k0 + j;
      const bool ok = key < kv_end;
      const T* kr = k + (ok ? key : 0) * p.k_st;
      const T* vr = v + (ok ? key : 0) * p.v_st;
      for (int dd = lane; dd < d; dd += 32) {
        ks[j * kp + dd] = ok ? to_float(kr[dd]) : 0.f;
        vs[j * d + dd] = ok ? to_float(vr[dd]) : 0.f;
      }
    }
    if (tid < kTile) {
      const int key = k0 + tid;
      mk[tid] = key < kv_end ? (mask ? mask[key] : 1.f) : 0.f;
    }
    __syncthreads();

    // scores: one (query, key) pair per thread and step
    for (int i = tid; i < lq * kTile; i += kThreads) {
      const int qi = i / kTile, j = i - qi * kTile;
      const float* qr = qs + qi * d;
      const float* kr = ks + j * kp;
      float s = 0.f;
      for (int dd = 0; dd < d; ++dd) s = fmaf(qr[dd], kr[dd], s);
      ps[i] = s * p.scale + (mk[j] - 1.f) * 1e30f;
    }
    __syncthreads();

    // online softmax: one warp per query row, one key per lane
    for (int qi = warp; qi < lq; qi += kWarps) {
      const float s = ps[qi * kTile + lane];
      float m_cur = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      const float m_prev = m_s[qi];
      const float m_new = fmaxf(m_prev, m_cur);
      float pr = expf(s - m_new) * mk[lane];
      float psum = pr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = expf(m_prev - m_new);
      if (p.dropout) {
        const bool keep = healnet::hash_keep(p.seed, (uint32_t)row, (uint32_t)qi,
                                             (uint32_t)(k0 + lane), p.threshold);
        pr *= keep ? p.keep_scale : 0.f;
      }
      ps[qi * kTile + lane] = to_float(from_float<T>(pr));
      __syncwarp();
      if (lane == 0) {
        m_s[qi] = m_new;
        l_s[qi] = l_s[qi] * corr + psum;
        c_s[qi] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V
    for (int i = tid; i < lq * d; i += kThreads) {
      const int qi = i / d, dd = i - qi * d;
      const float* pr = ps + qi * kTile;
      float a = acc[i] * c_s[qi];
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) a = fmaf(pr[j], vs[j * d + dd], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  const size_t part = (size_t)row * p.n_split + split;
  for (int i = tid; i < lq * d; i += kThreads) p.part_acc[part * lq * d + i] = acc[i];
  for (int i = tid; i < lq; i += kThreads) {
    p.part_ml[part * 2 * lq + i] = m_s[i];
    p.part_ml[part * 2 * lq + lq + i] = l_s[i];
  }
}

// Merges the splits of each row: rescale every split to the row maximum,
// sum, divide by max(l, 1e-30), write (B, lq, H, d) and the log-sum-exp.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_combine(Params p) {
  const int row = blockIdx.x;
  const int b = row / p.H, h = row - (row / p.H) * p.H;
  const int lq = p.lq, d = p.d, S = p.n_split;
  const float* ml = p.part_ml + (size_t)row * S * 2 * lq;
  const float* pa = p.part_acc + (size_t)row * S * lq * d;
  T* out = static_cast<T*>(p.out);
  for (int i = threadIdx.x; i < lq * d; i += kThreads) {
    const int qi = i / d, dd = i - qi * d;
    float m = kNegBig;
    for (int s = 0; s < S; ++s) m = fmaxf(m, ml[s * 2 * lq + qi]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < S; ++s) {
      const float wgt = expf(ml[s * 2 * lq + qi] - m);
      l += ml[s * 2 * lq + lq + qi] * wgt;
      a += pa[((size_t)s * lq + qi) * d + dd] * wgt;
    }
    const float lc = fmaxf(l, 1e-30f);
    out[((size_t)(b * lq + qi) * p.H + h) * d + dd] = from_float<T>(a / lc);
    if (dd == 0) p.lse[(size_t)row * lq + qi] = m + logf(lc);
  }
}

template <typename T>
cudaError_t launch(const Params& p, int rows, cudaStream_t s) {
  const size_t smem = split_smem_bytes(p.lq, p.d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_split<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  flash_fwd_split<T><<<dim3(rows, p.n_split), kThreads, smem, s>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_fwd_combine<T><<<rows, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long healnet_flash_smem_bytes(int lq, int d) {
  return (long long)split_smem_bytes(lq, d);
}

extern "C" int healnet_flash_forward(
    const void* q, const void* k, const void* v, const float* mask, float* part_acc,
    float* part_ml, void* out, float* lse, int B, int H, int lq, int lkv, int d, int n_split,
    int split_len, long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh, long long v_st,
    long long mask_sb, float scale, int dropout, unsigned int seed, unsigned int threshold,
    float keep_scale, int is_bf16, void* stream) {
  if (B * H <= 0 || lq <= 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.part_acc = part_acc;
  p.part_ml = part_ml;
  p.out = out;
  p.lse = lse;
  p.H = H;
  p.lq = lq;
  p.lkv = lkv;
  p.d = d;
  p.n_split = n_split;
  p.split_len = split_len;
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
  const cudaError_t e = is_bf16 ? launch<__nv_bfloat16>(p, B * H, s) : launch<float>(p, B * H, s);
  return static_cast<int>(e);
}

extern "C" const char* healnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
