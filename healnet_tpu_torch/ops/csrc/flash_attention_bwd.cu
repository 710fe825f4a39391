// Flash cross-attention backward: dq, dk, dv from the forward's per-row
// log-sum-exp and delta = rowsum(dO * O), with the key mask and the
// coordinate-hash dropout regenerated over the forward's coordinates.
//
// Replaces: healnet_tpu/ops/flash_attention.py::_bwd_kernel (the Pallas
// kernel launched by _bwd_call).
//
// Per row r = (batch, head), query i, key j, with e_ij = keep_ij / (1 - rate)
// (1 without dropout) and the same f32 arithmetic as the TPU kernel:
//   s_ij  = (q_i . k_j) * scale - 1e30 * (1 - mask_j)
//   p_ij  = exp(s_ij - lse_i) * mask_j        (denominator from the forward)
//   dv_j  = sum_i round_T(p_ij * e_ij) * dO_i
//   ds_ij = round_T(p_ij * (e_ij * (v_j . dO_i) - delta_i))
//   dk_j  = scale * sum_i ds_ij * q_i,   dq_i = scale * sum_j ds_ij * k_j
// A fully masked row has lse = -1e30 and p = 0: its dq is 0 and it adds
// nothing to dk or dv.
//
// Bound on an H100 SXM at the training shape (b*h = 8, lq = 17, lkv = 4096,
// d = 63, bf16): reading k and v and writing dk and dv moves 16.5 MB, about
// 5 us at 3.35 TB/s, against about 0.28 GFLOP. As in the forward, eight
// (batch*head) rows are far fewer than the 132 SMs, so the keys of each row
// are split over blocks (grid = rows x splits, two blocks per SM). A block
// owns its keys outright: it writes their dk and dv directly, and keeps a
// partial dq for its keys in shared memory, which it writes to a
// (rows, splits, lq, d) f32 buffer. A second kernel sums those partials in
// split order, so the result does not depend on scheduling and no float
// atomics are used. K and V are the strided column slices of the merged KV
// buffer (row stride 252 in bf16, not 16-byte aligned) and are loaded
// element by element with their strides, one key row per warp. The products
// run as f32 FMA from shared memory: lq = 17 and d = 63 are far from
// tensor-core tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_dropout.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // keys per tile
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
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;   // (B, lkv) or null
  const void* dout;    // (B, H, lq, d), strided
  const float* lse;    // (B*H, lq)
  const float* delta;  // (B*H, lq)
  float* part_dq;      // (B*H, n_split, lq, d)
  void* dq;            // (B, H, lq, d) contiguous
  void* dk;            // (B, H, lkv, d) contiguous
  void* dv;            // (B, H, lkv, d) contiguous
  int H, lq, lkv, d, n_split, split_len;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st, mask_sb;
  float scale;
  int dropout;
  uint32_t seed, threshold;
  float keep_scale;
};

// odd pitch: lanes reading one column of consecutive key rows hit distinct banks
__host__ __device__ inline int key_pitch(int d) { return (d & 1) ? d : d + 1; }

__host__ inline size_t bwd_smem_bytes(int lq, int d) {
  return sizeof(float) * (size_t)(3 * lq * d + 2 * kTile * key_pitch(d) + 2 * lq * kTile +
                                  kTile + 2 * lq);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_split(Params p) {
  extern __shared__ float smem[];
  const int lq = p.lq, d = p.d, kp = key_pitch(d);
  float* qs = smem;               // lq * d
  float* dos = qs + lq * d;       // lq * d
  float* dqa = dos + lq * d;      // lq * d: this split's partial dq
  float* ks = dqa + lq * d;       // kTile * kp
  float* vs = ks + kTile * kp;    // kTile * kp
  float* pd = vs + kTile * kp;    // lq * kTile: round_T(p * e)
  float* dss = pd + lq * kTile;   // lq * kTile: round_T(ds)
  float* mk = dss + lq * kTile;   // kTile
  float* lse_s = mk + kTile;      // lq
  float* del_s = lse_s + lq;      // lq

  const int row = blockIdx.x, split = blockIdx.y;
  const int b = row / p.H, h = row - (row / p.H) * p.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* mask = p.mask ? p.mask + b * p.mask_sb : nullptr;
  T* dk = static_cast<T*>(p.dk) + (size_t)row * p.lkv * d;
  T* dv = static_cast<T*>(p.dv) + (size_t)row * p.lkv * d;
  const int kv_begin = split * p.split_len;
  const int kv_end = min(p.lkv, kv_begin + p.split_len);

  for (int i = tid; i < lq * d; i += kThreads) {
    const int qi = i / d, dd = i - qi * d;
    qs[i] = to_float(q[qi * p.q_st + dd]);
    dos[i] = to_float(dout[qi * p.o_st + dd]);
    dqa[i] = 0.f;
  }
  for (int i = tid; i < lq; i += kThreads) {
    lse_s[i] = p.lse[(size_t)row * lq + i];
    del_s[i] = p.delta[(size_t)row * lq + i];
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    // one key row per warp, lanes along d: coalesced reads, no division
    for (int j = warp; j < kTile; j += kWarps) {
      const int key = k0 + j;
      const bool ok = key < kv_end;
      const T* kr = k + (ok ? key : 0) * p.k_st;
      const T* vr = v + (ok ? key : 0) * p.v_st;
      for (int dd = lane; dd < d; dd += 32) {
        ks[j * kp + dd] = ok ? to_float(kr[dd]) : 0.f;
        vs[j * kp + dd] = ok ? to_float(vr[dd]) : 0.f;
      }
    }
    if (tid < kTile) {
      const int key = k0 + tid;
      mk[tid] = key < kv_end ? (mask ? mask[key] : 1.f) : 0.f;
    }
    __syncthreads();

    // probabilities and score gradients: one (query, key) pair per thread
    for (int i = tid; i < lq * kTile; i += kThreads) {
      const int qi = i / kTile, j = i - qi * kTile;
      const float* qr = qs + qi * d;
      const float* orow = dos + qi * d;
      const float* kr = ks + j * kp;
      const float* vr = vs + j * kp;
      float s = 0.f, dp = 0.f;
      for (int dd = 0; dd < d; ++dd) {
        s = fmaf(qr[dd], kr[dd], s);
        dp = fmaf(orow[dd], vr[dd], dp);
      }
      s = s * p.scale + (mk[j] - 1.f) * 1e30f;
      const float pr = expf(s - lse_s[qi]) * mk[j];
      float e = 1.f;
      if (p.dropout) {
        const bool keep = healnet::hash_keep(p.seed, (uint32_t)row, (uint32_t)qi,
                                             (uint32_t)(k0 + j), p.threshold);
        e = keep ? p.keep_scale : 0.f;
      }
      pd[i] = round_to<T>(pr * e);
      dss[i] = round_to<T>(pr * (dp * e - del_s[qi]));
    }
    __syncthreads();

    // dv_j = sum_i pd_ij dO_i and dk_j = scale * sum_i ds_ij q_i, written out
    const int n_keys = min(kTile, kv_end - k0);
    for (int i = tid; i < n_keys * d; i += kThreads) {
      const int j = i / d, dd = i - j * d;
      float a = 0.f, c = 0.f;
      for (int qi = 0; qi < lq; ++qi) {
        a = fmaf(pd[qi * kTile + j], dos[qi * d + dd], a);
        c = fmaf(dss[qi * kTile + j], qs[qi * d + dd], c);
      }
      const size_t off = (size_t)(k0 + j) * d + dd;
      dv[off] = from_float<T>(a);
      dk[off] = from_float<T>(c * p.scale);
    }
    // dq_i += sum_j ds_ij k_j (scaled once, in the merge)
    for (int i = tid; i < lq * d; i += kThreads) {
      const int qi = i / d, dd = i - qi * d;
      const float* dr = dss + qi * kTile;
      float a = dqa[i];
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) a = fmaf(dr[j], ks[j * kp + dd], a);
      dqa[i] = a;
    }
  }
  __syncthreads();

  float* part = p.part_dq + ((size_t)row * p.n_split + split) * lq * d;
  for (int i = tid; i < lq * d; i += kThreads) part[i] = dqa[i];
}

// Sums each row's partial dq over the splits in split order, scales, and
// writes (B, H, lq, d).
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_merge(Params p) {
  const int row = blockIdx.x;
  const int n = p.lq * p.d;
  const float* part = p.part_dq + (size_t)row * p.n_split * n;
  T* dq = static_cast<T*>(p.dq) + (size_t)row * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float a = 0.f;
    for (int s = 0; s < p.n_split; ++s) a += part[(size_t)s * n + i];
    dq[i] = from_float<T>(a * p.scale);
  }
}

template <typename T>
cudaError_t launch(const Params& p, int rows, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes(p.lq, p.d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_split<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  flash_bwd_split<T><<<dim3(rows, p.n_split), kThreads, smem, s>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_merge<T><<<rows, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long healnet_flash_bwd_smem_bytes(int lq, int d) {
  return (long long)bwd_smem_bytes(lq, d);
}

extern "C" int healnet_flash_backward(
    const void* q, const void* k, const void* v, const float* mask, const void* dout,
    const float* lse, const float* delta, float* part_dq, void* dq, void* dk, void* dv, int B,
    int H, int lq, int lkv, int d, int n_split, int split_len, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long o_sb, long long o_sh, long long o_st,
    long long mask_sb, float scale, int dropout, unsigned int seed, unsigned int threshold,
    float keep_scale, int is_bf16, void* stream) {
  if (B * H <= 0 || lq <= 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.part_dq = part_dq;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
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
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_st = o_st;
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
