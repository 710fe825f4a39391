// Coordinate-hash dropout keep decision, as a device function.
//
// Replaces the JAX package's ops/hash_dropout.py::hash_keep / _mix32, which
// the TPU kernels inline. The keep decision is a pure function of the seed
// and the element's absolute coordinates (batch*head row, query index, key
// index), so every kernel and the plain PyTorch version
// (healnet_tpu_torch/ops/hash_dropout.py) draw bit-identical masks for the
// same seed, whatever their tiling.
#pragma once

#include <stdint.h>

namespace healnet {

// splitmix32 / murmur3 finaliser constants (identical to the JAX package)
constexpr uint32_t kM1 = 0x7FEB352Du;
constexpr uint32_t kM2 = 0x846CA68Bu;
constexpr uint32_t kCRow = 0x9E3779B1u;
constexpr uint32_t kCQ = 0x85EBCA77u;
constexpr uint32_t kCKv = 0xC2B2AE3Du;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 15;
  x *= kM2;
  x ^= x >> 16;
  return x;
}

// True = keep; `threshold` is keep_threshold(rate) from the Python side.
__device__ __forceinline__ bool hash_keep(uint32_t seed, uint32_t row, uint32_t q,
                                          uint32_t kv, uint32_t threshold) {
  return mix32((row * kCRow) ^ (q * kCQ) ^ (kv * kCKv) ^ seed) < threshold;
}

}  // namespace healnet
