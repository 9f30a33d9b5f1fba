// Shared helpers for the hand-written Hopper kernels: element-type
// conversion, and the rounding points the kernels share with the model.
//
// Every kernel takes its tensors in the model dtype (float32 or bfloat16,
// selected by `dtype_code`: 0 = float32, 1 = bfloat16), computes in float32
// and rounds with round-to-nearest-even where the model rounds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace csof {
namespace {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded through the model dtype and back (identity for float32)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copies to shared memory (cp.async, L2 only); with
// valid false the 16 bytes are zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// P values of shared (or global) memory as float32 (one vector load), and P float32
// values to the dtype (one vector store; bf16 rounds to nearest even)
template <int P>
__device__ __forceinline__ void load_p(const float* p, float* v) {
  static_assert(P == 4, "float32: 16 bytes");
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
template <int P>
__device__ __forceinline__ void load_p(const __nv_bfloat16* p, float* v) {
  static_assert(P == 4 || P == 8, "bf16: 8 or 16 bytes");
  uint32_t w[P / 2];
  if constexpr (P == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
  } else {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x, w[1] = t.y;
  }
#pragma unroll
  for (int k = 0; k < P / 2; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}
template <int P>
__device__ __forceinline__ void store_p(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat16 a = __float2bfloat16_rn(lo), b = __float2bfloat16_rn(hi);
  return *reinterpret_cast<const uint16_t*>(&a) |
         (uint32_t(*reinterpret_cast<const uint16_t*>(&b)) << 16);
}
template <int P>
__device__ __forceinline__ void store_p(__nv_bfloat16* p, const float* v) {
  if constexpr (P == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                              bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace
}  // namespace csof
