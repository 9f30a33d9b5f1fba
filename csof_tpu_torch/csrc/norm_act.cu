// K5: InstanceNorm + affine + LeakyReLU over each (n, c) plane of an NCHW
// tensor, forward only.
//
//   mean = sum(x) / HW,  var = sum(x^2) / HW - mean^2     float32, no clamp
//   y    = (x - mean) * rsqrt(var + eps) * scale[c] + bias[c]
//   out  = y >= 0 ? y : slope * y                          float32, one rounding
//
// Replaces the TPU kernel csof_tpu/ops/pallas/norm_act.py
// instance_norm_leaky_relu_pallas / _norm_act_kernel, with its numerics: the
// statistics as float32 sums of x (E[x^2] - mean^2, not the two-pass
// variance of the module path), the affine and the slope applied in float32,
// and one rounding to x's dtype at the end.
//
// What bounds it on the H100: bytes. It does about 7 operations an element
// and must read x once and write the output once. The TPU kernel keeps a
// whole (H, W) plane in VMEM; a Hopper block has at most 227 KB of shared
// memory and the U-Net's largest plane is 320 KB in float32, so this first
// version reads x twice:
//   - planes of at most kSmallMax elements (the U-Net's levels >= 3): one
//     warp owns a plane, eight planes a block; it sums, then normalizes the
//     plane it just read (the second read comes from L1/L2);
//   - larger planes: pass 1 splits each plane into kChunk-element chunks, and
//     a block writes one (sum, sum of squares) partial per chunk; pass 2
//     re-reduces the plane's partials in a fixed order and normalizes its
//     chunk.
// Every sum is taken in a fixed order (no float atomics): the result does
// not change from run to run.
#include "common.cuh"

namespace csof {
namespace {

constexpr int kThreads = 256;
constexpr int kSmallMax = 4096;  // planes up to this size: one warp each
constexpr int kChunk = 4096;     // elements per block of the large-plane passes

__device__ __forceinline__ float norm_act_value(float v, float mean, float inv, float a, float b,
                                                float slope) {
  float y = (v - mean) * inv;
  y = y * a + b;
  return y >= 0.f ? y : slope * y;
}

// grid ceil(planes / 8), block 256: warp w of block k owns plane 8k + w
template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_act_small_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ out, int planes, int C,
                      int HW, float eps, float slope) {
  const int plane = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (plane >= planes) return;  // whole warps leave: the shuffles below stay full
  const T* px = x + (size_t)plane * HW;
  float s1 = 0.f, s2 = 0.f;
  for (int i = lane; i < HW; i += 32) {
    const float v = to_float(px[i]);
    s1 += v;
    s2 += v * v;
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mean = s1 / (float)HW;
  const float inv = rsqrtf(s2 / (float)HW - mean * mean + eps);
  const int c = plane % C;
  const float a = scale[c], b = bias[c];
  T* po = out + (size_t)plane * HW;
  for (int i = lane; i < HW; i += 32)
    po[i] = from_float<T>(norm_act_value(to_float(px[i]), mean, inv, a, b, slope));
}

// grid (chunks, planes), block 256.  partial: (planes, chunks, 2) float32
template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_act_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int HW) {
  __shared__ float red[kThreads / 32][2];
  const int chunk = blockIdx.x, plane = blockIdx.y, chunks = gridDim.x;
  const int start = chunk * kChunk, stop = min(start + kChunk, HW);
  const T* px = x + (size_t)plane * HW;
  float s1 = 0.f, s2 = 0.f;
  for (int i = start + threadIdx.x; i < stop; i += kThreads) {
    const float v = to_float(px[i]);
    s1 += v;
    s2 += v * v;
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[warp][0] = s1;
    red[warp][1] = s2;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][threadIdx.x];
    partial[((size_t)plane * chunks + chunk) * 2 + threadIdx.x] = s;
  }
}

// grid (chunks, planes), block 256
template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_act_apply_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      T* __restrict__ out, int C, int HW, float eps, float slope) {
  __shared__ float stats[2];
  const int chunk = blockIdx.x, plane = blockIdx.y, chunks = gridDim.x;
  if (threadIdx.x < 32) {
    const float* pp = partial + (size_t)plane * chunks * 2;
    float s1 = 0.f, s2 = 0.f;
    for (int k = threadIdx.x; k < chunks; k += 32) {
      s1 += pp[2 * k];
      s2 += pp[2 * k + 1];
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (threadIdx.x == 0) {
      const float mean = s1 / (float)HW;
      stats[0] = mean;
      stats[1] = rsqrtf(s2 / (float)HW - mean * mean + eps);
    }
  }
  __syncthreads();
  const float mean = stats[0], inv = stats[1];
  const int c = plane % C;
  const float a = scale[c], b = bias[c];
  const size_t base = (size_t)plane * HW;
  const int start = chunk * kChunk, stop = min(start + kChunk, HW);
  for (int i = start + threadIdx.x; i < stop; i += kThreads)
    out[base + i] = from_float<T>(norm_act_value(to_float(x[base + i]), mean, inv, a, b, slope));
}

template <typename T>
cudaError_t launch_norm_act(const T* x, const float* scale, const float* bias, T* out,
                            float* partial, int planes, int C, int HW, float eps, float slope,
                            cudaStream_t stream) {
  if (HW <= kSmallMax) {
    const int per_block = kThreads / 32;
    norm_act_small_kernel<T><<<(planes + per_block - 1) / per_block, kThreads, 0, stream>>>(
        x, scale, bias, out, planes, C, HW, eps, slope);
    return cudaGetLastError();
  }
  const dim3 grid((HW + kChunk - 1) / kChunk, planes);
  norm_act_stats_kernel<T><<<grid, kThreads, 0, stream>>>(x, partial, HW);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  norm_act_apply_kernel<T><<<grid, kThreads, 0, stream>>>(x, partial, scale, bias, out, C, HW,
                                                         eps, slope);
  return cudaGetLastError();
}

}  // namespace
}  // namespace csof

// x, out: (N, C, H, W) contiguous in the dtype, planes = N * C, HW = H * W;
// scale, bias: (C,) float32. partial: (planes, ceil(HW / 4096), 2) float32
// scratch when HW > 4096, else unused (may be null).
extern "C" int csof_norm_act_forward(const void* x, const float* scale, const float* bias,
                                     void* out, float* partial, int planes, int C, int HW,
                                     float eps, float slope, int dtype_code, void* stream) {
  using namespace csof;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes <= 0 || C <= 0 || HW <= 0 || planes % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (HW > kSmallMax && (partial == nullptr || planes > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype_code == kFloat32) {
    e = launch_norm_act(static_cast<const float*>(x), scale, bias, static_cast<float*>(out),
                        partial, planes, C, HW, eps, slope, s);
  } else if (dtype_code == kBFloat16) {
    using bf = __nv_bfloat16;
    e = launch_norm_act(static_cast<const bf*>(x), scale, bias, static_cast<bf*>(out), partial,
                        planes, C, HW, eps, slope, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
