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
// whole (H, W) plane in VMEM between its statistics and its normalization;
// so does this one, in one launch a call, reading each plane from device
// memory once. Two paths, chosen by ops/kernels/norm_act.py norm_act_plan:
//   - planes of at most 4 KB (the U-Net's float32 levels >= 5, bf16 >= 4):
//     one warp owns a plane, eight planes a block; it sums, then normalizes
//     the plane it just read (the second read comes from L1);
//   - larger planes: a thread block cluster of `cluster` blocks (1, 2, 4 or
//     8; 1 is a plain block) owns a plane, each block a slice of `slice`
//     elements. A block copies its slice into shared memory with 16-byte
//     cp.async (element copies for a head and tail off the 16-byte grid, so
//     any size and alignment), sums it, and publishes its (sum, sum of
//     squares); after cluster.sync() every block reads the cluster's
//     partials through distributed shared memory (map_shared_rank) in rank
//     order, so all agree bit for bit, then normalizes its slice from shared
//     memory and writes it with 16-byte stores. The U-Net's 320 KB float32
//     planes are held by a cluster; a block's shared memory (227 KB) could
//     hold at most one.
// Every sum is taken in a fixed order (no float atomics): the result does
// not change from run to run.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cgs = cooperative_groups;

namespace csof {
namespace {

constexpr int kThreads = 256;
constexpr int kSmallMax = 4096;  // the most elements the warp path takes

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

// Shared memory a block asks for: its slice, shifted by up to one 16-byte
// group so that a 16-byte group of x lands on a 16-byte group of shared
// memory, in whole groups
template <typename T>
inline size_t plane_smem_bytes(int slice) {
  constexpr int G = 16 / sizeof(T);
  return ((size_t)(slice + G - 1) / G + 1) * 16;
}

// grid planes * cluster, block 256, clusters of `cluster` blocks along x:
// block rank k of cluster p owns elements [k * slice, (k + 1) * slice) of
// plane p. out_vec = 1 when out and x lie at the same offset from the
// 16-byte grid (16-byte stores), else 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_act_plane_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ out, int C, int HW,
                      int cluster, int slice, float eps, float slope, int out_vec) {
  constexpr int G = 16 / sizeof(T);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);
  __shared__ float red[kThreads / 32][2];
  __shared__ float part[2];  // this block's (sum, sum of squares); read by the cluster
  __shared__ float stats[2];
  const int tid = threadIdx.x;
  const int plane = blockIdx.x / cluster, rank = blockIdx.x % cluster;
  const int s0 = rank * slice;
  const int len = max(0, min(slice, HW - s0));
  const T* px = x + (size_t)plane * HW + s0;
  T* po = out + (size_t)plane * HW + s0;
  // element e of the slice sits at sx[mis + e], so 16-byte groups of x and
  // of shared memory coincide; the groups' ends outside the slice are zero
  const int mis = (int)((reinterpret_cast<uintptr_t>(px) / sizeof(T)) % G);
  const int ng = (mis + len + G - 1) / G;
  for (int gi = tid; gi < ng; gi += kThreads) {
    const int e0 = gi * G - mis;
    if (e0 >= 0 && e0 + G <= len) {
      cp_async16(smem_addr(sx + gi * G), px + e0);
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k)
        sx[gi * G + k] = e0 + k >= 0 && e0 + k < len ? px[e0 + k] : from_float<T>(0.f);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the slice's sums: thread t takes groups t, t + 256, ... in order, then
  // a butterfly over the warp, then the warps in order
  float s1 = 0.f, s2 = 0.f;
  for (int gi = tid; gi < ng; gi += kThreads) {
    float v[G];
    load_p<G>(sx + gi * G, v);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      s1 += v[k];
      s2 += v[k] * v[k];
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    red[warp][0] = s1;
    red[warp][1] = s2;
  }
  __syncthreads();
  if (tid < 2) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][tid];
    part[tid] = s;
    if (cluster == 1) stats[tid] = s;
  }
  if (cluster > 1) {
    cgs::cluster_group cl = cgs::this_cluster();
    cl.sync();  // every block's partials are published
    if (tid < 2) {
      float s = 0.f;
      for (int k = 0; k < cluster; ++k) s += cl.map_shared_rank(part, k)[tid];
      stats[tid] = s;
    }
    cl.sync();  // no block leaves (or moves on) while another reads its partials
  }
  __syncthreads();
  const float mean = stats[0] / (float)HW;
  const float inv = rsqrtf(stats[1] / (float)HW - mean * mean + eps);
  const int c = plane % C;
  const float a = scale[c], b = bias[c];

  for (int gi = tid; gi < ng; gi += kThreads) {
    const int e0 = gi * G - mis;
    float v[G];
    load_p<G>(sx + gi * G, v);
#pragma unroll
    for (int k = 0; k < G; ++k) v[k] = norm_act_value(v[k], mean, inv, a, b, slope);
    if (out_vec && e0 >= 0 && e0 + G <= len) {
      store_p<G>(po + e0, v);
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k)
        if (e0 + k >= 0 && e0 + k < len) po[e0 + k] = from_float<T>(v[k]);
    }
  }
}

template <typename T>
cudaError_t launch_norm_act(const T* x, const float* scale, const float* bias, T* out,
                            int planes, int C, int HW, int cluster, int slice, int smem,
                            float eps, float slope, cudaStream_t stream) {
  if (cluster == 0) {
    if (HW > kSmallMax) return cudaErrorInvalidValue;
    const int per_block = kThreads / 32;
    norm_act_small_kernel<T><<<(planes + per_block - 1) / per_block, kThreads, 0, stream>>>(
        x, scale, bias, out, planes, C, HW, eps, slope);
    return cudaGetLastError();
  }
  // the plan must cover the plane and ask for the bytes the slice needs
  if (cluster > 8 || (cluster & (cluster - 1)) != 0 || (size_t)slice * cluster < (size_t)HW ||
      (size_t)smem != plane_smem_bytes<T>(slice) || smem > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(norm_act_plane_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const uintptr_t gap = reinterpret_cast<uintptr_t>(out) - reinterpret_cast<uintptr_t>(x);
  const int out_vec = gap % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)planes * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, norm_act_plane_kernel<T>, x, scale, bias, out, C, HW, cluster,
                         slice, eps, slope, out_vec);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
}  // namespace csof

// x, out: (N, C, H, W) contiguous in the dtype, planes = N * C, HW = H * W;
// scale, bias: (C,) float32. The plan (ops/kernels/norm_act.py
// norm_act_plan): cluster 0 = a warp a plane (HW <= 4096); else `cluster`
// blocks a plane (1, 2, 4, 8), `slice` elements and `smem` bytes of dynamic
// shared memory a block.
extern "C" int csof_norm_act_forward(const void* x, const float* scale, const float* bias,
                                     void* out, int planes, int C, int HW, int cluster,
                                     int slice, int smem, float eps, float slope,
                                     int dtype_code, void* stream) {
  using namespace csof;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes <= 0 || C <= 0 || HW <= 0 || planes % C != 0 || cluster < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype_code == kFloat32) {
    e = launch_norm_act(static_cast<const float*>(x), scale, bias, static_cast<float*>(out),
                        planes, C, HW, cluster, slice, smem, eps, slope, s);
  } else if (dtype_code == kBFloat16) {
    using bf = __nv_bfloat16;
    e = launch_norm_act(static_cast<const bf*>(x), scale, bias, static_cast<bf*>(out), planes,
                        C, HW, cluster, slice, smem, eps, slope, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
