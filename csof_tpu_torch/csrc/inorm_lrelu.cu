// K7 and K7 dx: the port's own InstanceNorm + affine + LeakyReLU of a 2-D
// block (models/blocks.py InstanceNorm, float32, then leaky_relu), forward
// and backward, over each (n, c) plane of an NCHW float32 tensor. M = H * W.
//
// Forward (K7), z -> y, and the plane's mean and rstd:
//   mean = sum(z) / M,  var = sum((z - mean)^2) / M     two passes, float32
//   rstd = rsqrt(var + eps)
//   zh   = (z - mean) * rstd,  a = zh * gamma[c] + beta[c]
//   y    = a >= 0 ? a : slope * a
// Backward (K7 dx), (z, dy, mean, rstd) -> dz, and two sums a plane:
//   da = a >= 0 ? dy : slope * dy          (zh and a recomputed as the forward did)
//   P1 = sum(da),  P2 = sum(da * zh)       (their sums over N are dbeta and dgamma)
//   dz = gamma * rstd * (da - P1 / M - zh * P2 / M)
// That is the module's numerics (the two-pass variance, not K5's
// E[z^2] - mean^2), and the closed form of their gradient.
//
// What bounds it on the H100: bytes. The forward reads z once and writes y,
// the backward reads z and dy once and writes dz; the plane stays on chip
// between the passes. As K5 (csrc/norm_act.cu) does it, by the plan that
// ops/kernels/norm_act.py native_plan picks:
//   - planes of at most 1024 elements: a warp a plane, eight planes a block,
//     each lane holding its 32 elements (z and dy) in registers;
//   - larger planes: a thread block cluster of `cluster` blocks (1, 2, 4 or
//     8; 1 is a plain block), each holding a slice of `slice` elements of z
//     (and of dy) in shared memory, copied with 16-byte cp.async at the
//     slice's own offset from the 16-byte grid. A plane's sums are taken in
//     a fixed order: each thread in order, a butterfly over the warp, the
//     warps in order, then the cluster's blocks in rank order through
//     distributed shared memory, so every block holds the same bits and the
//     result does not change from run to run. No float atomics.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cgs = cooperative_groups;

namespace csof {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpMax = 1024;      // the most elements the warp path takes
constexpr int kPerLane = kWarpMax / 32;
constexpr int G = 4;                // float32 elements in a 16-byte group

// the pre-activation, rounded as in both directions: (z - mean) * rstd, then
// one fused multiply-add
__device__ __forceinline__ float affine(float zh, float g, float b) {
  return __fmaf_rn(zh, g, b);
}
__device__ __forceinline__ float normed(float v, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(v, mean), rstd);
}

// Shared memory of one array of a block: its slice, shifted by up to one
// 16-byte group so that 16-byte groups of the tensor land on 16-byte groups
// of shared memory, in whole groups
__host__ __device__ inline size_t slice_smem_bytes(int slice) {
  return ((size_t)(slice + G - 1) / G + 1) * 16;
}

// Copy elements [0, len) of src into s, element e at s[mis + e] where mis is
// src's offset from the 16-byte grid; the groups' ends outside the slice are
// zero. Returns the number of groups.
__device__ __forceinline__ int stage(float* s, const float* src, int len) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(src) / sizeof(float)) % G);
  const int ng = (mis + len + G - 1) / G;
  for (int gi = threadIdx.x; gi < ng; gi += kThreads) {
    const int e0 = gi * G - mis;
    if (e0 >= 0 && e0 + G <= len) {
      cp_async16(smem_addr(s + gi * G), src + e0);
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k)
        s[gi * G + k] = e0 + k >= 0 && e0 + k < len ? src[e0 + k] : 0.f;
    }
  }
  return ng;
}

// Per-block scratch of the plane sums
template <int NV>
struct Sums {
  float red[kWarps][NV];
  float part[NV];   // this block's sums; read by the cluster
  float total[NV];  // the plane's
};

// v <- the plane's sums of each of NV per-thread values: a butterfly over
// each warp, the warps in order, then the cluster's blocks in rank order.
// Every thread of the cluster returns the same bits. Each call ends with the
// cluster synchronized, so `part` may be written again and no block leaves
// while another reads it.
template <int NV>
__device__ __forceinline__ void plane_sum(float (&v)[NV], Sums<NV>& sh, int cluster) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) sh.red[warp][i] = v[i];
  }
  __syncthreads();
  if (tid < NV) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sh.red[w][tid];
    sh.part[tid] = s;
    if (cluster == 1) sh.total[tid] = s;
  }
  if (cluster > 1) {
    cgs::cluster_group cl = cgs::this_cluster();
    cl.sync();  // every block's sums are published
    if (tid < NV) {
      float s = 0.f;
      for (int k = 0; k < cluster; ++k) s += cl.map_shared_rank(sh.part, k)[tid];
      sh.total[tid] = s;
    }
    cl.sync();
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = sh.total[i];
}

// grid ceil(planes / 8), block 256: warp w of block k owns plane 8k + w
__global__ void __launch_bounds__(kThreads)
inorm_lrelu_fwd_warp_kernel(const float* __restrict__ z, const float* __restrict__ gamma,
                            const float* __restrict__ beta, float* __restrict__ y,
                            float* __restrict__ mean_out, float* __restrict__ rstd_out,
                            int planes, int C, int HW, float eps, float slope) {
  const int plane = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (plane >= planes) return;  // whole warps leave: the shuffles below stay full
  const float* pz = z + (size_t)plane * HW;
  float v[kPerLane];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < HW ? pz[i] : 0.f;
    s += v[j];
  }
  const float mean = warp_sum(s) / (float)HW;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const float d = v[j] - mean;
    if (lane + 32 * j < HW) q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)HW + eps);
  if (lane == 0) {
    mean_out[plane] = mean;
    rstd_out[plane] = rstd;
  }
  const int c = plane % C;
  const float g = gamma[c], b = beta[c];
  float* py = y + (size_t)plane * HW;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int i = lane + 32 * j;
    if (i < HW) {
      const float a = affine(normed(v[j], mean, rstd), g, b);
      py[i] = a >= 0.f ? a : slope * a;
    }
  }
}

// grid planes * cluster, block 256, clusters of `cluster` blocks along x:
// block rank k of cluster p owns elements [k * slice, (k + 1) * slice) of
// plane p. y_vec = 1 when y and z lie at the same offset from the 16-byte
// grid (16-byte stores), else 0.
__global__ void __launch_bounds__(kThreads)
inorm_lrelu_fwd_plane_kernel(const float* __restrict__ z, const float* __restrict__ gamma,
                             const float* __restrict__ beta, float* __restrict__ y,
                             float* __restrict__ mean_out, float* __restrict__ rstd_out, int C,
                             int HW, int cluster, int slice, float eps, float slope, int y_vec) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* sz = reinterpret_cast<float*>(smem_raw);
  __shared__ Sums<1> sh;
  const int tid = threadIdx.x;
  const int plane = blockIdx.x / cluster, rank = blockIdx.x % cluster;
  const int s0 = rank * slice;
  const int len = max(0, min(slice, HW - s0));
  const float* pz = z + (size_t)plane * HW + s0;
  float* py = y + (size_t)plane * HW + s0;
  const int mis = (int)((reinterpret_cast<uintptr_t>(pz) / sizeof(float)) % G);
  const int ng = stage(sz, pz, len);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float s[1] = {0.f};  // the zeros around the slice add nothing
  for (int gi = tid; gi < ng; gi += kThreads) {
    float v[G];
    load_p<G>(sz + gi * G, v);
#pragma unroll
    for (int k = 0; k < G; ++k) s[0] += v[k];
  }
  plane_sum(s, sh, cluster);
  const float mean = s[0] / (float)HW;

  float q[1] = {0.f};
  for (int gi = tid; gi < ng; gi += kThreads) {
    const int e0 = gi * G - mis;
    float v[G];
    load_p<G>(sz + gi * G, v);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const float d = v[k] - mean;
      if (e0 + k >= 0 && e0 + k < len) q[0] += d * d;
    }
  }
  plane_sum(q, sh, cluster);
  const float rstd = rsqrtf(q[0] / (float)HW + eps);
  if (rank == 0 && tid == 0) {
    mean_out[plane] = mean;
    rstd_out[plane] = rstd;
  }
  const int c = plane % C;
  const float g = gamma[c], b = beta[c];

  for (int gi = tid; gi < ng; gi += kThreads) {
    const int e0 = gi * G - mis;
    float v[G];
    load_p<G>(sz + gi * G, v);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const float a = affine(normed(v[k], mean, rstd), g, b);
      v[k] = a >= 0.f ? a : slope * a;
    }
    if (y_vec && e0 >= 0 && e0 + G <= len) {
      store_p<G>(py + e0, v);
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k)
        if (e0 + k >= 0 && e0 + k < len) py[e0 + k] = v[k];
    }
  }
}

// grid ceil(planes / 8), block 256: warp w of block k owns plane 8k + w
__global__ void __launch_bounds__(kThreads)
inorm_lrelu_bwd_warp_kernel(const float* __restrict__ z, const float* __restrict__ dy,
                            const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            float* __restrict__ dz, float* __restrict__ pda,
                            float* __restrict__ pdah, int planes, int C, int HW, float slope) {
  const int plane = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (plane >= planes) return;
  const float* pz = z + (size_t)plane * HW;
  const float* pd = dy + (size_t)plane * HW;
  const float mean = mean_in[plane], rstd = rstd_in[plane];
  const int c = plane % C;
  const float g = gamma[c], b = beta[c];
  float zh[kPerLane], da[kPerLane];
  float p1 = 0.f, p2 = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int i = lane + 32 * j;
    const bool in = i < HW;
    zh[j] = normed(in ? pz[i] : 0.f, mean, rstd);
    const float d = in ? pd[i] : 0.f;  // 0 outside the plane: it adds nothing
    da[j] = affine(zh[j], g, b) >= 0.f ? d : slope * d;
    p1 += da[j];
    p2 += da[j] * zh[j];
  }
  p1 = warp_sum(p1);
  p2 = warp_sum(p2);
  if (lane == 0) {
    pda[plane] = p1;
    pdah[plane] = p2;
  }
  const float k1 = p1 / (float)HW, k2 = p2 / (float)HW, gr = g * rstd;
  float* pdz = dz + (size_t)plane * HW;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int i = lane + 32 * j;
    if (i < HW) pdz[i] = gr * (da[j] - k1 - zh[j] * k2);
  }
}

// The grid and clusters of inorm_lrelu_fwd_plane_kernel; shared memory holds
// the slice of z, then that of dy, each at its own offset from the 16-byte
// grid. dz_vec = 1 when dz and z lie at the same offset from it.
__global__ void __launch_bounds__(kThreads)
inorm_lrelu_bwd_plane_kernel(const float* __restrict__ z, const float* __restrict__ dy,
                             const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                             const float* __restrict__ gamma, const float* __restrict__ beta,
                             float* __restrict__ dz, float* __restrict__ pda,
                             float* __restrict__ pdah, int C, int HW, int cluster, int slice,
                             float slope, int dz_vec) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* sz = reinterpret_cast<float*>(smem_raw);
  float* sd = sz + slice_smem_bytes(slice) / sizeof(float);
  __shared__ Sums<2> sh;
  const int tid = threadIdx.x;
  const int plane = blockIdx.x / cluster, rank = blockIdx.x % cluster;
  const int s0 = rank * slice;
  const int len = max(0, min(slice, HW - s0));
  const float* pz = z + (size_t)plane * HW + s0;
  const float* pd = dy + (size_t)plane * HW + s0;
  float* pdz = dz + (size_t)plane * HW + s0;
  const int mis = (int)((reinterpret_cast<uintptr_t>(pz) / sizeof(float)) % G);
  const int mis_d = (int)((reinterpret_cast<uintptr_t>(pd) / sizeof(float)) % G);
  const int ng = stage(sz, pz, len);
  stage(sd, pd, len);
  cp_async_commit();
  const float mean = mean_in[plane], rstd = rstd_in[plane];
  const int c = plane % C;
  const float g = gamma[c], b = beta[c];
  cp_async_wait<0>();
  __syncthreads();

  // z's group gi, and dy at the same elements (zero outside the slice)
  auto load = [&](int gi, float* zv, float* dv) {
    load_p<G>(sz + gi * G, zv);
    if (mis_d == mis) {
      load_p<G>(sd + gi * G, dv);
    } else {
      const int e0 = gi * G - mis;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int e = e0 + k;
        dv[k] = e >= 0 && e < len ? sd[mis_d + e] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      zv[k] = normed(zv[k], mean, rstd);
      dv[k] = affine(zv[k], g, b) >= 0.f ? dv[k] : slope * dv[k];
    }
  };

  float p[2] = {0.f, 0.f};
  for (int gi = tid; gi < ng; gi += kThreads) {
    float zh[G], da[G];
    load(gi, zh, da);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      p[0] += da[k];
      p[1] += da[k] * zh[k];
    }
  }
  plane_sum(p, sh, cluster);
  if (rank == 0 && tid == 0) {
    pda[plane] = p[0];
    pdah[plane] = p[1];
  }
  const float k1 = p[0] / (float)HW, k2 = p[1] / (float)HW, gr = g * rstd;

  for (int gi = tid; gi < ng; gi += kThreads) {
    const int e0 = gi * G - mis;
    float zh[G], da[G];
    load(gi, zh, da);
#pragma unroll
    for (int k = 0; k < G; ++k) da[k] = gr * (da[k] - k1 - zh[k] * k2);
    if (dz_vec && e0 >= 0 && e0 + G <= len) {
      store_p<G>(pdz + e0, da);
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k)
        if (e0 + k >= 0 && e0 + k < len) pdz[e0 + k] = da[k];
    }
  }
}

// The plan must cover the plane and ask for the bytes its slices need
// (`arrays` of them a block); then the launch, with the cluster's size
// where it has more than one block
template <typename Kernel, typename... Args>
cudaError_t launch_plane(Kernel kernel, int arrays, int planes, int HW, int cluster, int slice,
                         int smem, cudaStream_t stream, Args... args) {
  if (cluster > 8 || (cluster & (cluster - 1)) != 0 || slice <= 0 || slice % G != 0 ||
      (size_t)slice * cluster < (size_t)HW ||
      (size_t)smem != arrays * slice_smem_bytes(slice) || smem > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
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
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

inline bool same_grid(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) - reinterpret_cast<uintptr_t>(b)) % 16 == 0;
}

}  // namespace
}  // namespace csof

// z, y: (N, C, H, W) contiguous float32, planes = N * C, HW = H * W; gamma,
// beta: (C,) float32; mean, rstd: (planes,) float32, written. The plan
// (ops/kernels/norm_act.py native_plan): cluster 0 = a warp a plane (HW <=
// 1024); else `cluster` blocks a plane (1, 2, 4, 8), `slice` elements and
// `smem` bytes of dynamic shared memory a block.
extern "C" int csof_inorm_lrelu_forward(const float* z, const float* gamma, const float* beta,
                                        float* y, float* mean, float* rstd, int planes, int C,
                                        int HW, int cluster, int slice, int smem, float eps,
                                        float slope, void* stream) {
  using namespace csof;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes <= 0 || C <= 0 || HW <= 0 || planes % C != 0 || cluster < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster == 0) {
    if (HW > kWarpMax) return static_cast<int>(cudaErrorInvalidValue);
    inorm_lrelu_fwd_warp_kernel<<<(planes + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        z, gamma, beta, y, mean, rstd, planes, C, HW, eps, slope);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(launch_plane(inorm_lrelu_fwd_plane_kernel, 1, planes, HW, cluster,
                                       slice, smem, s, z, gamma, beta, y, mean, rstd, C, HW,
                                       cluster, slice, eps, slope, (int)same_grid(y, z)));
}

// z, dy, dz: (N, C, H, W) contiguous float32; mean, rstd: what the forward
// wrote; gamma, beta: (C,) float32; pda, pdah: (planes,) float32, written
// (each plane's sum of da and of da * zh). The plan: native_plan's for the
// backward (two arrays a block).
extern "C" int csof_inorm_lrelu_backward(const float* z, const float* dy, const float* mean,
                                         const float* rstd, const float* gamma,
                                         const float* beta, float* dz, float* pda, float* pdah,
                                         int planes, int C, int HW, int cluster, int slice,
                                         int smem, float slope, void* stream) {
  using namespace csof;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes <= 0 || C <= 0 || HW <= 0 || planes % C != 0 || cluster < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster == 0) {
    if (HW > kWarpMax) return static_cast<int>(cudaErrorInvalidValue);
    inorm_lrelu_bwd_warp_kernel<<<(planes + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        z, dy, mean, rstd, gamma, beta, dz, pda, pdah, planes, C, HW, slope);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(launch_plane(inorm_lrelu_bwd_plane_kernel, 2, planes, HW, cluster,
                                       slice, smem, s, z, dy, mean, rstd, gamma, beta, dz, pda,
                                       pdah, C, HW, cluster, slice, slope,
                                       (int)same_grid(dz, z)));
}
