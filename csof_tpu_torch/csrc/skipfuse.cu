// K3: SegFlow skip fuse, forward only.
//
//   corr = K1(q, m)                                   rounded to the dtype
//   y    = conv3x3_same([q, m, corr], W) + b          f32 sum -> dtype, + bias in dtype
//   out  = leaky_relu(group_norm(y), 0.01)            f32 stats, affine in dtype
//
// Replaces the TPU kernel csof_tpu/ops/pallas/skipfuse.py
// fused_skip_fuse_batched / _fused_kernel, with its rounding points:
// corr rounded to the dtype before the conv (skipfuse.py:165-167), the conv
// sum rounded before the bias is added in the dtype (:192-194), GroupNorm
// stats as f32 sums of the rounded y with the group mean taken as the mean of
// channel means (:195-218), the affine coefficients cast to the dtype and
// applied in it (:219-229), the LeakyReLU predicate taken in f32 (:232-233).
// Weight channel order is [q (0:C), m (C:2C), corr (2C:2C+K2)], as in the
// flax (3, 3, Cin, F) kernel; this kernel reads the torch (F, Cin, 3, 3)
// layout of the same parameter.
//
// What bounds it on the H100: the conv's multiply-adds (2C+81)*9*F per
// pixel, about 25 GFLOP per SegFlow step at B=8, which dominate the bytes
// moved. This first version runs them on the FP32 cores (no tensor cores) as
// an implicit GEMM: a block owns a 16x16 pixel tile and 32 output channels,
// stages 8 input channels of the haloed tile (read straight from the three
// input pointers, no concat in device memory) and their 9x8x32 weights in
// shared memory, and each thread keeps 32 float32 accumulators for its pixel.
//
// What differs from the TPU kernel: the TPU carries the GroupNorm statistics
// across its sequential grid steps in scratch. Hopper blocks run in parallel
// and in no order, so the work is split into passes: (1) K1, launched by the
// caller, writes the corr volume to device memory (keeping it on chip is
// later work); (2) the conv pass writes the pre-norm y and one partial (sum,
// sum of squares) per block and channel; (3) the apply pass reduces the partials of
// its sample and group in a fixed order (deterministic, no float atomics)
// and applies the affine and the activation. Any H x W is taken.
#include "common.cuh"

namespace csof {
namespace {

constexpr int kConvTile = 16;                  // pixel tile edge
constexpr int kConvF = 32;                     // output channels per block
constexpr int kConvChunk = 8;                  // input channels staged per pass
constexpr int kConvThreads = kConvTile * kConvTile;
constexpr int kApplyPerBlock = 1024;           // elements per apply block

// grid (tiles, ceil(F/32), B), block 256.  partial: (B, tiles, F, 2) float32
template <typename T>
__global__ void __launch_bounds__(kConvThreads)
fuse_conv_kernel(const T* __restrict__ q, const T* __restrict__ m, const T* __restrict__ corr,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 T* __restrict__ y, float* __restrict__ partial,
                 int C, int K2, int H, int W, int F) {
  __shared__ float xs[kConvChunk][kConvTile + 2][kConvTile + 2];
  __shared__ __align__(16) float ws[9][kConvChunk][kConvF];
  __shared__ float red[kConvThreads / 32][kConvF][2];

  const int cin = 2 * C + K2;
  const int tiles_w = (W + kConvTile - 1) / kConvTile;
  const int ntiles = tiles_w * ((H + kConvTile - 1) / kConvTile);
  const int tile = blockIdx.x;
  const int ty0 = (tile / tiles_w) * kConvTile, tx0 = (tile % tiles_w) * kConvTile;
  const int f0 = blockIdx.y * kConvF;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int py = tid / kConvTile, px = tid % kConvTile;
  const size_t plane = (size_t)H * W;

  float acc[kConvF];
#pragma unroll
  for (int f = 0; f < kConvF; ++f) acc[f] = 0.f;

  constexpr int kPatch = (kConvTile + 2) * (kConvTile + 2);
  for (int ci0 = 0; ci0 < cin; ci0 += kConvChunk) {
    for (int i = tid; i < kConvChunk * kPatch; i += kConvThreads) {
      const int cc = i / kPatch, p = i % kPatch;
      const int ci = ci0 + cc;
      const int yy = ty0 - 1 + p / (kConvTile + 2), xx = tx0 - 1 + p % (kConvTile + 2);
      float v = 0.f;
      if (ci < cin && yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const size_t off = (size_t)yy * W + xx;
        if (ci < C) v = to_float(q[((size_t)b * C + ci) * plane + off]);
        else if (ci < 2 * C) v = to_float(m[((size_t)b * C + ci - C) * plane + off]);
        else v = to_float(corr[((size_t)b * K2 + ci - 2 * C) * plane + off]);
      }
      xs[cc][p / (kConvTile + 2)][p % (kConvTile + 2)] = v;
    }
    // tap fastest, then channel: consecutive threads read consecutive floats
    // of the (F, Cin, 3, 3) weight
    for (int i = tid; i < 9 * kConvChunk * kConvF; i += kConvThreads) {
      const int tap = i % 9, cc = (i / 9) % kConvChunk, f = i / (9 * kConvChunk);
      const int ci = ci0 + cc;
      ws[tap][cc][f] = (f0 + f < F && ci < cin)
                           ? round_to<T>(w[((size_t)(f0 + f) * cin + ci) * 9 + tap])
                           : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < kConvChunk; ++cc) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float v = xs[cc][py + tap / 3][px + tap % 3];
        const float4* wrow = reinterpret_cast<const float4*>(&ws[tap][cc][0]);
#pragma unroll
        for (int f4 = 0; f4 < kConvF / 4; ++f4) {
          const float4 wv = wrow[f4];
          acc[4 * f4 + 0] = fmaf(v, wv.x, acc[4 * f4 + 0]);
          acc[4 * f4 + 1] = fmaf(v, wv.y, acc[4 * f4 + 1]);
          acc[4 * f4 + 2] = fmaf(v, wv.z, acc[4 * f4 + 2]);
          acc[4 * f4 + 3] = fmaf(v, wv.w, acc[4 * f4 + 3]);
        }
      }
    }
    __syncthreads();
  }

  const int yy = ty0 + py, xx = tx0 + px;
  const bool inside = yy < H && xx < W;
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int f = 0; f < kConvF; ++f) {
    const bool live = inside && f0 + f < F;
    float yv = 0.f;
    if (live) {
      yv = round_to<T>(round_to<T>(acc[f]) + round_to<T>(bias[f0 + f]));
      y[((size_t)b * F + f0 + f) * plane + (size_t)yy * W + xx] = from_float<T>(yv);
    }
    const float s1 = warp_sum(yv), s2 = warp_sum(yv * yv);
    if (lane == 0) {
      red[warp][f][0] = s1;
      red[warp][f][1] = s2;
    }
  }
  __syncthreads();
  if (tid < 2 * kConvF) {
    const int f = tid / 2, k = tid % 2;
    if (f0 + f < F) {
      float s = 0.f;
      for (int wi = 0; wi < kConvThreads / 32; ++wi) s += red[wi][f][k];
      partial[(((size_t)b * ntiles + tile) * F + f0 + f) * 2 + k] = s;
    }
  }
}

// grid (ceil(H*W/1024), F, B), block 256
template <typename T>
__global__ void __launch_bounds__(256)
gn_apply_kernel(const T* __restrict__ y, const float* __restrict__ partial,
                const float* __restrict__ gn_scale, const float* __restrict__ gn_bias,
                T* __restrict__ out, int H, int W, int F, int groups, int ntiles,
                float eps, float slope) {
  __shared__ float coef[2];
  const int f = blockIdx.y, b = blockIdx.z;
  const int cpg = F / groups, g = f / cpg;
  const int hw = H * W;
  if (threadIdx.x < 32) {
    // the group's statistics, summed in a fixed order: per channel over
    // tiles, then the channel means over the group
    float mean_sum = 0.f, m2_sum = 0.f;
    for (int i = threadIdx.x; i < cpg; i += 32) {
      const int c = g * cpg + i;
      float s1 = 0.f, s2 = 0.f;
      for (int t = 0; t < ntiles; ++t) {
        const float* p = partial + (((size_t)b * ntiles + t) * F + c) * 2;
        s1 += p[0];
        s2 += p[1];
      }
      mean_sum += s1 / (float)hw;
      m2_sum += s2 / (float)hw;
    }
    mean_sum = warp_sum(mean_sum);
    m2_sum = warp_sum(m2_sum);
    if (threadIdx.x == 0) {
      const float mean = mean_sum / (float)cpg, m2 = m2_sum / (float)cpg;
      const float inv = rsqrtf(fmaxf(m2 - mean * mean, 0.f) + eps);
      const float a = gn_scale[f] * inv;
      coef[0] = round_to<T>(a);
      coef[1] = round_to<T>(gn_bias[f] - mean * a);
    }
  }
  __syncthreads();
  const float a = coef[0], bb = coef[1];
  const float slope_t = round_to<T>(slope);
  const size_t base = ((size_t)b * F + f) * hw;
  const int start = blockIdx.x * kApplyPerBlock;
  const int stop = min(start + kApplyPerBlock, hw);
  for (int i = start + threadIdx.x; i < stop; i += blockDim.x) {
    const float o = round_to<T>(round_to<T>(to_float(y[base + i]) * a) + bb);
    out[base + i] = from_float<T>(o >= 0.f ? o : o * slope_t);
  }
}

template <typename T>
cudaError_t launch_skipfuse(const T* q, const T* m, const T* corr, const float* w,
                            const float* bias, const float* gn_scale, const float* gn_bias,
                            T* y, float* partial, T* out, int B, int C, int K2, int H, int W,
                            int F, int groups, float eps, float slope, cudaStream_t stream) {
  const int ntiles = ((H + kConvTile - 1) / kConvTile) * ((W + kConvTile - 1) / kConvTile);
  const dim3 cgrid(ntiles, (F + kConvF - 1) / kConvF, B);
  fuse_conv_kernel<T><<<cgrid, kConvThreads, 0, stream>>>(q, m, corr, w, bias, y, partial, C,
                                                         K2, H, W, F);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 agrid((H * W + kApplyPerBlock - 1) / kApplyPerBlock, F, B);
  gn_apply_kernel<T><<<agrid, 256, 0, stream>>>(y, partial, gn_scale, gn_bias, out, H, W, F,
                                                groups, ntiles, eps, slope);
  return cudaGetLastError();
}

}  // namespace
}  // namespace csof

// Inputs q, m (B, C, H, W) and corr (B, K2, H, W) in the dtype; scratch y
// (B, F, H, W) in the dtype and partial (B, tiles, F, 2) float32 with
// tiles = ceil(H/16) * ceil(W/16).
extern "C" int csof_skipfuse_forward(const void* q, const void* m, const void* corr,
                                     const float* w, const float* bias, const float* gn_scale,
                                     const float* gn_bias, void* y, float* partial, void* out,
                                     int B, int C, int K2, int H, int W, int F, int groups,
                                     float eps, float slope, int dtype_code, void* stream) {
  using namespace csof;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups <= 0 || F % groups != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype_code == kFloat32) {
    e = launch_skipfuse(static_cast<const float*>(q), static_cast<const float*>(m),
                        static_cast<const float*>(corr), w, bias, gn_scale, gn_bias,
                        static_cast<float*>(y), partial, static_cast<float*>(out), B, C, K2,
                        H, W, F, groups, eps, slope, s);
  } else if (dtype_code == kBFloat16) {
    using bf = __nv_bfloat16;
    e = launch_skipfuse(static_cast<const bf*>(q), static_cast<const bf*>(m),
                        static_cast<const bf*>(corr), w, bias, gn_scale, gn_bias,
                        static_cast<bf*>(y), partial, static_cast<bf*>(out), B, C, K2, H, W, F,
                        groups, eps, slope, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
