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
// flax (3, 3, Cin, F) kernel; the wrapper packs the torch (F, Cin, 3, 3)
// layout of the same parameter once per call, with K6's packing
// (ops/kernels/conv.py pack_weight).
//
// What bounds it on the H100: operations. The conv's multiply-adds,
// (2C + 81) * 9 * F a pixel, are about 19.8 GFLOP over the three SegFlow
// levels at B = 8 (C = F = 32, 64, 128), far above the bytes moved: 0.02 ms
// on the bf16 tensor cores, 0.30 ms on the FP32 cores. So the conv pass is
// K6's implicit GEMM on wgmma (igemm3x3.cuh): M = 64 output pixels of a tile
// row per warpgroup, N = F (32, 64 or 128: all output channels in one block,
// so each haloed input tile is staged once), K = 9 taps x (2C + 81) channels
// in 32-byte chunks; bf16 m64nNk16, float32 as 3xTF32 with a fresh
// accumulator a chunk. Its source reads each channel row of the chunk from
// whichever of q, m and corr holds that channel (chosen per channel, so a
// chunk may straddle two tensors when C is not a multiple of the chunk), by
// 16-byte cp.async in a 2-stage ring; there is no concat in device memory.
//
// What differs from the TPU kernel: the TPU carries the GroupNorm statistics
// across its sequential grid steps in scratch. Hopper blocks run in parallel
// and in no order, so the work is three launches: (1) K1 (corr.cu), launched
// by the wrapper, writes the corr volume to device memory; (2) the conv pass
// writes the rounded y once and, in its epilogue, one (sum, sum of squares)
// of the rounded y per block and channel: each warp reduces a channel of the
// block's output tile from shared memory, its lanes over the pixels in a
// fixed order and then a butterfly, so the partials are the same run to run
// (no float atomics); (3) the apply pass reduces the partials of its sample
// and group in a fixed order and applies the affine and the activation. Any
// H x W is taken.
//
// What it leaves on the table: the corr volume goes through device memory
// (about 28 MB written and read over the three levels at B = 8 bf16, 0.017
// ms at 3.35 TB/s; keeping it on chip would make the conv block stage m over
// a +-8-row halo at the stride-2 level, more than shared memory holds); at
// the 32-wide level a warpgroup's m64 row holds 32 pixels, so half of that
// level's products are padding. That level does run slower per useful FLOP
// than the 64-wide one, but at B = 8 its grid is 128 blocks, one wave on
// 132 SMs, so its time is one block's chain of 22 channel chunks (each a
// copy, a restage, two barriers and 9 wgmma, about 4 us on the H100) and not
// the padding: packing two output rows into one m64 would halve the blocks
// and keep the chain. A 3-stage ring did not shorten it (PERF.md), so the
// copies are not what the chain waits on; splitting the channels over two
// blocks or two warpgroups is the lever left. The apply pass re-reads y once.
#include "igemm3x3.cuh"

namespace csof {
namespace {

constexpr int kApplyPerBlock = 1024;  // elements per apply block

// The conv's input: channel c of the concat [q, m, corr]
template <typename T>
struct ConcatSource {
  const T* q;
  const T* m;
  const T* corr;
  int C, K2;
  size_t plane;
  __device__ __forceinline__ const T* channel(int n, int c) const {
    return c < C       ? q + ((size_t)n * C + c) * plane
           : c < 2 * C ? m + ((size_t)n * C + c - C) * plane
                       : corr + ((size_t)n * K2 + c - 2 * C) * plane;
  }
};

// grid (tiles, ceil(F / NB), B) as Tiling<T, NB> gives it; partial: (B,
// tiles, F, 2) float32
template <typename T, int NB>
__global__ void __launch_bounds__(Tiling<T, NB>::kThreads, Tiling<T, NB>::kMinBlocks)
fuse_conv_kernel(const T* __restrict__ q, const T* __restrict__ m, const T* __restrict__ corr,
                 const uint8_t* __restrict__ wpk, const float* __restrict__ bias,
                 T* __restrict__ y, float* __restrict__ partial, int C, int K2, int H, int W,
                 int F) {
  using Tl = Tiling<T, NB>;
  constexpr int kNwg = Tl::kNwg, kWarps = Tl::kThreads / 32;
  float acc[NB / 2];
  igemm3x3_mainloop<T, NB>(ConcatSource<T>{q, m, corr, C, K2, (size_t)H * W}, wpk,
                           2 * C + K2, H, W, acc);
  const float* ot = igemm3x3_epilogue<T, T, NB>(acc, bias, F);

  // the GroupNorm partials of the block: a warp a channel, over the valid
  // pixels of the tile's rows, from the rounded y in shared memory
  const int tiles_w = (W + kTW - 1) / kTW;
  const int y0 = (blockIdx.x / tiles_w) * kNwg, x0 = (blockIdx.x % tiles_w) * kTW;
  const int rows = min(kNwg, H - y0), cols = min(kTW, W - x0);
  const int co0 = blockIdx.y * NB, n = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int nn = warp; nn < NB && co0 + nn < F; nn += kWarps) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float* row = ot + (r * NB + nn) * kOs;
      for (int x = lane; x < cols; x += 32) {
        const float v = row[x];
        s1 += v;
        s2 += v * v;
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      float* p = partial + (((size_t)n * gridDim.x + blockIdx.x) * F + co0 + nn) * 2;
      p[0] = s1;
      p[1] = s2;
    }
  }
  igemm3x3_store<T, T, NB>(ot, y, H, W, F);
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

template <typename T, int NB>
cudaError_t launch_nb(const T* q, const T* m, const T* corr, const uint8_t* w,
                      const float* bias, const float* gn_scale, const float* gn_bias, T* y,
                      float* partial, T* out, int B, int C, int K2, int H, int W, int F,
                      int groups, float eps, float slope, cudaStream_t stream) {
  using Tl = Tiling<T, NB>;
  const int ntiles = ((H + Tl::kNwg - 1) / Tl::kNwg) * ((W + kTW - 1) / kTW);
  cudaError_t e = allow_smem(fuse_conv_kernel<T, NB>, Tl::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 cgrid(ntiles, (F + NB - 1) / NB, B);
  fuse_conv_kernel<T, NB><<<cgrid, Tl::kThreads, Tl::kSmem, stream>>>(
      q, m, corr, w, bias, y, partial, C, K2, H, W, F);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 agrid((H * W + kApplyPerBlock - 1) / kApplyPerBlock, F, B);
  gn_apply_kernel<T><<<agrid, 256, 0, stream>>>(y, partial, gn_scale, gn_bias, out, H, W, F,
                                                groups, ntiles, eps, slope);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_skipfuse(const T* q, const T* m, const T* corr, const uint8_t* w,
                            const float* bias, const float* gn_scale, const float* gn_bias,
                            T* y, float* partial, T* out, int B, int C, int K2, int H, int W,
                            int F, int groups, int nb, float eps, float slope,
                            cudaStream_t stream) {
  switch (nb) {
    case 32:
      return launch_nb<T, 32>(q, m, corr, w, bias, gn_scale, gn_bias, y, partial, out, B, C,
                              K2, H, W, F, groups, eps, slope, stream);
    case 64:
      return launch_nb<T, 64>(q, m, corr, w, bias, gn_scale, gn_bias, y, partial, out, B, C,
                              K2, H, W, F, groups, eps, slope, stream);
    default:
      return launch_nb<T, 128>(q, m, corr, w, bias, gn_scale, gn_bias, y, partial, out, B, C,
                               K2, H, W, F, groups, eps, slope, stream);
  }
}

}  // namespace
}  // namespace csof

// Inputs q, m (B, C, H, W) and corr (B, K2, H, W) in the dtype; w: the
// (F, 2C + K2, 3, 3) weight packed by ops/kernels/conv.py pack_weight for
// block width nb (32 if F <= 32, 64 if F <= 64, else 128); bias and the
// GroupNorm parameters (F,) float32; scratch y (B, F, H, W) in the dtype
// and partial (B, tiles, F, 2) float32, tiles = ceil(H / rows) * ceil(W /
// 64) with 2 or 4 rows a block (ceil(H / 2) * ceil(W / 64) holds either).
extern "C" int csof_skipfuse_forward(const void* q, const void* m, const void* corr,
                                     const void* w, const float* bias, const float* gn_scale,
                                     const float* gn_bias, void* y, float* partial, void* out,
                                     int B, int C, int K2, int H, int W, int F, int groups,
                                     int nb, float eps, float slope, int dtype_code,
                                     void* stream) {
  using namespace csof;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int want_nb = F <= 32 ? 32 : (F <= 64 ? 64 : 128);
  if (B <= 0 || B > 65535 || C <= 0 || K2 <= 0 || H <= 0 || W <= 0 || F <= 0 ||
      groups <= 0 || F % groups != 0 || nb != want_nb)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  cudaError_t e;
  if (dtype_code == kFloat32) {
    e = launch_skipfuse(static_cast<const float*>(q), static_cast<const float*>(m),
                        static_cast<const float*>(corr), wp, bias, gn_scale, gn_bias,
                        static_cast<float*>(y), partial, static_cast<float*>(out), B, C, K2,
                        H, W, F, groups, nb, eps, slope, s);
  } else if (dtype_code == kBFloat16) {
    using bf = __nv_bfloat16;
    e = launch_skipfuse(static_cast<const bf*>(q), static_cast<const bf*>(m),
                        static_cast<const bf*>(corr), wp, bias, gn_scale, gn_bias,
                        static_cast<bf*>(y), partial, static_cast<bf*>(out), B, C, K2, H, W, F,
                        groups, nb, eps, slope, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
