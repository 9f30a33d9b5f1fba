// K6: stride-1 3x3 convolution with zero padding (1, 1), NCHW, and its
// backward's dx, the same convolution of dy with the flipped weight.
//
//   acc[n, o, y, x] = sum_{ci, ky, kx} x[n, ci, y + ky - 1, x + kx - 1] * w[o, ci, ky, kx]
//   out = round_to_dtype(acc)  (+ round_to_dtype(bias[o]), added in the dtype)
//   or, with out_f32: out = acc (+ bias[o]) in float32
//
// Replaces the TPU kernel csof_tpu/ops/pallas/conv.py _conv3x3_cols_fwd_impl
// / _conv_cols_kernel (entries conv3x3_cols, conv3x3_cols_vb), with its
// numerics: x and the weight taken in x's dtype (the float32 weight is
// rounded to it here), the 9*Ci taps summed in float32, one rounding to x's
// dtype or a float32 output. The TPU kernel's VJP (_conv3x3_cols_vjp_bwd)
// computes dx with the same kernel on dy (cast to x's dtype) and the
// spatially flipped, in/out-transposed weight; conv3x3_dx_kernel is that
// launch, the same code under another name. The TPU kernel adds no bias; its caller
// (csof_tpu/models/blocks.py PallasConv) adds the bias afterwards in the
// dtype, which this kernel's epilogue does instead, in the same order and
// with the same roundings, to save a pass over the output.
//
// What bounds it on the H100: operations (2 * 9 * Ci * Co per output
// pixel; at the U-Net's levels 0 and 1, 0.15-2.4 GFLOP per sample). The TPU
// design (an H-only im2col with W padded to 128 lanes and one tap-widened
// matmul) was for the MXU's lanes and is not carried over. This first
// version is a direct convolution on the FP32 cores (tensor cores and TMA
// are later work): a block owns an 8 x 32 output tile and 32 output
// channels, stages 8 input channels of the haloed 10 x 34 input tile and
// their 8 x 9 x 32 weights in shared memory, and each thread keeps a 4-pixel
// x 8-channel block of float32 accumulators, so that 6 input loads and 6
// weight loads (as float4) feed 96 multiply-adds per input channel and
// kernel row. The shared input rows are 37 floats apart, so the 32 threads
// of a warp (4 rows x 8 pixel groups) read 32 different banks. Any N, Ci,
// H, W and Co are taken; the ragged tile edge and Ci, Co tails are masked.
#include <type_traits>

#include "common.cuh"

namespace csof {
namespace {

constexpr int kTH = 8;                    // output tile rows
constexpr int kTW = 32;                   // output tile columns
constexpr int kCoBlk = 32;                // output channels per block
constexpr int kCiChunk = 8;               // input channels staged per pass
constexpr int kPx = 4;                    // consecutive pixels per thread
constexpr int kCoT = 8;                   // output channels per thread
constexpr int kThreads = (kTH * kTW / kPx) * (kCoBlk / kCoT);  // 256
constexpr int kRows = kTH + 2, kCols = kTW + 2;
constexpr int kStride = 37;               // shared row stride: kCols <= 37, 37 % 4 == 1

static_assert(kThreads == 256, "thread layout");
static_assert(kStride >= kCols && kStride % 4 == 1, "row stride");

// One block's work; grid (tiles, ceil(Co / 32), N), block 256
template <typename T, typename OutT>
__device__ __forceinline__ void conv3x3_block(const T* __restrict__ x,
                                              const float* __restrict__ w,
                                              const float* __restrict__ bias,
                                              OutT* __restrict__ out, int Ci, int H, int W,
                                              int Co) {
  __shared__ float xs[kCiChunk][kRows][kStride];
  __shared__ __align__(16) float ws[kCiChunk][9][kCoBlk];

  const int tiles_w = (W + kTW - 1) / kTW;
  const int y0 = (blockIdx.x / tiles_w) * kTH, x0 = (blockIdx.x % tiles_w) * kTW;
  const int co0 = blockIdx.y * kCoBlk;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  // a warp shares its channel group (weight reads broadcast) and covers 4
  // rows x 8 pixel groups
  const int cg = tid / (kThreads / (kCoBlk / kCoT));
  const int pg = tid % (kThreads / (kCoBlk / kCoT));
  const int row = pg / (kTW / kPx), px0 = (pg % (kTW / kPx)) * kPx;
  const size_t plane = (size_t)H * W;

  float acc[kPx][kCoT];
#pragma unroll
  for (int p = 0; p < kPx; ++p)
#pragma unroll
    for (int o = 0; o < kCoT; ++o) acc[p][o] = 0.f;

  for (int ci0 = 0; ci0 < Ci; ci0 += kCiChunk) {
    const int nc = min(kCiChunk, Ci - ci0);
    for (int i = tid; i < nc * kRows * kCols; i += kThreads) {
      const int cc = i / (kRows * kCols), rem = i % (kRows * kCols);
      const int r = rem / kCols, c = rem % kCols;
      const int gy = y0 - 1 + r, gx = x0 - 1 + c;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_float(x[((size_t)n * Ci + ci0 + cc) * plane + (size_t)gy * W + gx]);
      xs[cc][r][c] = v;
    }
    // tap fastest, then channel: consecutive threads read consecutive floats
    // of the (Co, Ci, 3, 3) weight
    for (int i = tid; i < 9 * kCiChunk * kCoBlk; i += kThreads) {
      const int tap = i % 9, cc = (i / 9) % kCiChunk, o = i / (9 * kCiChunk);
      ws[cc][tap][o] = (co0 + o < Co && cc < nc)
                           ? round_to<T>(w[((size_t)(co0 + o) * Ci + ci0 + cc) * 9 + tap])
                           : 0.f;
    }
    __syncthreads();
    for (int cc = 0; cc < nc; ++cc) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float xv[kPx + 2];
#pragma unroll
        for (int j = 0; j < kPx + 2; ++j) xv[j] = xs[cc][row + ky][px0 + j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wr = reinterpret_cast<const float4*>(&ws[cc][ky * 3 + kx][cg * kCoT]);
          const float4 wa = wr[0], wb = wr[1];
          const float wv[kCoT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int p = 0; p < kPx; ++p)
#pragma unroll
            for (int o = 0; o < kCoT; ++o) acc[p][o] = fmaf(xv[p + kx], wv[o], acc[p][o]);
        }
      }
    }
    __syncthreads();
  }

  const int gy = y0 + row;
  if (gy >= H) return;
#pragma unroll
  for (int o = 0; o < kCoT; ++o) {
    const int co = co0 + cg * kCoT + o;
    if (co >= Co) continue;
    OutT* po = out + ((size_t)n * Co + co) * plane + (size_t)gy * W;
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      const int gx = x0 + px0 + p;
      if (gx >= W) continue;
      float v;
      if constexpr (sizeof(OutT) == sizeof(float) && sizeof(T) != sizeof(float)) {
        v = acc[p][o];  // out_f32 of a bf16 conv: the float32 sum as it is
        if (bias != nullptr) v += bias[co];
      } else {
        v = round_to<T>(acc[p][o]);
        if (bias != nullptr) v = round_to<T>(v + round_to<T>(bias[co]));
      }
      po[gx] = from_float<OutT>(v);
    }
  }
}

// The forward, and the same code launched as the backward (dx on dy with
// the flipped weight) under its own name, so that a profile tells them apart
template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, OutT* __restrict__ out, int Ci, int H, int W,
               int Co) {
  conv3x3_block<T, OutT>(x, w, bias, out, Ci, H, W, Co);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_dx_kernel(const T* __restrict__ dy, const float* __restrict__ wflip, T* __restrict__ dx,
                  int Ci, int H, int W, int Co) {
  conv3x3_block<T, T>(dy, wflip, nullptr, dx, Ci, H, W, Co);
}

template <typename T, typename OutT>
cudaError_t launch_conv3x3(const T* x, const float* w, const float* bias, OutT* out, int N,
                           int Ci, int H, int W, int Co, bool dx, cudaStream_t stream) {
  const int tiles = ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  const dim3 grid(tiles, (Co + kCoBlk - 1) / kCoBlk, N);
  if constexpr (std::is_same_v<T, OutT>) {
    if (dx) {
      conv3x3_dx_kernel<T><<<grid, kThreads, 0, stream>>>(x, w, out, Ci, H, W, Co);
      return cudaGetLastError();
    }
  }
  conv3x3_kernel<T, OutT><<<grid, kThreads, 0, stream>>>(x, w, bias, out, Ci, H, W, Co);
  return cudaGetLastError();
}

}  // namespace
}  // namespace csof

// x: (N, Ci, H, W) contiguous in the dtype; w: (Co, Ci, 3, 3) float32; bias:
// (Co,) float32 or null; out: (N, Co, H, W) in the dtype, or float32 when
// out_f32 is 1. dx = 1 launches the backward's copy of the kernel (x is dy,
// w the flipped weight; no bias, no out_f32).
extern "C" int csof_conv3x3_forward(const void* x, const float* w, const float* bias, void* out,
                                    int N, int Ci, int H, int W, int Co, int dtype_code,
                                    int out_f32, int dx, void* stream) {
  using namespace csof;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || Ci <= 0 || H <= 0 || W <= 0 || Co <= 0 || N > 65535 || Co > 65535 * kCoBlk ||
      (dx && (bias != nullptr || out_f32)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype_code == kFloat32) {
    e = launch_conv3x3(static_cast<const float*>(x), w, bias, static_cast<float*>(out), N, Ci, H,
                       W, Co, dx, s);
  } else if (dtype_code == kBFloat16) {
    using bf = __nv_bfloat16;
    const bf* xb = static_cast<const bf*>(x);
    e = out_f32 ? launch_conv3x3(xb, w, bias, static_cast<float*>(out), N, Ci, H, W, Co, false, s)
                : launch_conv3x3(xb, w, bias, static_cast<bf*>(out), N, Ci, H, W, Co, dx, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
