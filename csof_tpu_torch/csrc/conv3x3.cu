// K6: stride-1 3x3 convolution with zero padding (1, 1), NCHW, and its
// backward's dx, the same convolution of dy with the flipped weight.
//
//   acc[n, o, y, x] = sum_{ci, ky, kx} x[n, ci, y + ky - 1, x + kx - 1] * w[o, ci, ky, kx]
//   out = round_to_dtype(acc)  (+ round_to_dtype(bias[o]), added in the dtype)
//   or, with out_f32: out = acc (+ bias[o]) in float32
//
// Replaces the TPU kernel csof_tpu/ops/pallas/conv.py _conv3x3_cols_fwd_impl
// / _conv_cols_kernel (entries conv3x3_cols, conv3x3_cols_vb), with its
// numerics: x and the weight taken in x's dtype, the 9*Ci taps summed in
// float32, one rounding to x's dtype or a float32 output. The TPU kernel's
// VJP (_conv3x3_cols_vjp_bwd) computes dx with the same kernel on dy (cast to
// x's dtype) and the spatially flipped, in/out-transposed weight;
// conv3x3_dx_kernel is that launch, the same code under another name. The
// TPU kernel adds no bias; its caller (csof_tpu/models/blocks.py PallasConv)
// adds it afterwards in the dtype, which this kernel's epilogue does instead,
// in the same order and with the same roundings.
//
// What bounds it on the H100: operations (2 * 9 * Ci * Co per output pixel),
// so it runs on the tensor cores as an implicit GEMM on wgmma: M = the 64
// output pixels of one tile row per warpgroup (a block holds 2 or 4 rows),
// N = the output channels of the block (32, 64 or 128: one block covers all
// of Co up to 128, so each haloed input tile is staged once; beyond, blocks
// tile Co), K = 9 * Ci walked as Ci chunks of 32 bytes (8 float32 or 16
// bf16 channels) x 9 taps. bf16 runs m64nNk16 with bf16 operands; float32
// runs as 3xTF32: x = x_hi + x_lo, w = w_hi + w_lo, with x_hi rounded by
// cvt.rna.tf32.f32 before x_lo = x - x_hi is taken (the tensor cores read
// only a tf32 operand's top 19 bits, so a truncated split would be biased),
// and three m64nNk8 tf32 products (x_lo w_hi, x_hi w_lo, then x_hi w_hi, the
// small terms first), which keeps float32 accuracy at three times the TF32
// work. The tensor cores' float32 accumulator pulls toward zero at each
// wgmma step (measured against a float64 conv: the error grew linearly with
// the 27 * Ci / 8 steps of one chain, to 1.2e-4 at Ci 256, mean along the
// sign negative), so each chunk's 27 products start a fresh accumulator and
// the FP32 cores add it into the running sum: the error stays at about
// 5e-6 for any Ci (csof_tpu_torch/k6_accuracy.py).
//
// Layout: in NCHW the GEMM's K (channels) is the strided axis, and a tap's
// one-pixel shift breaks the 16-byte core-matrix alignment that a wgmma
// shared-memory descriptor needs; tf32 operands can only be read K-major.
// So the haloed tile is restaged channel-innermost (route b): for each
// input row, 16-byte groups of channels, pixel after pixel, so that the A
// operand of tap (ky, kx) for an output row is the staged row ky below it
// started kx groups in: a plain start-address offset, with 8 pixels 16 bytes
// apart in a core matrix (SBO 128 bytes) and the next channel group one
// staged row of 66 pixels further (LBO). The restage also applies the zero
// padding, the image edge, the ragged tile and the Ci tail, and splits
// float32 into hi/lo once per staged element (not once per tap; route a, A
// gathered into registers for each tap, would split nine times). B, the
// weight, is packed once per call by the wrapper (ops/kernels/conv.py
// pack_weight) into the same K-major core-matrix order, zero-padded to the
// chunk and to N (for float32 as hi and lo), and is copied as it is.
//
// Staging: a ring of two stages in dynamic shared memory, each holding one
// chunk's raw input rows and its packed weight, both by cp.async 16 bytes at
// a time; a raw row is copied from the aligned address below its column 0,
// in the input's own NCHW order, so any W and any alignment is taken, and a
// table keeps each row's offset for the restage. The copies of chunk c + 1
// are in flight while chunk c is restaged and multiplied; the restage and
// the products of a chunk follow each other inside a block, and two blocks
// share an SM wherever their shared memory fits, so that one block's
// restage runs beside the other's products. (A persistent grid, and an
// asynchronous wgmma overlapping the next chunk's restage, were measured
// slower on the H100: PERF.md.) The epilogue goes through shared memory so
// that the NCHW store is coalesced along pixels. Any N, Ci, H, W and Co are
// taken. The main loop and the epilogue live in igemm3x3.cuh, which K3's
// conv pass (skipfuse.cu) shares.
#include "igemm3x3.cuh"

namespace csof {
namespace {

// The forward, and the same code launched as the backward (dx on dy with
// the flipped weight) under its own name, so that a profile tells them apart
template <typename T, typename OutT, int NB>
__device__ __forceinline__ void conv3x3_block(const T* __restrict__ x,
                                              const uint8_t* __restrict__ wpk,
                                              const float* __restrict__ bias,
                                              OutT* __restrict__ out, int Ci, int H, int W,
                                              int Co) {
  float acc[NB / 2];
  igemm3x3_mainloop<T, NB>(PlaneSource<T>{x, Ci, (size_t)H * W}, wpk, Ci, H, W, acc);
  const float* ot = igemm3x3_epilogue<T, OutT, NB>(acc, bias, Co);
  igemm3x3_store<T, OutT, NB>(ot, out, H, W, Co);
}

template <typename T, typename OutT, int NB>
__global__ void __launch_bounds__(Tiling<T, NB>::kThreads, Tiling<T, NB>::kMinBlocks)
conv3x3_kernel(const T* __restrict__ x, const uint8_t* __restrict__ wpk,
               const float* __restrict__ bias, OutT* __restrict__ out, int Ci, int H, int W,
               int Co) {
  conv3x3_block<T, OutT, NB>(x, wpk, bias, out, Ci, H, W, Co);
}

template <typename T, int NB>
__global__ void __launch_bounds__(Tiling<T, NB>::kThreads, Tiling<T, NB>::kMinBlocks)
conv3x3_dx_kernel(const T* __restrict__ dy, const uint8_t* __restrict__ wpk, T* __restrict__ dx,
                  int Ci, int H, int W, int Co) {
  conv3x3_block<T, T, NB>(dy, wpk, nullptr, dx, Ci, H, W, Co);
}

template <typename T, typename OutT, int NB>
cudaError_t launch_nb(const T* x, const uint8_t* w, const float* bias, OutT* out, int N, int Ci,
                      int H, int W, int Co, bool dx, cudaStream_t stream) {
  using Tl = Tiling<T, NB>;
  const int tiles = ((H + Tl::kNwg - 1) / Tl::kNwg) * ((W + kTW - 1) / kTW);
  const dim3 grid(tiles, (Co + NB - 1) / NB, N);
  cudaError_t e;
  if constexpr (std::is_same_v<T, OutT>) {
    if (dx) {
      if ((e = allow_smem(conv3x3_dx_kernel<T, NB>, Tl::kSmem)) != cudaSuccess) return e;
      conv3x3_dx_kernel<T, NB><<<grid, Tl::kThreads, Tl::kSmem, stream>>>(x, w, out, Ci, H, W,
                                                                           Co);
      return cudaGetLastError();
    }
  }
  if ((e = allow_smem(conv3x3_kernel<T, OutT, NB>, Tl::kSmem)) != cudaSuccess) return e;
  conv3x3_kernel<T, OutT, NB><<<grid, Tl::kThreads, Tl::kSmem, stream>>>(x, w, bias, out, Ci, H,
                                                                         W, Co);
  return cudaGetLastError();
}

template <typename T, typename OutT>
cudaError_t launch_conv3x3(const T* x, const uint8_t* w, const float* bias, OutT* out, int N,
                           int Ci, int H, int W, int Co, int nb, bool dx, cudaStream_t stream) {
  switch (nb) {
    case 32: return launch_nb<T, OutT, 32>(x, w, bias, out, N, Ci, H, W, Co, dx, stream);
    case 64: return launch_nb<T, OutT, 64>(x, w, bias, out, N, Ci, H, W, Co, dx, stream);
    default: return launch_nb<T, OutT, 128>(x, w, bias, out, N, Ci, H, W, Co, dx, stream);
  }
}

}  // namespace
}  // namespace csof

// x: (N, Ci, H, W) contiguous in the dtype; w: the weight packed by
// ops/kernels/conv.py pack_weight for block width nb (32 if Co <= 32, 64 if
// Co <= 64, else 128): (ceil(Co / nb), ceil(Ci / chunk), [hi, lo for
// float32], 9 taps, 2, nb, 16 bytes of channels) in the dtype, zero-padded;
// bias: (Co,) float32 or null; out: (N, Co, H, W) in the dtype, or float32
// when out_f32 is 1. dx = 1 launches the backward's copy of the kernel (x is
// dy, w the packed flipped weight; no bias, no out_f32).
extern "C" int csof_conv3x3_forward(const void* x, const void* w, const float* bias, void* out,
                                    int N, int Ci, int H, int W, int Co, int nb, int dtype_code,
                                    int out_f32, int dx, void* stream) {
  using namespace csof;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int want_nb = Co <= 32 ? 32 : (Co <= 64 ? 64 : 128);
  if (N <= 0 || Ci <= 0 || H <= 0 || W <= 0 || Co <= 0 || N > 65535 || nb != want_nb ||
      (dx && (bias != nullptr || out_f32)))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  cudaError_t e;
  if (dtype_code == kFloat32) {
    e = launch_conv3x3(static_cast<const float*>(x), wp, bias, static_cast<float*>(out), N, Ci,
                       H, W, Co, nb, dx, s);
  } else if (dtype_code == kBFloat16) {
    using bf = __nv_bfloat16;
    const bf* xb = static_cast<const bf*>(x);
    e = out_f32 ? launch_conv3x3(xb, wp, bias, static_cast<float*>(out), N, Ci, H, W, Co, nb,
                                 false, s)
                : launch_conv3x3(xb, wp, bias, static_cast<bf*>(out), N, Ci, H, W, Co, nb, dx, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
