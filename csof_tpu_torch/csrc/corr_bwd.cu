// K2: backward of the local correlation volume (K1), channel-major, in the
// gather form (no scatter, no atomics: the result is deterministic).
//
//   dq[b, c, p] = (1/sqrt C) sum_kk g[b, kk, p]        * m[b, c, p + d_kk]
//   dm[b, c, p] = (1/sqrt C) sum_kk g[b, kk, p - d_kk] * q[b, c, p - d_kk]
//   d_kk = s * (dy, dx),  kk = (dy + r) * (2r + 1) + (dx + r)
//
// with every term whose sample falls outside the image zero. q, m, dq, dm are
// (B, C, H, W) and g is (B, (2r+1)^2, H, W), all in the model dtype; the sums
// run in float32 and are rounded once, after the scale.
//
// Replaces the TPU kernels csof_tpu/ops/pallas/corr.py _corr_bwd_pallas_v2
// (_corr_bwd_dq_kernel, _corr_bwd_dm_kernel) and _corr_bwd_pallas
// (_corr_bwd_tile_kernel), which compute the same pair.
//
// What bounds it on the H100: bytes. Each output value costs (2r+1)^2
// multiply-adds; with q, m, g read once and dq, dm written once, the SegFlow
// levels (r = 4, bf16) do about 27 FLOP per byte. That is above the FP32
// cores' 67 TFLOP/s over 3.35 TB/s = 20, which hold this version back, but
// far below the bf16 tensor cores' 989 / 3.35 = 295, where the window
// products can run as one banded GEMM per window row (PERF.md has the
// bound). The design mirrors K1: a block owns a 16x16 pixel tile and a chunk of 8
// channels, walks the 2r+1 window rows, and per row stages the rows of m (for
// dq) or of q and the 2r+1 g planes of that row (for dm), tile plus r*s halo
// on both sides, in shared memory. Each thread keeps its 8 channel sums in
// registers, so each output is written once with a coalesced store. g is
// re-read once per channel chunk (from L2 at these sizes). Tensor cores, TMA
// and a fused dq/dm pass are later work.
#include "common.cuh"

namespace csof {
namespace {

constexpr int kBwdTile = 16;  // output tile edge (pixels)
constexpr int kBwdChunk = 8;  // channels per block

inline int bwd_row_width(int radius, int stride) { return kBwdTile + 2 * radius * stride; }

// grid (ceil(W/16), ceil(H/16), B * ceil(C/8)), block (16, 16)
template <typename T, int K>
__global__ void __launch_bounds__(kBwdTile * kBwdTile)
corr_bwd_dq_kernel(const T* __restrict__ m, const T* __restrict__ g, T* __restrict__ dq,
                   int C, int H, int W, int stride, float scale) {
  extern __shared__ float smem[];
  constexpr int r = K / 2;
  const int halo = r * stride;
  const int mw = kBwdTile + 2 * halo;
  float* ms = smem;  // [chunk][16][mw]: the m rows of one window row

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBwdTile + tx;
  const int nthreads = kBwdTile * kBwdTile;
  const int x0 = blockIdx.x * kBwdTile, y0 = blockIdx.y * kBwdTile;
  const int nchunks = (C + kBwdChunk - 1) / kBwdChunk;
  const int b = blockIdx.z / nchunks;
  const int c0 = (blockIdx.z % nchunks) * kBwdChunk;
  const int cn = min(kBwdChunk, C - c0);
  const size_t plane = (size_t)H * W;
  const T* mb = m + ((size_t)b * C + c0) * plane;
  const T* gb = g + (size_t)b * K * K * plane;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;

  float acc[kBwdChunk];
#pragma unroll
  for (int cc = 0; cc < kBwdChunk; ++cc) acc[cc] = 0.f;

  for (int row = 0; row < K; ++row) {
    const int dy = (row - r) * stride;
    float gk[K];
#pragma unroll
    for (int j = 0; j < K; ++j)
      gk[j] = inside ? to_float(gb[(size_t)(row * K + j) * plane + (size_t)y * W + x]) : 0.f;
    for (int i = tid; i < kBwdChunk * kBwdTile * mw; i += nthreads) {
      const int cc = i / (kBwdTile * mw);
      const int p = i % (kBwdTile * mw);
      const int yy = y0 + p / mw + dy, xx = x0 - halo + p % mw;
      const bool in = cc < cn && yy >= 0 && yy < H && xx >= 0 && xx < W;
      ms[i] = in ? to_float(mb[cc * plane + (size_t)yy * W + xx]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < kBwdChunk; ++cc) {
      const float* mrow = ms + (cc * kBwdTile + ty) * mw + tx;
      float a = acc[cc];
#pragma unroll
      for (int j = 0; j < K; ++j) a = fmaf(gk[j], mrow[j * stride], a);
      acc[cc] = a;
    }
    __syncthreads();
  }

  if (inside) {
    T* out = dq + ((size_t)b * C + c0) * plane + (size_t)y * W + x;
#pragma unroll
    for (int cc = 0; cc < kBwdChunk; ++cc)
      if (cc < cn) out[cc * plane] = from_float<T>(acc[cc] * scale);
  }
}

// grid (ceil(W/16), ceil(H/16), B * ceil(C/8)), block (16, 16)
template <typename T, int K>
__global__ void __launch_bounds__(kBwdTile * kBwdTile)
corr_bwd_dm_kernel(const T* __restrict__ q, const T* __restrict__ g, T* __restrict__ dm,
                   int C, int H, int W, int stride, float scale) {
  extern __shared__ float smem[];
  constexpr int r = K / 2;
  const int halo = r * stride;
  const int mw = kBwdTile + 2 * halo;
  float* qs = smem;                                 // [chunk][16][mw]
  float* gs = smem + kBwdChunk * kBwdTile * mw;     // [K][16][mw]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBwdTile + tx;
  const int nthreads = kBwdTile * kBwdTile;
  const int x0 = blockIdx.x * kBwdTile, y0 = blockIdx.y * kBwdTile;
  const int nchunks = (C + kBwdChunk - 1) / kBwdChunk;
  const int b = blockIdx.z / nchunks;
  const int c0 = (blockIdx.z % nchunks) * kBwdChunk;
  const int cn = min(kBwdChunk, C - c0);
  const size_t plane = (size_t)H * W;
  const T* qb = q + ((size_t)b * C + c0) * plane;
  const T* gb = g + (size_t)b * K * K * plane;

  float acc[kBwdChunk];
#pragma unroll
  for (int cc = 0; cc < kBwdChunk; ++cc) acc[cc] = 0.f;

  for (int row = 0; row < K; ++row) {
    // the sources p - d_kk of this window row lie dy rows above the tile
    const int dy = (row - r) * stride;
    for (int i = tid; i < kBwdChunk * kBwdTile * mw; i += nthreads) {
      const int cc = i / (kBwdTile * mw);
      const int p = i % (kBwdTile * mw);
      const int yy = y0 + p / mw - dy, xx = x0 - halo + p % mw;
      const bool in = cc < cn && yy >= 0 && yy < H && xx >= 0 && xx < W;
      qs[i] = in ? to_float(qb[cc * plane + (size_t)yy * W + xx]) : 0.f;
    }
    for (int i = tid; i < K * kBwdTile * mw; i += nthreads) {
      const int j = i / (kBwdTile * mw);
      const int p = i % (kBwdTile * mw);
      const int yy = y0 + p / mw - dy, xx = x0 - halo + p % mw;
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      gs[i] = in ? to_float(gb[(size_t)(row * K + j) * plane + (size_t)yy * W + xx]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < K; ++j) {
      // x - dx*s in the staged row: dx = j - r
      const int col = tx + (K - 1 - j) * stride;
      const float gv = gs[(j * kBwdTile + ty) * mw + col];
#pragma unroll
      for (int cc = 0; cc < kBwdChunk; ++cc)
        acc[cc] = fmaf(gv, qs[(cc * kBwdTile + ty) * mw + col], acc[cc]);
    }
    __syncthreads();
  }

  const int x = x0 + tx, y = y0 + ty;
  if (x < W && y < H) {
    T* out = dm + ((size_t)b * C + c0) * plane + (size_t)y * W + x;
#pragma unroll
    for (int cc = 0; cc < kBwdChunk; ++cc)
      if (cc < cn) out[cc * plane] = from_float<T>(acc[cc] * scale);
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int K>
cudaError_t launch_corr_bwd_k(const T* q, const T* m, const T* g, T* dq, T* dm, int B, int C,
                              int H, int W, int stride, cudaStream_t stream) {
  const int mw = bwd_row_width(K / 2, stride);
  const size_t smem_dq = sizeof(float) * kBwdChunk * kBwdTile * mw;
  const size_t smem_dm = sizeof(float) * (kBwdChunk + K) * kBwdTile * mw;
  cudaError_t e = allow_smem(corr_bwd_dq_kernel<T, K>, smem_dq);
  if (e != cudaSuccess) return e;
  e = allow_smem(corr_bwd_dm_kernel<T, K>, smem_dm);
  if (e != cudaSuccess) return e;
  const int nchunks = (C + kBwdChunk - 1) / kBwdChunk;
  const dim3 grid((W + kBwdTile - 1) / kBwdTile, (H + kBwdTile - 1) / kBwdTile, B * nchunks);
  const dim3 block(kBwdTile, kBwdTile);
  const float scale = 1.0f / sqrtf((float)C);
  corr_bwd_dq_kernel<T, K><<<grid, block, smem_dq, stream>>>(m, g, dq, C, H, W, stride, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  corr_bwd_dm_kernel<T, K><<<grid, block, smem_dm, stream>>>(q, g, dm, C, H, W, stride, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_corr_bwd(const T* q, const T* m, const T* g, T* dq, T* dm, int B, int C,
                            int H, int W, int radius, int stride, cudaStream_t stream) {
  switch (radius) {
    case 1: return launch_corr_bwd_k<T, 3>(q, m, g, dq, dm, B, C, H, W, stride, stream);
    case 2: return launch_corr_bwd_k<T, 5>(q, m, g, dq, dm, B, C, H, W, stride, stream);
    case 3: return launch_corr_bwd_k<T, 7>(q, m, g, dq, dm, B, C, H, W, stride, stream);
    case 4: return launch_corr_bwd_k<T, 9>(q, m, g, dq, dm, B, C, H, W, stride, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace csof

extern "C" int csof_corr_backward(const void* q, const void* m, const void* g, void* dq,
                                  void* dm, int B, int C, int H, int W, int radius, int stride,
                                  int dtype_code, void* stream) {
  using namespace csof;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype_code == kFloat32) {
    e = launch_corr_bwd(static_cast<const float*>(q), static_cast<const float*>(m),
                        static_cast<const float*>(g), static_cast<float*>(dq),
                        static_cast<float*>(dm), B, C, H, W, radius, stride, s);
  } else if (dtype_code == kBFloat16) {
    using bf = __nv_bfloat16;
    e = launch_corr_bwd(static_cast<const bf*>(q), static_cast<const bf*>(m),
                        static_cast<const bf*>(g), static_cast<bf*>(dq), static_cast<bf*>(dm),
                        B, C, H, W, radius, stride, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
