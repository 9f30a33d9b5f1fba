// K1: local correlation volume, channel-major in and out.
//
//   out[b, kk, h, w] = sum_c q[b, c, h, w] * m[b, c, h + s*dy, w + s*dx] / sqrt(C)
//   kk = (dy + r) * (2r + 1) + (dx + r),  m = 0 outside the image
//
// Replaces the TPU kernel csof_tpu/ops/pallas/corr.py
// local_correlation_volume_pallas_batched / _corr_tile_kernel.
//
// What bounds it on the H100: bytes. Each output value costs C multiply-adds
// and is written once; at the SegFlow levels (C = 32/64/128, 81 offsets) the
// kernel reads q and m once per window row from L2 and writes 81 planes,
// far below the card's FLOP rate. The design keeps the reads on chip: a block
// owns a 16x16 output tile and ONE window row dy; it stages a channel chunk of
// the q tile and of the m rows it needs (tile + r*s halo on both sides of the
// row, zero outside the image) in shared memory, and each thread accumulates
// the 2r+1 offsets of its pixel along that row in float32 registers. So m is
// read from device memory once per window row instead of once per offset, and
// the 81 output planes are written with coalesced stores.
#include "common.cuh"

namespace csof {
namespace {

constexpr int kCorrTile = 16;  // output tile edge (pixels)
constexpr int kCorrChunk = 8;  // channels staged per pass

__host__ __device__ inline int corr_row_width(int radius, int stride) {
  return kCorrTile + 2 * radius * stride;
}

inline size_t corr_smem_bytes(int radius, int stride) {
  return sizeof(float) * kCorrChunk * kCorrTile *
         (kCorrTile + corr_row_width(radius, stride));
}

// grid (ceil(W/16), ceil(H/16), B * K), block (16, 16); blockIdx.z = b*K + window row
template <typename T, int K>
__global__ void __launch_bounds__(kCorrTile * kCorrTile)
corr_kernel(const T* __restrict__ q, const T* __restrict__ m, T* __restrict__ out,
            int C, int H, int W, int stride, float scale) {
  extern __shared__ float smem[];
  constexpr int r = K / 2;
  const int halo = r * stride;
  const int mw = corr_row_width(r, stride);
  float* qs = smem;                                  // [chunk][16][16]
  float* ms = smem + kCorrChunk * kCorrTile * kCorrTile;  // [chunk][16][mw]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCorrTile + tx;
  const int nthreads = kCorrTile * kCorrTile;
  const int x0 = blockIdx.x * kCorrTile, y0 = blockIdx.y * kCorrTile;
  const int b = blockIdx.z / K, row = blockIdx.z % K;
  const int dy = (row - r) * stride;
  const size_t plane = (size_t)H * W;
  const T* qb = q + (size_t)b * C * plane;
  const T* mb = m + (size_t)b * C * plane;

  float acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCorrChunk) {
    for (int i = tid; i < kCorrChunk * kCorrTile * kCorrTile; i += nthreads) {
      const int c = c0 + i / (kCorrTile * kCorrTile);
      const int p = i % (kCorrTile * kCorrTile);
      const int yy = y0 + p / kCorrTile, xx = x0 + p % kCorrTile;
      qs[i] = (c < C && yy < H && xx < W) ? to_float(qb[c * plane + (size_t)yy * W + xx]) : 0.f;
    }
    for (int i = tid; i < kCorrChunk * kCorrTile * mw; i += nthreads) {
      const int c = c0 + i / (kCorrTile * mw);
      const int p = i % (kCorrTile * mw);
      const int yy = y0 + dy + p / mw, xx = x0 - halo + p % mw;
      const bool in = c < C && yy >= 0 && yy < H && xx >= 0 && xx < W;
      ms[i] = in ? to_float(mb[c * plane + (size_t)yy * W + xx]) : 0.f;
    }
    __syncthreads();
    const int cn = min(kCorrChunk, C - c0);
    for (int cc = 0; cc < cn; ++cc) {
      const float qv = qs[(cc * kCorrTile + ty) * kCorrTile + tx];
      const float* mrow = ms + (cc * kCorrTile + ty) * mw + tx;
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j] = fmaf(qv, mrow[j * stride], acc[j]);
    }
    __syncthreads();
  }

  const int x = x0 + tx, y = y0 + ty;
  if (x < W && y < H) {
    T* ob = out + ((size_t)b * K * K + (size_t)row * K) * plane + (size_t)y * W + x;
#pragma unroll
    for (int j = 0; j < K; ++j) ob[j * plane] = from_float<T>(acc[j] * scale);
  }
}

template <typename T, int K>
cudaError_t launch_corr_k(const T* q, const T* m, T* out, int B, int C, int H, int W,
                          int stride, cudaStream_t stream) {
  const size_t smem = corr_smem_bytes(K / 2, stride);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        corr_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + kCorrTile - 1) / kCorrTile, (H + kCorrTile - 1) / kCorrTile, B * K);
  const dim3 block(kCorrTile, kCorrTile);
  corr_kernel<T, K><<<grid, block, smem, stream>>>(q, m, out, C, H, W, stride,
                                                  1.0f / sqrtf((float)C));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_corr(const T* q, const T* m, T* out, int B, int C, int H, int W,
                        int radius, int stride, cudaStream_t stream) {
  switch (radius) {
    case 1: return launch_corr_k<T, 3>(q, m, out, B, C, H, W, stride, stream);
    case 2: return launch_corr_k<T, 5>(q, m, out, B, C, H, W, stride, stream);
    case 3: return launch_corr_k<T, 7>(q, m, out, B, C, H, W, stride, stream);
    case 4: return launch_corr_k<T, 9>(q, m, out, B, C, H, W, stride, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace csof

extern "C" int csof_corr_forward(const void* q, const void* m, void* out, int B, int C,
                                 int H, int W, int radius, int stride, int dtype_code,
                                 void* stream) {
  using namespace csof;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype_code == kFloat32) {
    e = launch_corr(static_cast<const float*>(q), static_cast<const float*>(m),
                    static_cast<float*>(out), B, C, H, W, radius, stride, s);
  } else if (dtype_code == kBFloat16) {
    e = launch_corr(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(m),
                    static_cast<__nv_bfloat16*>(out), B, C, H, W, radius, stride, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* csof_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
