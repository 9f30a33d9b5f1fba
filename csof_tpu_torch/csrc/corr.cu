// K1: local correlation volume, channel-major in and out.
//
//   out[b, kk, h, w] = sum_c q[b, c, h, w] * m[b, c, h + s*dy, w + s*dx] / sqrt(C)
//   kk = (dy + r) * (2r + 1) + (dx + r),  m = 0 outside the image
//
// The sum is taken in float32 and rounded once to the dtype. Both dtypes,
// radius 1-4, any stride, any H x W.
//
// Replaces the TPU kernel csof_tpu/ops/pallas/corr.py
// local_correlation_volume_pallas_batched / _corr_tile_kernel. It serves K3's
// first pass (skipfuse.cu), the unfused serving modes and CorrFunction's
// forward in the SegFlow training step.
//
// What bounds it on the H100: bytes, and just behind them the FP32 cores. At
// the SegFlow levels (C = 32/64/128, r = 4, B = 8 bf16) the 81 output planes
// are about 28 MB written (0.017 ms at 3.35 TB/s) and the window products
// about 1.2 GFLOP (0.018 ms at 67 TFLOP/s). The FP32 cores are enough for
// that; the limit of a direct design is shared memory, which serves only one
// 4-byte value a lane per FMA's worth of instruction slots.
//
// The design: one block per output tile (32 columns x 4 rows for float32,
// x 8 rows for bf16) for all (2r+1)^2 offsets, so q is staged once; one warp
// per window row. Channels come in chunks of 8 (2 at strides past 2), copied
// by 16-byte cp.async into a two-stage ring of shared memory (the q tile,
// and the m rows of the tile plus r*s halo rows and columns, zero-filled
// outside the image), so that chunk c + 1 is in flight while chunk c is
// used. Register blocking: each thread owns P horizontally adjacent output
// pixels (P = 4 float32, 8 bf16: one 16-byte group) of one window row, loads
// its q group and the P + 2rs values of the m row it slides along (P + 2r at
// stride 1, P + 4r at stride 2) with 16-byte loads, and does (2r+1) * P FMAs
// from them; the sums stay in (2r+1) * P registers. Each of its 2r+1 output
// planes is written with one 16-byte store. A width that is not a multiple
// of P, or an unaligned tensor, takes element copies and stores instead;
// strides past 2 index the m row in shared memory instead of registers.
//
// What it leaves on the table: the m halo is restaged for every tile (7.5x
// the tile at stride 2 for float32, from L2); all 2r+1 warps of a block read
// the same q values; bf16 is widened on each read; at radius 4 a block holds
// 9 warps of 168 registers, one block an SM, with a little spilling; at the
// 32 x 32 level the bf16 grid is 32 blocks (4 pixels a thread measured
// faster there and slower at the two larger levels, PERF.md); the tensor
// cores (a banded GEMM per window row, keeping 2r+1 diagonals of a product)
// are not used.
#include "common.cuh"

namespace csof {
namespace {

constexpr int kCorrTW = 32;  // output tile columns

// elements of a 16-byte copy group, pixels a thread (one 16-byte group),
// threads across a tile row, tile rows
template <typename T>
struct CorrGeom {
  static constexpr int kG = 16 / sizeof(T);
  static constexpr int kP = 16 / sizeof(T);
  static constexpr int kTX = kCorrTW / kP;
  static constexpr int kTH = 32 / kTX;
};

// The staged m rows of a tile for radius r and stride s: halo = r*s rows
// and columns around it, the columns rounded up to 16-byte groups (a)
struct MGeom {
  int halo, a, rows, cols;
};
template <typename T>
__host__ __device__ inline MGeom m_geom(int r, int s) {
  constexpr int G = CorrGeom<T>::kG;
  const int halo = r * s, a = (halo + G - 1) / G * G;
  return {halo, a, CorrGeom<T>::kTH + 2 * halo, kCorrTW + 2 * a};
}
template <typename T>
inline size_t corr_smem_bytes(int r, int s, int ch) {
  const MGeom g = m_geom<T>(r, s);
  return 2 * (size_t)ch * (CorrGeom<T>::kTH * kCorrTW + g.rows * g.cols) * sizeof(T);
}

// P values of shared memory as float32 (one vector load), and P float32
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

// grid (row tiles x column tiles, B), block 32 * K: warp j = window row j.
// S = the stride when it is a template constant (1, 2), else 0 (read from
// `stride`); CH = channels a chunk; vec = 1 when W is a multiple of P and
// q, m, out are 16-byte aligned (16-byte copies and stores), else 0.
template <typename T, int K, int S, int CH>
__global__ void __launch_bounds__(32 * K)
corr_kernel(const T* __restrict__ q, const T* __restrict__ m, T* __restrict__ out, int C,
            int H, int W, int stride, float scale, int vec) {
  using Geo = CorrGeom<T>;
  constexpr int P = Geo::kP, G = Geo::kG, TX = Geo::kTX, TH = Geo::kTH, r = K / 2;
  constexpr int kThreads = 32 * K;
  const int s = S > 0 ? S : stride;
  const MGeom mg = m_geom<T>(r, s);
  const int MR = mg.rows, MW = mg.cols;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int qstage = CH * TH * kCorrTW, stage = qstage + CH * MR * MW;

  const int tiles_w = (W + kCorrTW - 1) / kCorrTW;
  const int y0 = (blockIdx.x / tiles_w) * TH, x0 = (blockIdx.x % tiles_w) * kCorrTW;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, j = tid / 32, lane = tid % 32;
  const int ty = lane / TX, p0 = (lane % TX) * P;
  const size_t plane = (size_t)H * W;
  const T* qb = q + (size_t)b * C * plane;
  const T* mb = m + (size_t)b * C * plane;
  const int nchunks = (C + CH - 1) / CH;

  auto load_chunk = [&](int ck) {
    T* sq = smem + (ck % 2) * stage;
    T* sm = sq + qstage;
    const int c0 = ck * CH;
    // q: CH x TH rows of the tile; m: CH x MR rows of MW columns from
    // (y0 - halo, x0 - a)
    const int qn = CH * TH * kCorrTW, mn = CH * MR * MW;
    if (vec) {
      for (int i = tid * G; i < qn; i += kThreads * G) {
        const int row = i / kCorrTW, c = c0 + row / TH, yy = y0 + row % TH;
        const int xx = x0 + i % kCorrTW;
        const bool ok = c < C && yy < H && xx < W;
        cp_async16_zfill(smem_addr(sq + i), ok ? qb + c * plane + (size_t)yy * W + xx : qb, ok);
      }
      for (int i = tid * G; i < mn; i += kThreads * G) {
        const int row = i / MW, c = c0 + row / MR, yy = y0 - mg.halo + row % MR;
        const int xx = x0 - mg.a + i % MW;
        const bool ok = c < C && yy >= 0 && yy < H && xx >= 0 && xx < W;
        cp_async16_zfill(smem_addr(sm + i), ok ? mb + c * plane + (size_t)yy * W + xx : mb, ok);
      }
    } else {
      for (int i = tid; i < qn; i += kThreads) {
        const int row = i / kCorrTW, c = c0 + row / TH, yy = y0 + row % TH;
        const int xx = x0 + i % kCorrTW;
        const bool ok = c < C && yy < H && xx < W;
        sq[i] = ok ? qb[c * plane + (size_t)yy * W + xx] : from_float<T>(0.f);
      }
      for (int i = tid; i < mn; i += kThreads) {
        const int row = i / MW, c = c0 + row / MR, yy = y0 - mg.halo + row % MR;
        const int xx = x0 - mg.a + i % MW;
        const bool ok = c < C && yy >= 0 && yy < H && xx >= 0 && xx < W;
        sm[i] = ok ? mb[c * plane + (size_t)yy * W + xx] : from_float<T>(0.f);
      }
    }
  };

  float acc[P][K];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < K; ++i) acc[p][i] = 0.f;

  load_chunk(0);
  cp_async_commit();
  for (int ck = 0; ck < nchunks; ++ck) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ck has landed; every warp is done with ck - 1
    if (ck + 1 < nchunks) load_chunk(ck + 1);
    cp_async_commit();
    const T* sq = smem + (ck % 2) * stage;
    const T* sm = sq + qstage;
#pragma unroll 2
    for (int cc = 0; cc < CH; ++cc) {
      float qv[P];
      load_p<P>(sq + (cc * TH + ty) * kCorrTW + p0, qv);
      const T* mrow = sm + (cc * MR + ty + j * s) * MW + p0;
      if constexpr (S > 0) {
        // the m values this thread slides along: its pixels' columns from
        // kOff - rS on, loaded as NG vectors of P from the P-aligned column
        // below, kOff of them before the first one it uses
        constexpr int kA = (r * S + G - 1) / G * G, kBase = (kA - r * S) / P * P;
        constexpr int kOff = kA - r * S - kBase;
        constexpr int NG = (kOff + P + (K - 1) * S + P - 1) / P;
        float win[NG * P];
#pragma unroll
        for (int g = 0; g < NG; ++g) load_p<P>(mrow + kBase + g * P, win + g * P);
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int i = 0; i < K; ++i) acc[p][i] = fmaf(qv[p], win[kOff + p + i * S], acc[p][i]);
      } else {
        const int off = mg.a - mg.halo;
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int i = 0; i < K; ++i)
            acc[p][i] = fmaf(qv[p], to_float(mrow[off + p + i * s]), acc[p][i]);
      }
    }
  }

  const int y = y0 + ty, x = x0 + p0;
  if (y >= H || x >= W) return;
  T* ob = out + ((size_t)b * K * K + (size_t)j * K) * plane + (size_t)y * W + x;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float v[P];
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = acc[p][i] * scale;
    if (vec) {  // W is a multiple of P: the group lies inside the row
      store_p<P>(ob + i * plane, v);
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (x + p < W) ob[i * plane + p] = from_float<T>(v[p]);
    }
  }
}

template <typename T, int K, int S, int CH>
cudaError_t launch_corr_k(const T* q, const T* m, T* out, int B, int C, int H, int W,
                          int stride, int vec, cudaStream_t stream) {
  using Geo = CorrGeom<T>;
  const size_t smem = corr_smem_bytes<T>(K / 2, stride, CH);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;  // a halo too large to stage
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        corr_kernel<T, K, S, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(((H + Geo::kTH - 1) / Geo::kTH) * ((W + kCorrTW - 1) / kCorrTW), B);
  corr_kernel<T, K, S, CH><<<grid, 32 * K, smem, stream>>>(q, m, out, C, H, W, stride,
                                                          1.0f / sqrtf((float)C), vec);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_corr_s(const T* q, const T* m, T* out, int B, int C, int H, int W,
                          int stride, int vec, cudaStream_t stream) {
  switch (stride) {
    case 1: return launch_corr_k<T, K, 1, 8>(q, m, out, B, C, H, W, stride, vec, stream);
    case 2: return launch_corr_k<T, K, 2, 8>(q, m, out, B, C, H, W, stride, vec, stream);
    default: return launch_corr_k<T, K, 0, 2>(q, m, out, B, C, H, W, stride, vec, stream);
  }
}

template <typename T>
cudaError_t launch_corr(const T* q, const T* m, T* out, int B, int C, int H, int W,
                        int radius, int stride, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = W % CorrGeom<T>::kG == 0 && aligned(q) && aligned(m) && aligned(out);
  switch (radius) {
    case 1: return launch_corr_s<T, 3>(q, m, out, B, C, H, W, stride, vec, stream);
    case 2: return launch_corr_s<T, 5>(q, m, out, B, C, H, W, stride, vec, stream);
    case 3: return launch_corr_s<T, 7>(q, m, out, B, C, H, W, stride, vec, stream);
    case 4: return launch_corr_s<T, 9>(q, m, out, B, C, H, W, stride, vec, stream);
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
  if (B <= 0 || B > 65535 || C <= 0 || H <= 0 || W <= 0 || stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
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
