// K2: backward of the local correlation volume (K1), channel-major, in the
// gather form (no scatter, no atomics: the result is deterministic).
//
//   dq[b, c, p] = (1/sqrt C) sum_kk g[b, kk, p]        * m[b, c, p + d_kk]
//   dm[b, c, p] = (1/sqrt C) sum_kk g[b, kk, p - d_kk] * q[b, c, p - d_kk]
//   d_kk = s * (dy, dx),  kk = (dy + r) * (2r + 1) + (dx + r)
//
// with every term whose sample falls outside the image zero. q, m, dq, dm are
// (B, C, H, W) and g is (B, (2r+1)^2, H, W), all in the model dtype; the sums
// run in float32 and are rounded once, after the scale. Both dtypes, radius
// 1-4, any stride, any H x W.
//
// Replaces the TPU kernels csof_tpu/ops/pallas/corr.py _corr_bwd_pallas_v2
// (_corr_bwd_dq_kernel, _corr_bwd_dm_kernel) and _corr_bwd_pallas
// (_corr_bwd_tile_kernel), which compute the same pair.
//
// What bounds it on the H100: bytes. At the SegFlow levels (B = 4, r = 4,
// bf16) q, m, g read once and dq, dm written once are 43 MB (0.013 ms at
// 3.35 TB/s); the window products are 1.2 GFLOP, 0.018 ms even on the FP32
// cores, which are enough. The tensor cores (a banded GEMM per window row,
// keeping 2r+1 diagonals of a 32 x 32 product) would do about 8x the useful
// FLOPs to save FMAs that are not the limit, so they are not used.
//
// The design, after K1 (corr.cu): one block per output tile (32 columns x 4
// rows) and 32 channels, in one launch for dq and dm. Warps 0-3 compute dq
// and warps 4-7 dm, each warp for 8 of the 32 channels. The block walks the
// 2r+1 window rows; for each, a ring stage holds the q rows (dy above the
// tile, for dm) and the m rows (dy below, for dq) of CS channels (bf16 32,
// float32 16, 8 at strides past 2), tile plus r*s halo columns, and the
// first stage of a window row also brings that row's 2r+1 g planes, rows
// y0 - max(dy, 0) to y0 + TH + max(-dy, 0), with the halo columns: dq reads
// their centre (rows of the tile), dm reads them dy rows up and shifted by
// -dx, so each staged g value feeds both outputs, once for all 32 channels.
// Copies are 16-byte cp.async, zero-filled outside the image, into a
// two-stage ring for q and m and two g buffers (by window-row parity): the
// next stage is in flight while the current one is used. Operands stay in
// the input dtype in shared memory.
//
// Register blocking: a thread owns P = 4 horizontally adjacent pixels of
// one tile row (16 bytes of float32, 8 of bf16). At the first stage of a
// window row it loads its (2r+1) x 4 g values into registers (dq: one
// vector a plane; dm: the two vectors around the shifted 4, picked at
// compile time). For each of its channels it then loads the 4 + 2rs values
// of the m row (dq) or the q row (dm) it slides along as vectors and does
// (2r+1) x 4 FMAs from registers. Its 8 channels x 4 sums stay in registers
// across the window rows; each output is written once, by that thread, with
// one vector store. At most 128 registers a thread (no spills, -Xptxas -v),
// so two blocks share an SM. 8 bf16 pixels a thread (one block an SM, up to
// 196 registers) and 8-channel stages for bf16 measured slower (PERF.md).
//
// The edge paths: a width that is not a multiple of the 16-byte group, or
// an unaligned tensor, takes element copies and stores; strides past 2 index
// the staged rows in shared memory per FMA instead of registers; a channel
// count that is not a multiple of the stage or of 32 zero-fills the missing
// channels.
//
// What it leaves on the table: q and m are restaged for each window row (at
// stride 1 the rows of neighbouring window rows overlap), the g rows of a
// window row again for each block of 32 channels (4x at C = 128), and bf16
// is widened on each read of shared memory (20 conversions for 36 FMAs a
// channel at r = 4, stride 2).
#include "common.cuh"

namespace csof {
namespace {

constexpr int kBwdTW = 32;                         // output tile columns
constexpr int kBwdCH = 32;                         // channels a block
constexpr int kBwdGroups = 4;                      // warps a role (dq, dm)
constexpr int kBwdThreads = 2 * kBwdGroups * 32;   // 256
constexpr int kBwdAcc = kBwdCH / kBwdGroups;       // channels a thread

// channels a ring stage at strides 1 and 2 (bf16 32, float32 16: two blocks
// fit an SM's shared memory), and 8 at strides past 2, whose wider halo
// would not fit twice
template <typename T>
__host__ __device__ constexpr int bwd_stage_channels(int S) {
  return S > 0 ? (sizeof(T) == 2 ? 32 : 16) : 8;
}

// elements of a 16-byte copy group, pixels a thread, threads across a tile
// row, tile rows
template <typename T>
struct BwdGeom {
  static constexpr int kG = 16 / sizeof(T);
  static constexpr int kP = 4;
  static constexpr int kTX = kBwdTW / kP;
  static constexpr int kTH = 32 / kTX;
};

// Shared memory for radius r, stride s, in elements: halo = r*s columns on
// each side, rounded up to copy groups (a); one ring stage (qm: the q rows,
// then the m rows, of cs channels); one g buffer (2r+1 planes of grows rows)
struct BwdLayout {
  int halo, a, cols, grows, qm, gbuf;
};
template <typename T>
__host__ __device__ inline BwdLayout bwd_layout(int r, int s, int cs) {
  constexpr int G = BwdGeom<T>::kG, TH = BwdGeom<T>::kTH;
  const int halo = r * s, a = (halo + G - 1) / G * G, cols = kBwdTW + 2 * a;
  const int grows = TH + halo;  // TH + |dy| rows at most
  return {halo, a, cols, grows, 2 * cs * TH * cols, (2 * r + 1) * grows * cols};
}
template <typename T>
inline size_t bwd_smem_bytes(int r, int s, int cs) {
  const BwdLayout L = bwd_layout<T>(r, s, cs);
  return 2 * (size_t)(L.qm + L.gbuf) * sizeof(T);
}

// grid (row tiles x column tiles, ceil(C / 32), B), block 256. S = the
// stride when it is a template constant (1, 2), else 0 (read from
// `stride`); vec = 1 when W is a multiple of the copy group and every
// tensor is 16-byte aligned (16-byte copies, vector stores), else 0.
template <typename T, int K, int S>
__global__ void __launch_bounds__(kBwdThreads, 2)
corr_bwd_kernel(const T* __restrict__ q, const T* __restrict__ m, const T* __restrict__ g,
                T* __restrict__ dq, T* __restrict__ dm, int C, int H, int W, int stride,
                float scale, int vec) {
  using Geo = BwdGeom<T>;
  constexpr int P = Geo::kP, G = Geo::kG, TX = Geo::kTX, TH = Geo::kTH, r = K / 2;
  constexpr int CS = bwd_stage_channels<T>(S), NS = kBwdCH / CS, PER = CS / kBwdGroups;
  const int s = S > 0 ? S : stride;
  const BwdLayout L = bwd_layout<T>(r, s, CS);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* gsm = smem + 2 * L.qm;  // two g buffers of L.gbuf, by window-row parity

  const int tiles_w = (W + kBwdTW - 1) / kBwdTW;
  const int y0 = (blockIdx.x / tiles_w) * TH, x0 = (blockIdx.x % tiles_w) * kBwdTW;
  const int c0 = blockIdx.y * kBwdCH, b = blockIdx.z;
  const int cn = min(kBwdCH, C - c0);
  const int ns = (cn + CS - 1) / CS;  // ring stages a window row
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool is_dm = warp >= kBwdGroups;
  const int cg = warp % kBwdGroups;
  const int ty = lane / TX, p0 = (lane % TX) * P;
  const size_t plane = (size_t)H * W;
  const T* qb = q + ((size_t)b * C + c0) * plane;
  const T* mb = m + ((size_t)b * C + c0) * plane;
  const T* gb = g + (size_t)b * K * K * plane;
  const int n_op = CS * TH * L.cols;  // elements of q (or m) a stage

  // one copy into shared memory: 16 bytes (vec) or one element, zero
  // outside the image
  auto copy = [&](T* dst, const T* base, size_t off, bool ok) {
    if (vec) {
      cp_async16_zfill(smem_addr(dst), ok ? base + off : base, ok);
    } else {
      *dst = ok ? base[off] : from_float<T>(0.f);
    }
  };
  // stage t of the ring: window row j = t / ns, channels 8k .. 8k+7 of the
  // block (k = t % ns); k = 0 also brings window row j's g planes
  auto load_stage = [&](int t) {
    const int j = t / ns, k = t % ns, dy = (j - r) * s;
    T* sq = smem + (t % 2) * L.qm;
    const int step = vec ? G : 1;
    for (int i = tid * step; i < 2 * n_op; i += kBwdThreads * step) {
      const int op = i / n_op, e = i % n_op, row = e / L.cols, col = e % L.cols;
      const int c = k * CS + row / TH;
      const int yy = y0 + row % TH + (op ? dy : -dy), xx = x0 - L.a + col;
      const bool ok = c < cn && yy >= 0 && yy < H && xx >= 0 && xx < W;
      copy(sq + i, op ? mb : qb, (size_t)c * plane + (size_t)yy * W + xx, ok);
    }
    if (k != 0) return;
    T* sg = gsm + (j % 2) * L.gbuf;
    const int grows = TH + abs(dy), glo = y0 - max(dy, 0), n_pl = grows * L.cols;
    for (int i = tid * step; i < K * n_pl; i += kBwdThreads * step) {
      const int pl = i / n_pl, e = i % n_pl, row = e / L.cols, col = e % L.cols;
      const int yy = glo + row, xx = x0 - L.a + col;
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
      copy(sg + pl * L.grows * L.cols + e, gb,
           (size_t)(j * K + pl) * plane + (size_t)yy * W + xx, ok);
    }
  };

  float acc[kBwdAcc][P];
#pragma unroll
  for (int u = 0; u < kBwdAcc; ++u)
#pragma unroll
    for (int p = 0; p < P; ++p) acc[u][p] = 0.f;
  float gr[K][P];  // this thread's g values of the current window row

  const int total = K * ns;
  int t = 0;
  load_stage(0);
  cp_async_commit();
  for (int j = 0; j < K; ++j) {
    const int dy = (j - r) * s;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      if (k >= ns) continue;  // uniform across the block
      cp_async_wait<0>();
      __syncthreads();  // stage t has landed; every warp is done with t - 1
      if (t + 1 < total) load_stage(t + 1);
      cp_async_commit();
      if (k == 0) {
        // dq: g at the thread's own pixels (rows of the tile); dm: g at the
        // sources p - d_kk, dy rows up and dx columns left
        const T* sg = gsm + (j % 2) * L.gbuf;
        const T* grow = sg + (ty + max(is_dm ? -dy : dy, 0)) * L.cols + L.a + p0;
        if (!is_dm) {
#pragma unroll
          for (int i = 0; i < K; ++i) load_p<P>(grow + i * L.grows * L.cols, gr[i]);
        } else if constexpr (S > 0) {
#pragma unroll
          for (int i = 0; i < K; ++i) {
            constexpr int kA = (r * S + G - 1) / G * G;
            const int off = (r - i) * S;  // column of pixel 0's source, from p0 + kA
            const int lo = (kA + off) / P * P, sh = (kA + off) % P;
            float v[2 * P];
            load_p<P>(grow - kA + i * L.grows * L.cols + lo, v);
            if (sh != 0) load_p<P>(grow - kA + i * L.grows * L.cols + lo + P, v + P);
#pragma unroll
            for (int p = 0; p < P; ++p) gr[i][p] = v[sh + p];
          }
        } else {
#pragma unroll
          for (int i = 0; i < K; ++i)
#pragma unroll
            for (int p = 0; p < P; ++p)
              gr[i][p] = to_float(grow[i * L.grows * L.cols + p + (r - i) * s]);
        }
      }
      const T* sq = smem + (t % 2) * L.qm + (is_dm ? 0 : n_op);
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int sub = cg + kBwdGroups * u;
        float* a = acc[k * PER + u];
        // the row this thread slides along, from column x0 - halo + p0
        const T* row = sq + (sub * TH + ty) * L.cols + p0;
        if constexpr (S > 0) {
          constexpr int kA = (r * S + G - 1) / G * G, kBase = (kA - r * S) / P * P;
          constexpr int kOff = kA - r * S - kBase;
          constexpr int NG = (kOff + P + (K - 1) * S + P - 1) / P;
          float win[NG * P];
#pragma unroll
          for (int v = 0; v < NG; ++v) load_p<P>(row + kBase + v * P, win + v * P);
          // the window offsets must be compile-time constants (else win
          // lives in local memory): one loop for each role
          if (is_dm) {
#pragma unroll
            for (int i = 0; i < K; ++i)
#pragma unroll
              for (int p = 0; p < P; ++p)
                a[p] = fmaf(gr[i][p], win[kOff + (K - 1 - i) * S + p], a[p]);
          } else {
#pragma unroll
            for (int i = 0; i < K; ++i)
#pragma unroll
              for (int p = 0; p < P; ++p) a[p] = fmaf(gr[i][p], win[kOff + i * S + p], a[p]);
          }
        } else {
          const int off = L.a - L.halo;
#pragma unroll
          for (int i = 0; i < K; ++i) {
            const int o = off + (is_dm ? K - 1 - i : i) * s;
#pragma unroll
            for (int p = 0; p < P; ++p) a[p] = fmaf(gr[i][p], to_float(row[o + p]), a[p]);
          }
        }
      }
      ++t;
    }
  }

  const int y = y0 + ty, x = x0 + p0;
  if (y >= H || x >= W) return;
  T* ob = (is_dm ? dm : dq) + ((size_t)b * C + c0) * plane + (size_t)y * W + x;
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int c = k * CS + cg + kBwdGroups * u;
      if (c >= cn) continue;
      float v[P];
#pragma unroll
      for (int p = 0; p < P; ++p) v[p] = acc[k * PER + u][p] * scale;
      if (vec) {  // W is a multiple of P: the group lies inside the row
        store_p<P>(ob + c * plane, v);
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (x + p < W) ob[c * plane + p] = from_float<T>(v[p]);
      }
    }
}

template <typename T, int K, int S>
cudaError_t launch_corr_bwd_k(const T* q, const T* m, const T* g, T* dq, T* dm, int B, int C,
                              int H, int W, int stride, int vec, cudaStream_t stream) {
  using Geo = BwdGeom<T>;
  const size_t smem = bwd_smem_bytes<T>(K / 2, stride, bwd_stage_channels<T>(S));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;  // a halo too large to stage
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        corr_bwd_kernel<T, K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(((H + Geo::kTH - 1) / Geo::kTH) * ((W + kBwdTW - 1) / kBwdTW),
                  (C + kBwdCH - 1) / kBwdCH, B);
  corr_bwd_kernel<T, K, S><<<grid, kBwdThreads, smem, stream>>>(
      q, m, g, dq, dm, C, H, W, stride, 1.0f / sqrtf((float)C), vec);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_corr_bwd_s(const T* q, const T* m, const T* g, T* dq, T* dm, int B, int C,
                              int H, int W, int stride, int vec, cudaStream_t stream) {
  switch (stride) {
    case 1: return launch_corr_bwd_k<T, K, 1>(q, m, g, dq, dm, B, C, H, W, stride, vec, stream);
    case 2: return launch_corr_bwd_k<T, K, 2>(q, m, g, dq, dm, B, C, H, W, stride, vec, stream);
    default: return launch_corr_bwd_k<T, K, 0>(q, m, g, dq, dm, B, C, H, W, stride, vec, stream);
  }
}

template <typename T>
cudaError_t launch_corr_bwd(const T* q, const T* m, const T* g, T* dq, T* dm, int B, int C,
                            int H, int W, int radius, int stride, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = W % BwdGeom<T>::kG == 0 && aligned(q) && aligned(m) && aligned(g) &&
                  aligned(dq) && aligned(dm);
  switch (radius) {
    case 1: return launch_corr_bwd_s<T, 3>(q, m, g, dq, dm, B, C, H, W, stride, vec, stream);
    case 2: return launch_corr_bwd_s<T, 5>(q, m, g, dq, dm, B, C, H, W, stride, vec, stream);
    case 3: return launch_corr_bwd_s<T, 7>(q, m, g, dq, dm, B, C, H, W, stride, vec, stream);
    case 4: return launch_corr_bwd_s<T, 9>(q, m, g, dq, dm, B, C, H, W, stride, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace csof

// One launch computes dq and dm. The shared memory a block asks for is
// bwd_smem_bytes (ops/kernels/corr.py corr_bwd_geometry mirrors it).
extern "C" int csof_corr_backward(const void* q, const void* m, const void* g, void* dq,
                                  void* dm, int B, int C, int H, int W, int radius, int stride,
                                  int dtype_code, void* stream) {
  using namespace csof;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || C <= 0 || H <= 0 || W <= 0 || stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
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
