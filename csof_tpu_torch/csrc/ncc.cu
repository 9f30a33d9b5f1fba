// K4: the windowed normalized cross-correlation of two planes, as a float32
// map or as the clamped mean a loss takes.
//
//   S_X[y, x] = sum over the window x window box of X, zero outside the
//               plane, for X in (I, J, I*I, J*J, I*J); the box spans rows
//               y - w/2 ... y + w - 1 - w/2 (and columns likewise), so an
//               even window reaches one further up than down
//   mu_I = S_I / win, mu_J = S_J / win                       (win = window^2)
//   cross = S_IJ - mu_J S_I - mu_I S_J + mu_I mu_J win
//   var_I = S_II - 2 mu_I S_I + mu_I^2 win,  var_J likewise
//   cc = cross^2 / (var_I var_J + eps)
//   loss = 1 - mean(clamp(cc, 0.001, 0.999))
//
// Replaces the TPU kernel csof_tpu/ops/pallas/ncc.py ncc_map_pallas /
// _ncc_kernel (and ncc_loss_pallas around it), with its order of
// operations: each box sum is taken along H first (the window's rows, top
// to bottom), then along W (left to right), each add rounded, and the
// closing arithmetic rounds after every operation as the TPU kernel's array
// expression does (the _rn intrinsics keep the compiler from contracting a
// multiply and an add into one rounding). A running sum that adds the
// entering row and subtracts the leaving one would round differently, and
// in a near-constant window var cancels, so every output sums its w taps.
//
// What bounds it on the H100: its bytes (a float32 map reads I and J and
// writes cc, 12 bytes a pixel; the loss reads 8 and writes nothing) set the
// bound, but the instructions of that order of operations take longer: the
// 2 x 5 x (w - 1) rounded adds a pixel (80 at window 9) and the closing
// arithmetic, more than twice the adds in all, at no more than four
// blocks of 128 threads an SM (128 registers a thread). PERF.md has the
// measurements.
//
// The design. A block owns a band of rows of one plane at full width (a
// plane wider than one block's columns is cut into column tiles, each with
// a halo of w/2 columns rounded up to 4 on either side); the band's halo is
// only w - 1 rows. Input rows stream into shared memory in chunks of rows,
// by 16-byte cp.async (zero-filled outside the plane) into a ring of two
// chunks, so that the next chunk is in flight while one is summed; a row
// off the 16-byte grid, an unaligned tensor or a channels-last tensor with
// C > 1 takes element copies. Vertical pass: a thread owns one column of
// the band and slides down it; it keeps the last w rows of (I, J, I*I, J*J,
// I*J) in registers (window 9: a compile-time ring of 9, the chunk is 9
// rows so each ring slot is a constant), or, for any other window, in a
// shared ring of w rows that only that thread reads; the three products are
// taken once per input element. The five vertical sums of each output row
// go to a shared row; horizontal pass: a thread takes 4 adjacent outputs,
// reads the 4 + w - 1 sums of each of the five rows it needs with 16-byte
// loads (window 9: three), and adds them left to right in registers. Window
// 9 divides by its 81 taps without a divide instruction: a product by
// RN(1/81) and one FMA correction, which csof_ncc_check_division holds
// equal to the IEEE quotient for every float. In loss mode the input may be
// bf16 or fp16 (widened in registers, exactly as a cast), each cc is clamped
// and summed in the thread in a fixed order, the block's sum goes to a
// partial, and the last block to finish (a ticket) adds the partials in
// index order and writes 1 - mean: one launch, the same bits every run, and
// no map written.
//
// A window whose rings do not fit shared memory (above 75 on a plane wider
// than a block, F9) takes two passes instead: the five vertical sums of
// every pixel go to a scratch buffer in device memory, then a second kernel
// sums them along W and closes the NCC; the same roundings in the same
// order (csof_ncc_forward_wide). Any window >= 1 is computed.
#include <cuda_fp16.h>

#include <algorithm>
#include <atomic>
#include <climits>

#include "common.cuh"

namespace csof {
namespace {

__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

constexpr int kStages = 2;                 // chunks in the shared ring
constexpr int kMaxThreads = 256;           // threads a block: one a column of the tile
constexpr int kSpecialWindow = 9;          // the window compiled with a register ring
constexpr int kGenericChunk = 8;           // rows a chunk for any other window
constexpr int kMaxDynamicSmem = 226 * 1024;  // below 227 KB: the loss's static scratch
constexpr int kTicketSlots = 1024;

// the loss's last-block tickets: zero at load, reset by the block that
// takes the last one; a launch of either path takes the next slot from the
// one host counter, so launches in flight on several streams do not share one
__device__ unsigned g_ncc_tickets[kTicketSlots];
std::atomic<unsigned> g_next_ticket{0};

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// columns a tile reaches left and right of its own: w/2, rounded up to a
// 16-byte group of float32 sums
__host__ __device__ constexpr int ncc_halo(int window) { return round_up(window / 2, 4); }

// dynamic shared memory of a launch: the ring of input chunks (I and J rows
// of stage_cols elements), the vertical sums of one chunk's output rows,
// and, off the register path, each thread's ring of w rows of five values
inline size_t ncc_smem_bytes(int window, int threads, int tile_cols, size_t itemsize) {
  const int chunk = window == kSpecialWindow ? kSpecialWindow : kGenericChunk;
  const size_t stage_cols = threads + 32 / itemsize;
  size_t b = (size_t)kStages * chunk * 2 * stage_cols * itemsize;
  b += (size_t)chunk * 5 * (tile_cols + 2 * ncc_halo(window)) * 4;
  if (window != kSpecialWindow) b += (size_t)window * 5 * threads * 4;
  return b;
}

struct NccArgs {
  const void* pred;
  const void* target;
  float* cc;       // map mode: (planes, H, W) float32
  float* loss;     // loss mode: loss[0] the result, loss[1 + block] the partials
  int C, H, W;     // plane p = n * C + c reads (n, y, x, c) of (N, H, W, C)
  int window, tile_cols, band_rows, tiles, bands, stage_cols;
  int vec_in, vec_out, ticket;
  float eps;
  double count;    // pixels the mean is over
};

// RN(x / y) from r = RN(1 / y): q = RN(x r) and one FMA correction; where
// q y is x already (a zero keeps its sign) or x is not finite, q is the
// quotient. Exact for every float x at the divisors csof_ncc_check_division
// has checked (window 9: y = 81), not for every y.
__device__ __forceinline__ float div_by(float x, float y, float r) {
  const float q = __fmul_rn(x, r);
  const float e = __fmaf_rn(-q, y, x);
  return (e == 0.f || !isfinite(q)) ? q : __fmaf_rn(e, r, q);
}

// the TPU kernel's closing arithmetic, one rounding per operation; kExact:
// the division by win through div_by (window 9), else IEEE division
template <bool kExact>
__device__ __forceinline__ float ncc_value(float i_sum, float j_sum, float i2, float j2,
                                           float ij, float win, float rwin, float eps) {
  float i_mu, j_mu;
  if constexpr (kExact) {
    i_mu = div_by(i_sum, win, rwin), j_mu = div_by(j_sum, win, rwin);
  } else {
    i_mu = __fdiv_rn(i_sum, win), j_mu = __fdiv_rn(j_sum, win);
  }
  const float cross = __fadd_rn(
      __fsub_rn(__fsub_rn(ij, __fmul_rn(j_mu, i_sum)), __fmul_rn(i_mu, j_sum)),
      __fmul_rn(__fmul_rn(i_mu, j_mu), win));
  const float i_var = __fadd_rn(__fsub_rn(i2, __fmul_rn(__fmul_rn(2.f, i_mu), i_sum)),
                                __fmul_rn(__fmul_rn(i_mu, i_mu), win));
  const float j_var = __fadd_rn(__fsub_rn(j2, __fmul_rn(__fmul_rn(2.f, j_mu), j_sum)),
                                __fmul_rn(__fmul_rn(j_mu, j_mu), win));
  return __fdiv_rn(__fmul_rn(cross, cross), __fadd_rn(__fmul_rn(i_var, j_var), eps));
}

// clamp as torch.clamp: NaN stays NaN
__device__ __forceinline__ float clamp_cc(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.001f), 0.999f);
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// loss mode, after a block's last item: the block's thread sums (warp
// butterflies, then the warps in order) into its partial, and the last block
// to take a ticket adds every partial in index order, in double, and writes
// 1 - mean. The same bits every run.
__device__ __forceinline__ void finish_loss(float acc, const NccArgs& a) {
  __shared__ float wsum[kMaxThreads / 32];
  __shared__ double dsum[kMaxThreads / 32];
  __shared__ bool last;
  const int nt = blockDim.x, tid = threadIdx.x;
  const float v = warp_sum(acc);
  if ((tid & 31) == 0) wsum[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    float t = wsum[0];
    for (int i = 1; i < nt / 32; ++i) t = __fadd_rn(t, wsum[i]);
    a.loss[1 + blockIdx.x] = t;
    __threadfence();
    last = atomicAdd(&g_ncc_tickets[a.ticket], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {  // every other block's partial is written: add them in order
    __threadfence();
    double d = 0.0;
    for (int i = tid; i < (int)gridDim.x; i += nt) d += (double)__ldcg(a.loss + 1 + i);
    d = warp_sum_d(d);
    if ((tid & 31) == 0) dsum[tid >> 5] = d;
    __syncthreads();
    if (tid == 0) {
      double t = dsum[0];
      for (int i = 1; i < nt / 32; ++i) t += dsum[i];
      a.loss[0] = (float)(1.0 - t / a.count);
      g_ncc_tickets[a.ticket] = 0;
    }
  }
}

// grid (planes x bands x tiles), block = threads (one a column of the tile
// with its halo). WIN = 9: the register ring; WIN = 0: any window.
template <typename T, int WIN, bool LOSS>
__global__ void __launch_bounds__(kMaxThreads, 2) ncc_kernel(const NccArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = 16 / sizeof(T);  // elements of a 16-byte copy
  const int nt = blockDim.x, tid = threadIdx.x;
  const int window = WIN > 0 ? WIN : a.window;
  const int chunk = WIN > 0 ? WIN : kGenericChunk;
  const int lo = -(window / 2);  // the first tap's offset
  const int halo = ncc_halo(window);
  const int sc = a.stage_cols, vw = a.tile_cols + 2 * halo;
  T* stage = reinterpret_cast<T*>(smem);
  float* sv = reinterpret_cast<float*>(smem + (size_t)kStages * chunk * 2 * sc * sizeof(T));
  float* ring = sv + chunk * 5 * vw;  // WIN = 0: window slots x 5 x nt

  int b = blockIdx.x;
  const int tile = b % a.tiles;
  b /= a.tiles;
  const int band = b % a.bands, plane = b / a.bands;
  const int x0 = tile * a.tile_cols, y0 = band * a.band_rows;
  // the columns whose vertical sums the tile needs, inside the plane (the
  // sums outside are zero, as the TPU kernel's padding)
  const int vlo = max(x0 - halo, 0), vhi = min(x0 + a.tile_cols + halo, a.W);
  const int nv = vhi - vlo;
  const int ss = a.vec_in ? vlo / G * G : vlo;  // first staged column
  const int off = vlo - ss;
  const int ngr = (vhi - ss + G - 1) / G;       // 16-byte groups a staged row
  const int n = plane / a.C, c = plane - n * a.C;
  const size_t base = (size_t)n * a.H * a.W * a.C + c;
  const T* pI = static_cast<const T*>(a.pred) + base;
  const T* pJ = static_cast<const T*>(a.target) + base;
  const int rows_out = min(a.band_rows, a.H - y0);
  const int nchunks = (rows_out + window - 1 + chunk - 1) / chunk;

  for (int i = tid; i < chunk * 5 * vw; i += nt) sv[i] = 0.f;

  // band input row r = plane row y0 + lo + r; chunk ci holds rows
  // ci * chunk ... + chunk - 1 in ring slot ci % kStages
  auto issue = [&](int ci) {
    T* sI = stage + (size_t)(ci % kStages) * chunk * 2 * sc;
    T* sJ = sI + chunk * sc;
    const int yb = y0 + lo + ci * chunk;
    if (a.vec_in) {  // copy tid, tid + nt, ... of (row, group), stepped without a division
      const int dk = nt / ngr, dg = nt - dk * ngr;
      for (int k = tid / ngr, g = tid - k * ngr; k < chunk; k += dk, g += dg) {
        if (g >= ngr) g -= ngr, ++k;
        if (k >= chunk) break;
        const int y = yb + k;
        const bool in = y >= 0 && y < a.H;
        const size_t src = in ? (size_t)y * a.W + ss + g * G : 0;
        cp_async16_zfill(smem_addr(sI + k * sc + g * G), pI + src, in);
        cp_async16_zfill(smem_addr(sJ + k * sc + g * G), pJ + src, in);
      }
    } else if (tid < nv) {
      for (int k = 0; k < chunk; ++k) {
        const int y = yb + k;
        const bool in = y >= 0 && y < a.H;
        const size_t src = in ? ((size_t)y * a.W + vlo + tid) * a.C : 0;
        sI[k * sc + tid] = in ? pI[src] : from_float<T>(0.f);
        sJ[k * sc + tid] = in ? pJ[src] : from_float<T>(0.f);
      }
    }
  };

  float rI[WIN > 0 ? WIN : 1], rJ[WIN > 0 ? WIN : 1], rII[WIN > 0 ? WIN : 1],
      rJJ[WIN > 0 ? WIN : 1], rIJ[WIN > 0 ? WIN : 1];
  int wslot = 0;  // WIN = 0: the ring slot of the next input row

  // the thread's column: the five sums over the window's rows, top to
  // bottom, of each output row that chunk ci completes, into sv row k
  auto vertical = [&](int ci) {
    const T* sI = stage + (size_t)(ci % kStages) * chunk * 2 * sc + off + tid;
    const T* sJ = sI + chunk * sc;
    float* vout = sv + (vlo - x0 + halo) + tid;
    if constexpr (WIN > 0) {
#pragma unroll
      for (int k = 0; k < WIN; ++k) {
        const float vi = to_float(sI[k * sc]), vj = to_float(sJ[k * sc]);
        rI[k] = vi, rJ[k] = vj;
        rII[k] = __fmul_rn(vi, vi), rJJ[k] = __fmul_rn(vj, vj), rIJ[k] = __fmul_rn(vi, vj);
        const int y = ci * WIN + k - (WIN - 1);
        if (y >= 0 && y < rows_out) {
          // (k + 1) % WIN is the slot of the window's oldest row
          float s0 = rI[(k + 1) % WIN], s1 = rJ[(k + 1) % WIN],
                s2 = rII[(k + 1) % WIN], s3 = rJJ[(k + 1) % WIN], s4 = rIJ[(k + 1) % WIN];
#pragma unroll
          for (int o = 2; o <= WIN; ++o) {
            const int q = (k + o) % WIN;
            s0 = __fadd_rn(s0, rI[q]), s1 = __fadd_rn(s1, rJ[q]), s2 = __fadd_rn(s2, rII[q]);
            s3 = __fadd_rn(s3, rJJ[q]), s4 = __fadd_rn(s4, rIJ[q]);
          }
          float* v = vout + k * 5 * vw;
          v[0] = s0, v[vw] = s1, v[2 * vw] = s2, v[3 * vw] = s3, v[4 * vw] = s4;
        }
      }
    } else {
      for (int k = 0; k < chunk; ++k) {
        const float vi = to_float(sI[k * sc]), vj = to_float(sJ[k * sc]);
        float* w = ring + (size_t)wslot * 5 * nt + tid;
        w[0] = vi, w[nt] = vj;
        w[2 * nt] = __fmul_rn(vi, vi), w[3 * nt] = __fmul_rn(vj, vj);
        w[4 * nt] = __fmul_rn(vi, vj);
        wslot = wslot + 1 == window ? 0 : wslot + 1;  // now the oldest row's slot
        const int y = ci * chunk + k - (window - 1);
        if (y >= 0 && y < rows_out) {
          const float* p = ring + (size_t)wslot * 5 * nt + tid;
          float s0 = p[0], s1 = p[nt], s2 = p[2 * nt], s3 = p[3 * nt], s4 = p[4 * nt];
          int sl = wslot;
          for (int o = 1; o < window; ++o) {
            sl = sl + 1 == window ? 0 : sl + 1;
            p = ring + (size_t)sl * 5 * nt + tid;
            s0 = __fadd_rn(s0, p[0]), s1 = __fadd_rn(s1, p[nt]), s2 = __fadd_rn(s2, p[2 * nt]);
            s3 = __fadd_rn(s3, p[3 * nt]), s4 = __fadd_rn(s4, p[4 * nt]);
          }
          float* v = vout + k * 5 * vw;
          v[0] = s0, v[vw] = s1, v[2 * vw] = s2, v[3 * vw] = s3, v[4 * vw] = s4;
        }
      }
    }
  };

  const int ng = a.tile_cols / 4;  // 4-column groups a tile row
  const int kr0 = tid / ng, g0 = tid - kr0 * ng, dk = nt / ng, dg = nt - dk * ng;
  // window 9: 81 and RN(1/81) are constants of the code, not registers
  const float win = WIN > 0 ? (float)(WIN * WIN) : (float)(window * window);
  const float rwin = WIN > 0 ? 1.f / (float)(WIN * WIN) : 0.f;
  float acc = 0.f;  // loss mode: this thread's clamped cc, in item order

  // 4 adjacent outputs a thread: the five sums along W, left to right, then
  // cc, for the rows chunk ci completed
  auto horizontal = [&](int ci) {
    const int k0 = max(window - 1 - ci * chunk, 0);
    const int k1 = min(chunk, rows_out + window - 1 - ci * chunk);
    // thread tid takes items tid, tid + nt, ... of (row, group) in row-major
    // order, stepped without a division
    for (int k = k0 + kr0, g = g0; k < k1; k += dk, g += dg) {
      if (g >= ng) g -= ng, ++k;
      if (k >= k1) break;
      const int x = x0 + 4 * g;
      if (x >= a.W) continue;
      const float* row = sv + k * 5 * vw + 4 * g;  // sv column i holds x0 - halo + i
      float s[5][4];
      if constexpr (WIN > 0) {
        constexpr int kB = ncc_halo(WIN) - WIN / 2;  // the first tap's index
        constexpr int kNB = round_up(kB + WIN + 3, 4);
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          float buf[kNB];
#pragma unroll
          for (int i = 0; i < kNB / 4; ++i) {
            const float4 f = *reinterpret_cast<const float4*>(row + q * vw + 4 * i);
            buf[4 * i] = f.x, buf[4 * i + 1] = f.y, buf[4 * i + 2] = f.z, buf[4 * i + 3] = f.w;
          }
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            float t = buf[kB + p];
#pragma unroll
            for (int o = 1; o < WIN; ++o) t = __fadd_rn(t, buf[kB + p + o]);
            s[q][p] = t;
          }
        }
      } else {
        const int b0 = halo + lo;
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          const float* r = row + q * vw + b0;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            float t = r[p];
            for (int o = 1; o < window; ++o) t = __fadd_rn(t, r[p + o]);
            s[q][p] = t;
          }
        }
      }
      float v[4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        v[p] = ncc_value<(WIN > 0)>(s[0][p], s[1][p], s[2][p], s[3][p], s[4][p], win, rwin,
                                    a.eps);
      if constexpr (LOSS) {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (x + p < a.W) acc = __fadd_rn(acc, clamp_cc(v[p]));
      } else {
        const int y = y0 + ci * chunk + k - (window - 1);
        float* dst = a.cc + ((size_t)plane * a.H + y) * a.W + x;
        if (a.vec_out) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int p = 0; p < 4; ++p)
            if (x + p < a.W) dst[p] = v[p];
        }
      }
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) issue(s);
    cp_async_commit();
  }
  for (int ci = 0; ci < nchunks; ++ci) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk ci landed; chunk ci - 1's slot and sv are free
    if (ci + kStages - 1 < nchunks) issue(ci + kStages - 1);
    cp_async_commit();
    if (tid < nv) vertical(ci);
    __syncthreads();
    horizontal(ci);
  }

  if constexpr (LOSS) finish_loss(acc, a);
}

// The two-pass path, for a window whose rings do not fit shared memory (any
// window the plan cannot hold; ncc_plan decides). Pass 1 writes the five
// vertical sums of every pixel to a scratch buffer in device memory, pass 2
// reads them back along W and closes the NCC as ncc_kernel does; the same
// roundings in the same order, so the same bits. Block b takes the rows
// (plane * H + y) b, b + gridDim.x, ..., a thread the columns tid, tid + nt,
// ... of each: the loss's items, and so its partials, have a fixed order.

// pass 1: vs[q][row][x] = the window's rows of stat q, top to bottom, zero
// outside the plane (a padded row adds +0, as the TPU kernel's padding)
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) ncc_vertical_kernel(const NccArgs a,
                                                                   float* __restrict__ vs,
                                                                   long long rows) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lo = -(a.window / 2);
  const size_t stride = (size_t)rows * a.W;  // one stat's plane of sums
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const long long plane = r / a.H;
    const int y = (int)(r - plane * a.H);
    const long long n = plane / a.C;
    const int c = (int)(plane - n * a.C);
    const size_t base = (size_t)n * a.H * a.W * a.C + c;
    const T* pI = static_cast<const T*>(a.pred) + base;
    const T* pJ = static_cast<const T*>(a.target) + base;
    for (int x = tid; x < a.W; x += nt) {
      float s[5];
      for (int o = 0; o < a.window; ++o) {
        const int yy = y + lo + o;
        const bool in = yy >= 0 && yy < a.H;
        const size_t src = ((size_t)(in ? yy : 0) * a.W + x) * a.C;
        const float vi = in ? to_float(pI[src]) : 0.f, vj = in ? to_float(pJ[src]) : 0.f;
        const float t[5] = {vi, vj, __fmul_rn(vi, vi), __fmul_rn(vj, vj), __fmul_rn(vi, vj)};
#pragma unroll
        for (int q = 0; q < 5; ++q) s[q] = o == 0 ? t[q] : __fadd_rn(s[q], t[q]);
      }
      float* dst = vs + (size_t)r * a.W + x;
#pragma unroll
      for (int q = 0; q < 5; ++q) dst[q * stride] = s[q];
    }
  }
}

// pass 2: the five sums along W, left to right, then cc (IEEE division by
// win: window 9's divide-free division equals it), into the map or the loss
template <bool LOSS>
__global__ void __launch_bounds__(kMaxThreads) ncc_horizontal_kernel(
    const NccArgs a, const float* __restrict__ vs, long long rows) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lo = -(a.window / 2);
  const size_t stride = (size_t)rows * a.W;
  const float win = (float)a.window * (float)a.window;
  float acc = 0.f;  // loss mode: this thread's clamped cc, in item order
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const float* row = vs + (size_t)r * a.W;
    for (int x = tid; x < a.W; x += nt) {
      float s[5];
      for (int o = 0; o < a.window; ++o) {
        const int xx = x + lo + o;
        const bool in = xx >= 0 && xx < a.W;
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          const float t = in ? row[q * stride + xx] : 0.f;
          s[q] = o == 0 ? t : __fadd_rn(s[q], t);
        }
      }
      const float v = ncc_value<false>(s[0], s[1], s[2], s[3], s[4], win, 0.f, a.eps);
      if constexpr (LOSS) {
        acc = __fadd_rn(acc, clamp_cc(v));
      } else {
        a.cc[(size_t)r * a.W + x] = v;
      }
    }
  }
  if constexpr (LOSS) finish_loss(acc, a);
}

// div_by(x, y, RN(1/y)) against the IEEE quotient for every float x (the
// 2^32 bit patterns): the count that differ (NaN against NaN agrees)
__global__ void ncc_division_check_kernel(float y, unsigned long long* mismatches) {
  const float r = __fdiv_rn(1.f, y);
  unsigned long long n = 0;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < (1ull << 32); i += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((unsigned)i);
    const float a = __fdiv_rn(x, y), b = div_by(x, y, r);
    n += __float_as_uint(a) != __float_as_uint(b) && !(a != a && b != b);
  }
  if (n) atomicAdd(mismatches, n);
}

template <typename T, int WIN, bool LOSS>
cudaError_t launch_ncc(const NccArgs& a, int blocks, int threads, int smem, cudaStream_t st) {
  if (smem > 48 * 1024) {  // raise the limit once a device
    static std::atomic<unsigned long long> raised{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64) return cudaErrorInvalidValue;
    if (!(raised.load() >> dev & 1ull)) {
      e = cudaFuncSetAttribute(ncc_kernel<T, WIN, LOSS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
      if (e != cudaSuccess) return e;
      raised.fetch_or(1ull << dev);
    }
  }
  ncc_kernel<T, WIN, LOSS><<<blocks, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ncc_t(const NccArgs& a, bool loss, int blocks, int threads, int smem,
                         cudaStream_t st) {
  if (a.window == kSpecialWindow)
    return loss ? launch_ncc<T, kSpecialWindow, true>(a, blocks, threads, smem, st)
                : launch_ncc<T, kSpecialWindow, false>(a, blocks, threads, smem, st);
  return loss ? launch_ncc<T, 0, true>(a, blocks, threads, smem, st)
              : launch_ncc<T, 0, false>(a, blocks, threads, smem, st);
}

}  // namespace
}  // namespace csof

// pred, target: `planes` (H, W) planes of dtype_code (0 float32, 1 bf16, 2
// fp16), plane n * C + c at (n, ., ., c) of an (N, H, W, C) tensor (C = 1:
// (N, H, W)). Map mode (loss == null): cc (planes, H, W) float32. Loss mode:
// loss[0] = 1 - mean(clamp(cc)), loss[1 ...] one partial a block. threads,
// tile_cols, band_rows and smem_bytes are the plan of ops/kernels/ncc.py
// ncc_plan; smem_bytes must be what the plan needs.
extern "C" int csof_ncc_forward(const void* pred, const void* target, float* cc, float* loss,
                                int planes, int C, int H, int W, int window, float eps,
                                int dtype_code, int threads, int tile_cols, int band_rows,
                                int smem_bytes, void* stream) {
  using namespace csof;
  const size_t itemsize = dtype_code == 0 ? 4 : 2;
  const int chunk = window == kSpecialWindow ? kSpecialWindow : kGenericChunk;
  if (planes <= 0 || C <= 0 || H <= 0 || W <= 0 || window < 1 || dtype_code < 0 ||
      dtype_code > 2 || (loss == nullptr) == (cc == nullptr) || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || tile_cols <= 0 || tile_cols % 4 != 0 ||
      band_rows <= 0 || band_rows % chunk != 0 ||
      std::min(tile_cols + 2 * ncc_halo(window), W) > threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ncc_smem_bytes(window, threads, tile_cols, itemsize);
  if (smem != (size_t)smem_bytes || smem > (size_t)kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (W + tile_cols - 1) / tile_cols, bands = (H + band_rows - 1) / band_rows;
  const long long blocks = (long long)planes * bands * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  NccArgs a;
  a.pred = pred, a.target = target, a.cc = cc, a.loss = loss;
  a.C = C, a.H = H, a.W = W, a.window = window, a.tile_cols = tile_cols;
  a.band_rows = band_rows, a.tiles = tiles, a.bands = bands;
  a.stage_cols = threads + (int)(32 / itemsize);
  a.vec_in = C == 1 && aligned(pred) && aligned(target) && (W * itemsize) % 16 == 0;
  a.vec_out = cc != nullptr && aligned(cc) && W % 4 == 0;
  a.ticket = (int)(g_next_ticket.fetch_add(1) % kTicketSlots);
  a.eps = eps;
  a.count = (double)planes * H * W;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool is_loss = loss != nullptr;
  const int bl = (int)blocks, sm = (int)smem;
  cudaError_t e;
  switch (dtype_code) {
    case 0: e = launch_ncc_t<float>(a, is_loss, bl, threads, sm, st); break;
    case 1: e = launch_ncc_t<__nv_bfloat16>(a, is_loss, bl, threads, sm, st); break;
    default: e = launch_ncc_t<__half>(a, is_loss, bl, threads, sm, st); break;
  }
  return static_cast<int>(e);
}

// The two-pass path (ncc_plan's "two_pass"): the arguments of
// csof_ncc_forward, a scratch buffer of 5 x planes x H x W float32 for the
// vertical sums, and the grid both passes run on (threads a block, blocks;
// loss mode writes loss[1 ... blocks]).
extern "C" int csof_ncc_forward_wide(const void* pred, const void* target, float* cc,
                                     float* loss, float* scratch, int planes, int C, int H,
                                     int W, int window, float eps, int dtype_code, int threads,
                                     int blocks, void* stream) {
  using namespace csof;
  if (planes <= 0 || C <= 0 || H <= 0 || W <= 0 || window < 1 || dtype_code < 0 ||
      dtype_code > 2 || (loss == nullptr) == (cc == nullptr) || scratch == nullptr ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  NccArgs a = {};
  a.pred = pred, a.target = target, a.cc = cc, a.loss = loss;
  a.C = C, a.H = H, a.W = W, a.window = window;
  a.ticket = (int)(g_next_ticket.fetch_add(1) % kTicketSlots);
  a.eps = eps;
  a.count = (double)planes * H * W;
  const long long rows = (long long)planes * H;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0: ncc_vertical_kernel<float><<<blocks, threads, 0, st>>>(a, scratch, rows); break;
    case 1:
      ncc_vertical_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(a, scratch, rows);
      break;
    default: ncc_vertical_kernel<__half><<<blocks, threads, 0, st>>>(a, scratch, rows); break;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (loss != nullptr)
    ncc_horizontal_kernel<true><<<blocks, threads, 0, st>>>(a, scratch, rows);
  else
    ncc_horizontal_kernel<false><<<blocks, threads, 0, st>>>(a, scratch, rows);
  return static_cast<int>(cudaGetLastError());
}

// the exhaustive check of the division window 9 takes without dividing
// (div_by at y = window^2); mismatches: one zeroed device counter
extern "C" int csof_ncc_check_division(int window, unsigned long long* mismatches,
                                       void* stream) {
  using namespace csof;
  if (window < 1 || mismatches == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  ncc_division_check_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      (float)(window * window), mismatches);
  return static_cast<int>(cudaGetLastError());
}
