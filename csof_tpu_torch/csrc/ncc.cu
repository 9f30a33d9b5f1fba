// K4: the windowed normalized cross-correlation map of float32 planes.
//
//   S_X[y, x] = sum over the window x window box around (y, x) of X, zero
//               outside the plane, for X in (I, J, I*I, J*J, I*J)
//   mu_I = S_I / win, mu_J = S_J / win                       (win = window^2)
//   cross = S_IJ - mu_J S_I - mu_I S_J + mu_I mu_J win
//   var_I = S_II - 2 mu_I S_I + mu_I^2 win,  var_J likewise
//   cc = cross^2 / (var_I var_J + eps)
//
// Replaces the TPU kernel csof_tpu/ops/pallas/ncc.py ncc_map_pallas /
// _ncc_kernel, with its order of operations: each box sum is taken along H
// first (the window's rows, top to bottom), then along W (left to right),
// and the closing arithmetic rounds after every operation as the TPU
// kernel's array expression does (the _rn intrinsics keep the compiler from
// contracting a multiply and an add into one rounding).
//
// What bounds it on the H100: bytes. It reads I and J once and writes cc
// once (12 bytes a pixel) and does about 100 operations a pixel, below the
// card's 20 FP32 operations per byte. The TPU kernel held a whole plane in
// VMEM; here a block owns a 32 x 32 output tile, stages the haloed
// (32 + window - 1)^2 tiles of I and J in shared memory (every input read
// from device memory once, plus the halo), keeps the five column sums of the
// tile's rows in shared memory, and writes each cc once. Any H, W and odd
// window up to 15 are taken.
#include "common.cuh"

namespace csof {
namespace {

constexpr int kT = 32;                     // output tile edge
constexpr int kMaxR = 7;                   // largest window radius (window 15)
constexpr int kSpan = kT + 2 * kMaxR;      // 46: largest haloed tile edge
constexpr int kThreads = 256;

// grid (ceil(W / 32), ceil(H / 32), N), block 256
__global__ void __launch_bounds__(kThreads)
ncc_map_kernel(const float* __restrict__ pred, const float* __restrict__ target,
               float* __restrict__ cc, int H, int W, int window, float eps) {
  __shared__ float si[kSpan][kSpan + 1];
  __shared__ float sj[kSpan][kSpan + 1];
  __shared__ float col[5][kT][kSpan + 1];

  const int r = window / 2, span = kT + 2 * r;
  const int x0 = blockIdx.x * kT, y0 = blockIdx.y * kT;
  const size_t plane = (size_t)H * W;
  const float* pi = pred + blockIdx.z * plane;
  const float* pj = target + blockIdx.z * plane;

  for (int i = threadIdx.x; i < span * span; i += kThreads) {
    const int ry = i / span, rx = i % span;
    const int gy = y0 - r + ry, gx = x0 - r + rx;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    si[ry][rx] = in ? pi[(size_t)gy * W + gx] : 0.f;
    sj[ry][rx] = in ? pj[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();

  // along H: the window's rows summed top to bottom, for each output row of
  // the tile and each column of the haloed span
  for (int i = threadIdx.x; i < kT * span; i += kThreads) {
    const int oy = i / span, cx = i % span;
    float a[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int o = 0; o < window; ++o) {
      const float vi = si[oy + o][cx], vj = sj[oy + o][cx];
      a[0] = __fadd_rn(a[0], vi);
      a[1] = __fadd_rn(a[1], vj);
      a[2] = __fadd_rn(a[2], __fmul_rn(vi, vi));
      a[3] = __fadd_rn(a[3], __fmul_rn(vj, vj));
      a[4] = __fadd_rn(a[4], __fmul_rn(vi, vj));
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) col[k][oy][cx] = a[k];
  }
  __syncthreads();

  // along W, left to right, then the closing arithmetic
  const float win = (float)(window * window);
  for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
    const int oy = i / kT, ox = i % kT;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy >= H || gx >= W) continue;
    float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int o = 0; o < window; ++o)
#pragma unroll
      for (int k = 0; k < 5; ++k) s[k] = __fadd_rn(s[k], col[k][oy][ox + o]);
    const float i_sum = s[0], j_sum = s[1], i2 = s[2], j2 = s[3], ij = s[4];
    const float i_mu = __fdiv_rn(i_sum, win), j_mu = __fdiv_rn(j_sum, win);
    const float cross = __fadd_rn(
        __fsub_rn(__fsub_rn(ij, __fmul_rn(j_mu, i_sum)), __fmul_rn(i_mu, j_sum)),
        __fmul_rn(__fmul_rn(i_mu, j_mu), win));
    const float i_var = __fadd_rn(__fsub_rn(i2, __fmul_rn(__fmul_rn(2.f, i_mu), i_sum)),
                                  __fmul_rn(__fmul_rn(i_mu, i_mu), win));
    const float j_var = __fadd_rn(__fsub_rn(j2, __fmul_rn(__fmul_rn(2.f, j_mu), j_sum)),
                                  __fmul_rn(__fmul_rn(j_mu, j_mu), win));
    cc[blockIdx.z * plane + (size_t)gy * W + gx] =
        __fdiv_rn(__fmul_rn(cross, cross), __fadd_rn(__fmul_rn(i_var, j_var), eps));
  }
}

}  // namespace
}  // namespace csof

// pred, target: (N, H, W) float32 contiguous; cc: (N, H, W) float32.
extern "C" int csof_ncc_map_forward(const float* pred, const float* target, float* cc, int N,
                                    int H, int W, int window, float eps, void* stream) {
  using namespace csof;
  if (N <= 0 || H <= 0 || W <= 0 || N > 65535 || window < 1 || window % 2 == 0 ||
      window / 2 > kMaxR)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kT - 1) / kT, (H + kT - 1) / kT, N);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  ncc_map_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(pred, target, cc, H,
                                                                            W, window, eps);
  return static_cast<int>(cudaGetLastError());
}
