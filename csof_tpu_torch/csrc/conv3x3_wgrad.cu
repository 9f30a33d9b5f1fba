// K6 dw: the weight gradient of K6 (conv3x3.cu), for Conv3x3Function's
// backward.
//
//   dw[o, ci, ky, kx] = sum_{n, y, x} dy[n, o, y, x] * x[n, ci, y + ky - 1, x + kx - 1]
//
// with zero padding (1, 1), summed in float32 and returned as float32 (bf16:
// rounded once to bf16, then widened). It replaces no TPU kernel: the JAX
// package's K6 VJP (csof_tpu/ops/pallas/conv.py _conv3x3_cols_vjp_bwd) leaves
// dw to XLA's convolution, as the port left it to the library's 2-D weight
// gradient until this kernel. Both operands are read in the input's dtype;
// float32 runs as 3xTF32 as K6 does (x = x_hi + x_lo, dy = dy_hi + dy_lo,
// x_hi and dy_hi rounded by cvt.rna.tf32.f32, the small products first), bf16
// as one bf16 product, both into a float32 accumulator.
//
// What bounds it on the H100: operations (2 * 9 * Ci * Co per pixel), so it
// runs on the tensor cores as a GEMM on wgmma with M = the output channels,
// N = the 9 taps x a tile of input channels, and K = the N * H * W pixels.
// M x N is small (32 x 9 up to 64 x 1152 here) and K is millions long, so the
// grid splits K: block (c, o, s) covers input channels [16 c, 16 c + 16) (8
// where Ci <= 8), output channels [64 o, 64 o + 64) and the s-th of `splits`
// equal runs of pixel chunks, each chunk 2 output rows x 32 columns of one
// plane (the wrapper, ops/kernels/conv.py wgrad_plan, picks `splits` from the
// call's shape so that the grid fills the card). Each block writes its float32
// tile to scratch; conv3x3_wgrad_reduce_kernel sums the splits in order, so
// two runs give the same bits and nothing is atomic.
//
// Layout: K (pixels) is the contiguous axis of both NCHW tensors, and wgmma
// reads tf32 operands K-major only, in 16-byte core-matrix rows of 4 pixels
// (8 for bf16). A tap's one-pixel column shift breaks that alignment, so each
// chunk's haloed x rows are restaged three times, once per column tap kx,
// as [pixel group][input row][kx][channel][16 bytes]: the B operand of all 9
// taps of output row r is then one descriptor of N = 9 x 16 rows starting at
// input row r (the row tap ky is the row offset), read by one wgmma per k step.
// dy is restaged as [pixel group][output channel][16 bytes]. float32 splits
// into hi and lo as it is restaged; where Co <= 32 the A operand stacks dy_hi
// over dy_lo in its 64 rows (one wgmma then yields dy_hi x + dy_lo x, and the
// two halves are added in the epilogue: four products instead of three, with
// no rows left empty), else dy_hi and dy_lo are two operands (three products).
// A pixel group's stride is padded by 16 bytes, so that a warp's restage
// stores (one pixel a lane, or 4 pixels a lane as 16 bytes) hit every bank.
// Where float32 W and both tensors lie on the 16-byte grid, a lane restages
// 4 pixels from one 16-byte read, its neighbours' edge pixels by shuffles,
// and builds all three kx copies from them, splitting each value once;
// elsewhere (bf16, any W, any alignment) one pixel a lane.
//
// Pipeline: one warpgroup per output row of the chunk, one block per SM. Raw
// rows come by 16-byte cp.async into a ring of two stages, from the aligned
// address below their first column (any W and alignment, as K6 reads them);
// the copies of chunk i + 2 and the restage of chunk i + 1 run while the
// products of chunk i do. A warpgroup's wgmma issue waits on the tensor
// cores, so the two warpgroups take their turns in opposite order (one
// issues its products while the other copies and restages, then the other
// way round). Each chunk's products go into a fresh accumulator, added by
// the FP32 cores into the running float32 sum (the tensor cores'
// accumulator drifts toward zero along a long chain: K6's note), so a chain
// is at most 12 products. The blocks walk their chunks by stepping columns,
// rows and planes, with one 64-bit division a block.
#include "igemm3x3.cuh"

namespace csof {
namespace {

// wgmma wrappers at N = 72 and 144 (9 taps x 8 or 16 channels), A and B from
// shared memory
__device__ __forceinline__ void wgmma_tf32_n72(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35}, "
      "%36, %37, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n144(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71}, "
      "%72, %73, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n72(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35}, "
      "%36, %37, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n144(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71}, "
      "%72, %73, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void mma_w_tf32(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 72) wgmma_tf32_n72(d, da, db, scale_d);
  else wgmma_tf32_n144(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void mma_w_bf16(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 72) wgmma_bf16_n72(d, da, db, scale_d);
  else wgmma_bf16_n144(d, da, db, scale_d);
}

// a chunk's shape; ops/kernels/conv.py WGRAD_TILE holds the same two
// numbers for wgrad_plan, and a CPU test holds them equal
constexpr int kGTW = 32;           // chunk columns: one pixel a lane
constexpr int kGTR = 2;            // chunk rows: one warpgroup each
constexpr int kGRows = kGTR + 2;   // staged x rows
constexpr int kGXCols = kGTW + 2;  // haloed x columns
constexpr int kGThreads = kGTR * 128;
constexpr int kGWarps = kGThreads / 32;

// elements of a raw row of `cols` columns copied from the aligned address
// below its first column
template <typename T>
__host__ __device__ constexpr int raw_span(int cols) {
  return (cols + 2 * (16 / (int)sizeof(T) - 1)) / (16 / (int)sizeof(T)) * (16 / (int)sizeof(T));
}

// The tiling of one instantiation: CT input channels a block, Co <= 32 in
// float32 stacked (dy_hi over dy_lo in A's 64 rows), else 64 output channels
template <typename T, int CT, bool kStack>
struct Wg {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static_assert(kF32 || !kStack, "only float32 stacks hi over lo");
  static constexpr int kEpq = 16 / (int)sizeof(T);  // pixels a core-matrix row
  static constexpr int kPg = kGTW / kEpq;           // pixel groups a chunk row
  static constexpr int kKsteps = kPg / 2;           // wgmma k steps a chunk row
  static constexpr int kN = 9 * CT;
  static constexpr int kMB = kStack ? 32 : 64;      // output channels a block
  static constexpr int kXPg = kGRows * 3 * CT * 16 + 16;  // B's pixel-group stride
  static constexpr int kX = kPg * kXPg;                   // B, one of hi / lo
  static constexpr int kDPg = 64 * 16 + 16;               // A's pixel-group stride
  static constexpr int kDRow = kPg * kDPg;                // A of one output row
  static constexpr int kD = kGTR * kDRow;                 // A, one of hi / lo
  static constexpr int kXParts = kF32 ? 2 : 1;
  static constexpr int kDParts = (kF32 && !kStack) ? 2 : 1;
  static constexpr int kBuf = kXParts * kX + kDParts * kD;
  static constexpr int kRawX = raw_span<T>(kGXCols);
  static constexpr int kRawD = raw_span<T>(kGTW);
  static constexpr int kXRows = CT * kGRows;  // raw x rows a chunk
  static constexpr int kDRows = kMB * kGTR;   // raw dy rows a chunk
  static constexpr int kStageBytes = (kXRows * kRawX + kDRows * kRawD) * (int)sizeof(T);
  static constexpr int kTable = kXRows + kDRows;
  static constexpr int kMain = 2 * kBuf + kStages * (kStageBytes + 4 * kTable);
  static constexpr int kEpi = kGTR * 64 * kN * 4;
  static constexpr int kSmem = kMain > kEpi ? kMain : kEpi;
};

template <typename T, int CT, bool kStack, bool kVec>
__global__ void __launch_bounds__(kGThreads, 1)
conv3x3_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     float* __restrict__ partial, int Ci, int H, int W, int Co,
                     int64_t chunks) {
  using G = Wg<T, CT, kStack>;
  static_assert(G::kF32 || !kVec, "the 16-byte restage is float32's");
  using Bits = std::conditional_t<G::kF32, uint32_t, uint16_t>;
  constexpr int kAcc = G::kN / 2;
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, wg = tid / 128;
  const int c0 = blockIdx.x * CT, co0 = blockIdx.y * G::kMB, s = blockIdx.z;
  const int64_t q_begin = chunks * s / gridDim.z;
  const int nq = (int)(chunks * (s + 1) / gridDim.z - q_begin);
  const int tiles_w = (W + kGTW - 1) / kGTW, tiles_h = (H + kGTR - 1) / kGTR;
  const int64_t plane = (int64_t)H * W;
  uint8_t* raw0 = smem + 2 * G::kBuf;
  int* table0 = reinterpret_cast<int*>(raw0 + kStages * G::kStageBytes);

  // a chunk's plane, first row and first column
  struct Pos {
    int n, h0, w0;
  };
  auto decode = [&](int64_t q) {
    const int64_t t = q / tiles_w;
    return Pos{(int)(t / tiles_h), (int)(t % tiles_h) * kGTR, (int)(q - t * tiles_w) * kGTW};
  };
  // the chunk after c (columns, then rows, then planes), without a division
  auto advance = [&](Pos c) {
    c.w0 += kGTW;
    if (c.w0 >= W) {
      c.w0 = 0;
      c.h0 += kGTR;
      if (c.h0 >= H) c.h0 = 0, ++c.n;
    }
    return c;
  };
  // The raw rows' 16-byte copies, spread over the block's threads: a
  // thread's items (row, quad) are the same in every chunk, so their
  // offsets from the chunk's origin are computed once
  constexpr int kQx = G::kRawX / G::kEpq, kQd = G::kRawD / G::kEpq;
  constexpr int kItemsX = G::kXRows * kQx, kItems = kItemsX + G::kDRows * kQd;
  constexpr int kPer = (kItems + kGThreads - 1) / kGThreads;
  int64_t item_off[kPer];  // elements from the chunk's origin in x or dy
  int item_dst[kPer];      // bytes from the stage's start
  int item_meta[kPer];     // quad | row << 4 | (row offset + 1) << 12 | dy << 16 | live << 17
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int it = tid + k * kGThreads;
    if (it < kItemsX) {
      const int row = it / kQx, qd = it % kQx, c = row / kGRows, r = row % kGRows;
      item_off[k] = (int64_t)(c0 + c) * plane + (int64_t)(r - 1) * W - 1;
      item_dst[k] = (row * G::kRawX) * (int)sizeof(T) + qd * 16;
      item_meta[k] = qd | row << 4 | r << 12 | (c0 + c < Ci) << 17;
    } else if (it < kItems) {
      const int d = (it - kItemsX) / kQd, qd = (it - kItemsX) % kQd, co = d / kGTR;
      item_off[k] = (int64_t)(co0 + co) * plane + (int64_t)(d % kGTR) * W;
      item_dst[k] = (G::kXRows * G::kRawX + d * G::kRawD) * (int)sizeof(T) + qd * 16;
      item_meta[k] = qd | (G::kXRows + d) << 4 | (d % kGTR + 1) << 12 | 1 << 16 |
                     (co0 + co < Co) << 17;
    } else {
      item_off[k] = 0, item_dst[k] = 0, item_meta[k] = 0;
    }
  }
  // this thread's copy items of chunk c into raw stage st
  auto load_items = [&](Pos c, int st) {
    const int n = c.n, h0 = c.h0, w0 = c.w0;
    const uint32_t base = smem_addr(raw0 + st * G::kStageBytes);
    int* tab = table0 + st * G::kTable;
    const int xa = max(0, 1 - w0), xb = min(kGXCols, W - w0 + 1), db = min(kGTW, W - w0);
    const int64_t at = (int64_t)h0 * W + w0;
    const uintptr_t xo = reinterpret_cast<uintptr_t>(x + ((int64_t)n * Ci * plane + at));
    const uintptr_t dyo = reinterpret_cast<uintptr_t>(dy + ((int64_t)n * Co * plane + at));
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int meta = item_meta[k];
      if (!(meta >> 17)) continue;
      const bool isd = (meta >> 16) & 1;
      const int qd = meta & 15, row = (meta >> 4) & 255, gy = h0 + ((meta >> 12) & 15) - 1;
      const uintptr_t src = (isd ? dyo : xo) + (uintptr_t)(item_off[k] * (int64_t)sizeof(T));
      const uintptr_t al = src & ~uintptr_t(15);
      const int mis = (int)((src - al) / sizeof(T));
      const bool live = gy >= 0 && gy < H;
      if (qd == 0) tab[row] = live ? mis : -1;
      const int e0 = qd * G::kEpq - mis;
      if (live && e0 + G::kEpq - 1 >= (isd ? 0 : xa) && e0 < (isd ? db : xb))
        cp_async16(base + item_dst[k], reinterpret_cast<const void*>(al + qd * 16));
    }
  };
  // Piece p of the restage of raw stage st (chunk column w0) into operand
  // buffer b, one pixel a lane: this warp's x rows and dy rows of the
  // piece, loaded first, then split and stored (so no store waits on a
  // load behind it); zero outside the image, the halo's padding and the
  // channel tails. A chunk's restage is kPieces pieces, which bounds the
  // values a thread holds between its loads and its stores.
  constexpr int kPieces = G::kKsteps;
  constexpr int kXP = G::kXRows / kGWarps / kPieces, kDP = G::kDRows / kGWarps / kPieces;
  static_assert(kXP * kPieces * kGWarps == G::kXRows && kDP * kPieces * kGWarps == G::kDRows,
                "a piece takes whole rows of every warp");
  auto restage_piece = [&](int w0, int st, int b, int p) {
    const Bits* rx = reinterpret_cast<const Bits*>(raw0 + st * G::kStageBytes);
    const Bits* rd = rx + G::kXRows * G::kRawX;
    const int* tab = table0 + st * G::kTable;
    uint8_t* buf = smem + b * G::kBuf;
    const int xa = max(0, 1 - w0), xb = min(kGXCols, W - w0 + 1), db = min(kGTW, W - w0);
    const int pg = lane / G::kEpq, j = lane % G::kEpq;
    Bits vx[kXP][3], vd[kDP];
#pragma unroll
    for (int k = 0; k < kXP; ++k) {
      const int row = warp + (p * kXP + k) * kGWarps, m = tab[row];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int col = lane + kx;
        vx[k][kx] = (m >= 0 && col >= xa && col < xb) ? rx[row * G::kRawX + col + m] : Bits(0);
      }
    }
#pragma unroll
    for (int k = 0; k < kDP; ++k) {
      const int row = warp + (p * kDP + k) * kGWarps, m = tab[G::kXRows + row];
      vd[k] = (m >= 0 && lane < db) ? rd[row * G::kRawD + lane + m] : Bits(0);
    }
#pragma unroll
    for (int k = 0; k < kXP; ++k) {
      const int row = warp + (p * kXP + k) * kGWarps, c = row / kGRows, r = row % kGRows;
      uint8_t* dst = buf + pg * G::kXPg + (r * 3 * CT + c) * 16 + j * (int)sizeof(T);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        if constexpr (G::kF32) {
          const float f = __uint_as_float(vx[k][kx]), hi = tf32_rna(f);
          *reinterpret_cast<float*>(dst + kx * CT * 16) = hi;
          *reinterpret_cast<float*>(dst + kx * CT * 16 + G::kX) = f - hi;
        } else {
          *reinterpret_cast<Bits*>(dst + kx * CT * 16) = vx[k][kx];
        }
      }
    }
    uint8_t* dbuf = buf + G::kXParts * G::kX;
#pragma unroll
    for (int k = 0; k < kDP; ++k) {
      const int row = warp + (p * kDP + k) * kGWarps, co = row / kGTR, tr = row % kGTR;
      uint8_t* dst = dbuf + tr * G::kDRow + pg * G::kDPg + co * 16 + j * (int)sizeof(T);
      if constexpr (G::kF32) {
        const float f = __uint_as_float(vd[k]), hi = tf32_rna(f);
        *reinterpret_cast<float*>(dst) = hi;
        *reinterpret_cast<float*>(dst + (kStack ? 32 * 16 : G::kD)) = f - hi;
      } else {
        *reinterpret_cast<Bits*>(dst) = vd[k];
      }
    }
  };
  // The whole restage of one float32 chunk where W and both tensors lie on
  // the 16-byte grid (x's raw rows then start 3 elements below column 0,
  // dy's at it): a lane takes 4 pixels of a row (8 lanes a row), reads
  // them with one 16-byte load, the column either side from its neighbours,
  // splits the 6 values once and stores each kx copy as 16-byte hi and lo
  auto restage_vec = [&](int w0, int st, int b) {
    if constexpr (kVec) {
      const float* rx = reinterpret_cast<const float*>(raw0 + st * G::kStageBytes);
      const float* rd = rx + G::kXRows * G::kRawX;
      const int* tab = table0 + st * G::kTable;
      uint8_t* buf = smem + b * G::kBuf;
      const int xa = max(0, 1 - w0), xb = min(kGXCols, W - w0 + 1), db = min(kGTW, W - w0);
      const int pg = lane % 8;
#pragma unroll
      for (int k = 0; k < G::kXRows / 32; ++k) {
        const int row = (tid + k * kGThreads) / 8, c = row / kGRows, r = row % kGRows;
        const bool live = tab[row] >= 0;
        const float* src = rx + row * G::kRawX + 4 * pg;
        const float4 mid = *reinterpret_cast<const float4*>(src + 4);
        float v[6];
        v[1] = mid.x, v[2] = mid.y, v[3] = mid.z, v[4] = mid.w;
        const float left = __shfl_up_sync(0xffffffffu, mid.w, 1);
        const float right = __shfl_down_sync(0xffffffffu, mid.x, 1);
        v[0] = pg == 0 ? src[3] : left;
        v[5] = pg == 7 ? src[8] : right;
        float hi[6], lo[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const int col = 4 * pg + i;
          const float f = (live && col >= xa && col < xb) ? v[i] : 0.f;
          hi[i] = tf32_rna(f);
          lo[i] = f - hi[i];
        }
        uint8_t* dst = buf + pg * G::kXPg + (r * 3 * CT + c) * 16;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          *reinterpret_cast<float4*>(dst + kx * CT * 16) =
              make_float4(hi[kx], hi[kx + 1], hi[kx + 2], hi[kx + 3]);
          *reinterpret_cast<float4*>(dst + kx * CT * 16 + G::kX) =
              make_float4(lo[kx], lo[kx + 1], lo[kx + 2], lo[kx + 3]);
        }
      }
      uint8_t* dbuf = buf + G::kXParts * G::kX;
#pragma unroll
      for (int k = 0; k < G::kDRows / 32; ++k) {
        const int row = (tid + k * kGThreads) / 8, co = row / kGTR, tr = row % kGTR;
        const bool live = tab[G::kXRows + row] >= 0;
        const float4 q = *reinterpret_cast<const float4*>(rd + row * G::kRawD + 4 * pg);
        const float v[4] = {q.x, q.y, q.z, q.w};
        float hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float f = (live && 4 * pg + i < db) ? v[i] : 0.f;
          hi[i] = tf32_rna(f);
          lo[i] = f - hi[i];
        }
        uint8_t* dst = dbuf + tr * G::kDRow + pg * G::kDPg + co * 16;
        *reinterpret_cast<float4*>(dst) = make_float4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<float4*>(dst + (kStack ? 32 * 16 : G::kD)) =
            make_float4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  };
  auto restage = [&](int w0, int st, int b) {
    if constexpr (kVec) {
      restage_vec(w0, st, b);
    } else {
#pragma unroll
      for (int p = 0; p < kPieces; ++p) restage_piece(w0, st, b, p);
    }
  };
  // this warpgroup's products of k step kk of a chunk (its output row)
  auto issue_k = [&](int b, float* part, int kk) {
    const uint32_t base = smem_addr(smem + b * G::kBuf);
    uint32_t xb0 = base + wg * 3 * CT * 16;
    uint32_t da0 = base + G::kXParts * G::kX + wg * G::kDRow;
    asm volatile("" : "+r"(xb0), "+r"(da0));
    const uint64_t a_hi = desc(desc_lo(da0 + 2 * kk * G::kDPg, G::kDPg));
    const uint64_t b_hi = desc(desc_lo(xb0 + 2 * kk * G::kXPg, G::kXPg));
    if constexpr (G::kF32) {
      const uint64_t b_lo = desc(desc_lo(xb0 + G::kX + 2 * kk * G::kXPg, G::kXPg));
      if constexpr (kStack) {
        mma_w_tf32<G::kN>(part, a_hi, b_lo, kk > 0);
        mma_w_tf32<G::kN>(part, a_hi, b_hi, 1);
      } else {
        const uint64_t a_lo = desc(desc_lo(da0 + G::kD + 2 * kk * G::kDPg, G::kDPg));
        mma_w_tf32<G::kN>(part, a_lo, b_hi, kk > 0);
        mma_w_tf32<G::kN>(part, a_hi, b_lo, 1);
        mma_w_tf32<G::kN>(part, a_hi, b_hi, 1);
      }
    } else {
      mma_w_bf16<G::kN>(part, a_hi, b_hi, kk > 0);
    }
  };

  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = part[i] = 0.f;
  for (int row = tid; row < kStages * G::kTable; row += kGThreads) table0[row] = -1;
  __syncthreads();
  if (nq > 0) {
    const Pos first = decode(q_begin);
    Pos nxt = advance(first), fut = advance(nxt);  // chunks i + 1 and i + 2
    load_items(first, 0);
    cp_async_commit();
    if (nq > 1) load_items(nxt, 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    restage(first.w0, 0, 0);
    fence_proxy_async();
    // each chunk i: the products of chunk i, the copies of chunk i + 2 and
    // the restage of chunk i + 1. A warpgroup's wgmma issue waits for the
    // tensor cores, so the two warpgroups take them in opposite orders:
    // while one issues its products, the other copies and restages
    for (int i = 0; i < nq; ++i) {
      const bool next = i + 1 < nq, far = i + 2 < nq;
      cp_async_wait<0>();
      __syncthreads();
      fence_all<kAcc>(part);
#pragma unroll
      for (int turn = 0; turn < kGTR; ++turn) {
        if (turn == wg) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < G::kKsteps; ++kk) issue_k(i % 2, part, kk);
          wgmma_commit();
        } else if (turn == (wg + 1) % kGTR) {
          if (far) load_items(fut, i % 2);
          if (next) restage(nxt.w0, (i + 1) % 2, (i + 1) % 2);
        }
      }
      cp_async_commit();
      wgmma_wait_all();
      fence_all<kAcc>(part);
#pragma unroll
      for (int k = 0; k < kAcc; ++k) acc[k] += part[k];
      fence_proxy_async();
      nxt = fut;
      fut = advance(fut);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: both warpgroups' sums (and, stacked, both halves of A) through
  // shared memory into this split's tile of the scratch, coalesced
  float* ot = reinterpret_cast<float*>(smem);
  const int w4 = warp % 4, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int jn = 0; jn < G::kN / 8; ++jn) {
#pragma unroll
    for (int qv = 0; qv < 4; ++qv) {
      const int m = 16 * w4 + g + (qv >= 2 ? 8 : 0), nn = 8 * jn + 2 * t + (qv & 1);
      ot[(wg * 64 + m) * G::kN + nn] = acc[4 * jn + qv];
    }
  }
  __syncthreads();
  const int ci9 = Ci * 9;
  float* out = partial + (size_t)s * Co * ci9;
  for (int e = tid; e < G::kMB * G::kN; e += kGThreads) {
    const int co = e / G::kN, k = e % G::kN, c = k / 9, tap = k % 9, nn = tap * CT + c;
    if (co0 + co >= Co || c0 + c >= Ci) continue;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kGTR; ++r) {
      v += ot[(r * 64 + co) * G::kN + nn];
      if constexpr (kStack) v += ot[(r * 64 + 32 + co) * G::kN + nn];
    }
    out[(size_t)(co0 + co) * ci9 + (c0 + c) * 9 + tap] = v;
  }
}

// dw = the splits' tiles summed in split order, rounded once to the dtype
template <typename T>
__global__ void conv3x3_wgrad_reduce_kernel(const float* __restrict__ partial,
                                            float* __restrict__ dw, int count, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[(size_t)s * count + i];
  dw[i] = round_to<T>(v);
}

template <typename T, int CT, bool kStack, bool kVec>
cudaError_t launch_wgrad(const T* x, const T* dy, float* partial, float* dw, int N, int Ci,
                         int H, int W, int Co, int splits, cudaStream_t stream) {
  using G = Wg<T, CT, kStack>;
  const int64_t chunks = (int64_t)N * ((H + kGTR - 1) / kGTR) * ((W + kGTW - 1) / kGTW);
  if (splits < 1 || splits > 65535 || splits > chunks) return cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = allow_smem(conv3x3_wgrad_kernel<T, CT, kStack, kVec>, G::kSmem)) != cudaSuccess)
    return e;
  const dim3 grid((Ci + CT - 1) / CT, (Co + G::kMB - 1) / G::kMB, splits);
  conv3x3_wgrad_kernel<T, CT, kStack, kVec><<<grid, kGThreads, G::kSmem, stream>>>(
      x, dy, partial, Ci, H, W, Co, chunks);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int count = Co * Ci * 9;
  conv3x3_wgrad_reduce_kernel<T><<<(count + 255) / 256, 256, 0, stream>>>(partial, dw, count,
                                                                          splits);
  return cudaGetLastError();
}

template <typename T, bool kStack, bool kVec>
cudaError_t launch_ct(const void* x, const void* dy, float* partial, float* dw, int N, int Ci,
                      int H, int W, int Co, int splits, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dy);
  return Ci <= 8 ? launch_wgrad<T, 8, kStack, kVec>(xt, dt, partial, dw, N, Ci, H, W, Co,
                                                     splits, stream)
                 : launch_wgrad<T, 16, kStack, kVec>(xt, dt, partial, dw, N, Ci, H, W, Co,
                                                      splits, stream);
}

// float32's 16-byte restage is taken where W and both tensors lie on the grid
template <bool kStack>
cudaError_t launch_f32(const void* x, const void* dy, float* partial, float* dw, int N, int Ci,
                       int H, int W, int Co, int splits, cudaStream_t stream) {
  const bool on_grid = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  return on_grid
             ? launch_ct<float, kStack, true>(x, dy, partial, dw, N, Ci, H, W, Co, splits, stream)
             : launch_ct<float, kStack, false>(x, dy, partial, dw, N, Ci, H, W, Co, splits,
                                               stream);
}

}  // namespace
}  // namespace csof

// x: (N, Ci, H, W) and dy: (N, Co, H, W), contiguous, both float32 or both
// bf16; partial: float32 scratch of splits * Co * Ci * 9 (the wrapper's
// ops/kernels/conv.py wgrad_plan gives splits and the size); dw: (Co, Ci, 3,
// 3) float32. Launches conv3x3_wgrad_kernel, then conv3x3_wgrad_reduce_kernel.
extern "C" int csof_conv3x3_wgrad(const void* x, const void* dy, float* partial, float* dw,
                                  int N, int Ci, int H, int W, int Co, int splits,
                                  int dtype_code, void* stream) {
  using namespace csof;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || Ci <= 0 || H <= 0 || W <= 0 || Co <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype_code == kFloat32) {
    e = Co <= 32 ? launch_f32<true>(x, dy, partial, dw, N, Ci, H, W, Co, splits, s)
                 : launch_f32<false>(x, dy, partial, dw, N, Ci, H, W, Co, splits, s);
  } else if (dtype_code == kBFloat16) {
    e = launch_ct<__nv_bfloat16, false, false>(x, dy, partial, dw, N, Ci, H, W, Co, splits, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
