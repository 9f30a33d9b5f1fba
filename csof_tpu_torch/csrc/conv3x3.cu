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
// taken.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace csof {
namespace {

constexpr int kTW = 64;              // output tile columns: one m64 per row
constexpr int kXCols = kTW + 2;      // haloed columns
constexpr int kStages = 2;
constexpr int kSmemPair = 113 * 1024;  // a block's share when two blocks fit an SM

// wgmma descriptor of a K-major operand without swizzle: 8 rows of 16 bytes
// a core matrix; bits 0-13 the start address / 16, 16-29 the byte offset to
// the next core matrix along K / 16 (lbo), 32-45 along M or N / 16 (sbo,
// here always 8 rows x 16 bytes). desc_lo() is the low word; a tap's
// descriptor adds its offset / 16 to it (addresses stay below 2^18)
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16);
}
__device__ __forceinline__ uint64_t desc(uint32_t lo) { return (uint64_t(128 >> 4) << 32) | lo; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving an accumulator across the asynchronous wgmma
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
template <int N>
__device__ __forceinline__ void fence_all(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// wgmma wrappers, m64nNk8 tf32 and m64nNk16 bf16, A and B from shared memory
__device__ __forceinline__ void wgmma_tf32_n32(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n32(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int NB>
__device__ __forceinline__ void mma_tf32(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (NB == 32) wgmma_tf32_n32(d, da, db, scale_d);
  else if constexpr (NB == 64) wgmma_tf32_n64(d, da, db, scale_d);
  else wgmma_tf32_n128(d, da, db, scale_d);
}
template <int NB>
__device__ __forceinline__ void mma_bf16(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (NB == 32) wgmma_bf16_n32(d, da, db, scale_d);
  else if constexpr (NB == 64) wgmma_bf16_n64(d, da, db, scale_d);
  else wgmma_bf16_n128(d, da, db, scale_d);
}

// The tiling of one instantiation: warpgroups (= output rows) a block, and
// the shared memory of the stage ring (raw rows of one 32-byte channel chunk
// + its packed weight), the restaged tile (hi, lo for float32) and the rows'
// alignment table; the epilogue reuses it.
// Elements of a raw row: 66 columns after up to 15 bytes of alignment
template <typename T>
__host__ __device__ constexpr int raw_w() {
  return (kXCols + 16 / (int)sizeof(T) - 1 + 16 / (int)sizeof(T) - 1) / (16 / (int)sizeof(T)) *
         (16 / (int)sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int stage_x_bytes(int rows) { return 32 * rows * raw_w<T>(); }
template <typename T>
__host__ __device__ constexpr int stage_w_bytes(int nb) {
  return 9 * 2 * nb * 16 * (sizeof(T) == 4 ? 2 : 1);
}
__host__ __device__ constexpr int xa_bytes(int rows) { return rows * 2 * kXCols * 16; }
template <typename T>
__host__ __device__ constexpr int table_ints(int rows) {
  return kStages * (32 / (int)sizeof(T)) * rows;
}
// the epilogue's rows are kOs floats apart: a warp's 4 channel lanes then
// hit other banks
constexpr int kOs = kTW + 4;
template <typename T>
__host__ __device__ constexpr int smem_bytes(int nb, int nwg) {
  const int main = kStages * (stage_x_bytes<T>(nwg + 2) + stage_w_bytes<T>(nb)) +
                   (sizeof(T) == 4 ? 2 : 1) * xa_bytes(nwg + 2) + 4 * table_ints<T>(nwg + 2);
  const int epi = nwg * nb * kOs * 4;
  return main > epi ? main : epi;
}
// four rows a block where two blocks fit an SM, else two where that fits,
// else four
template <typename T>
__host__ __device__ constexpr int pick_nwg(int nb) {
  return smem_bytes<T>(nb, 4) <= kSmemPair ? 4 : (smem_bytes<T>(nb, 2) <= kSmemPair ? 2 : 4);
}

template <typename T, int NB>
struct Tiling {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static constexpr int kEpc = 16 / sizeof(T);            // channels a 16-byte group
  static constexpr int kChunk = 2 * kEpc;                // channels a chunk (one k step)
  static constexpr int kNwg = pick_nwg<T>(NB);
  static constexpr int kRows = kNwg + 2;
  static constexpr int kThreads = kNwg * 128;
  static constexpr int kRawW = raw_w<T>();
  static constexpr int kStageX = stage_x_bytes<T>(kRows);
  static constexpr int kStageW = stage_w_bytes<T>(NB);
  static constexpr int kXa = xa_bytes(kRows);
  static constexpr int kTableInts = table_ints<T>(kRows);
  static constexpr int kSmem = smem_bytes<T>(NB, kNwg);
  static constexpr int kMinBlocks = kSmem <= kSmemPair ? 2 : 1;
};

template <typename T, typename OutT, int NB>
__device__ __forceinline__ void conv3x3_block(const T* __restrict__ x,
                                              const uint8_t* __restrict__ wpk,
                                              const float* __restrict__ bias,
                                              OutT* __restrict__ out, int Ci, int H, int W,
                                              int Co) {
  using Tl = Tiling<T, NB>;
  using Bits = std::conditional_t<Tl::kF32, uint32_t, uint16_t>;
  constexpr int kNwg = Tl::kNwg, kRows = Tl::kRows, kThreads = Tl::kThreads;
  constexpr int kChunk = Tl::kChunk, kEpc = Tl::kEpc, kRawW = Tl::kRawW;
  constexpr int kStageX = Tl::kStageX, kStageW = Tl::kStageW;
  constexpr int kStage = kStageX + kStageW;
  constexpr int kXa = Tl::kXa;
  constexpr int kEpq = 16 / sizeof(T);
  constexpr int kQuads = kRawW / kEpq;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(128) uint8_t smem[];

  const int tiles_w = (W + kTW - 1) / kTW;
  const int y0 = (blockIdx.x / tiles_w) * kNwg, x0 = (blockIdx.x % tiles_w) * kTW;
  const int co_blk = blockIdx.y, co0 = co_blk * NB;
  const int n = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp_id = tid / 32;
  const int nchunks = (Ci + kChunk - 1) / kChunk;
  const size_t plane = (size_t)H * W;
  const int col_a = max(0, 1 - x0), col_b = min(kXCols, W - x0 + 1);
  const uint8_t* wblk = wpk + (size_t)co_blk * nchunks * kStageW;
  uint8_t* xa_hi = smem + kStages * kStage;
  int* table = reinterpret_cast<int*>(xa_hi + (Tl::kF32 ? 2 : 1) * kXa);

  auto load_chunk = [&](int ck) {
    const int s = ck % kStages, c0 = ck * kChunk;
    const uint32_t sx = smem_addr(smem + s * kStage);
    for (int row = warp_id; row < kChunk * kRows; row += kWarps) {
      const int r = row % kRows, c = c0 + row / kRows, gy = y0 - 1 + r;
      int mis = -1;
      if (c < Ci && gy >= 0 && gy < H) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(x) +
                            (uintptr_t)((((int64_t)n * Ci + c) * (int64_t)plane +
                                         (int64_t)gy * W + x0 - 1) * (int64_t)sizeof(T));
        const uintptr_t al = a & ~uintptr_t(15);
        mis = (int)((a - al) / sizeof(T));
        for (int q = lane; q < kQuads; q += 32) {
          const int e0 = q * kEpq - mis;
          if (e0 + kEpq - 1 < col_a || e0 >= col_b) continue;
          cp_async16(sx + (uint32_t)(row * kRawW * sizeof(T) + q * 16),
                     reinterpret_cast<const void*>(al + q * 16));
        }
      }
      if (lane == 0) table[s * kChunk * kRows + row] = mis;
    }
    const uint8_t* src = wblk + (size_t)ck * kStageW;
    const uint32_t sw = sx + kStageX;
    for (int i = tid; i < kStageW / 16; i += kThreads) cp_async16(sw + i * 16, src + i * 16);
  };

  // float32: each chunk's 27 products go into a fresh accumulator (part),
  // which is then added into acc by the FP32 cores; bf16 accumulates in acc
  constexpr int kAcc = NB / 2;
  float acc[kAcc], part[Tl::kF32 ? kAcc : 1];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (Tl::kF32 ? kAcc : 1); ++i) part[i] = 0.f;

  const int wg = tid / 128;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) load_chunk(s);
    cp_async_commit();
  }
  for (int ck = 0; ck < nchunks; ++ck) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (ck + kStages - 1 < nchunks) load_chunk(ck + kStages - 1);
    cp_async_commit();
    const int s = ck % kStages;
    const Bits* raw = reinterpret_cast<const Bits*>(smem + s * kStage);
    const int* tab = table + s * kChunk * kRows;
    for (int i = tid; i < kRows * 2 * kXCols; i += kThreads) {
      const int col = i % kXCols, kc = (i / kXCols) % 2, r = i / (2 * kXCols);
      const bool col_ok = col >= col_a && col < col_b;
      Bits v[kEpc];
#pragma unroll
      for (int j = 0; j < kEpc; ++j) {
        const int row = (kc * kEpc + j) * kRows + r;
        const int m = tab[row];
        v[j] = (col_ok && m >= 0) ? raw[row * kRawW + col + m] : Bits(0);
      }
      uint8_t* dst = xa_hi + ((r * 2 + kc) * kXCols + col) * 16;
      if constexpr (Tl::kF32) {
        float4 hi, lo;
        float* h = &hi.x;
        float* l = &lo.x;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float f = __uint_as_float(v[j]);
          h[j] = tf32_rna(f);
          l[j] = f - h[j];
        }
        *reinterpret_cast<float4*>(dst) = hi;
        *reinterpret_cast<float4*>(dst + kXa) = lo;
      } else {
        uint4 p;
        p.x = v[0] | (uint32_t(v[1]) << 16);
        p.y = v[2] | (uint32_t(v[3]) << 16);
        p.z = v[4] | (uint32_t(v[5]) << 16);
        p.w = v[6] | (uint32_t(v[7]) << 16);
        *reinterpret_cast<uint4*>(dst) = p;
      }
    }
    fence_proxy_async();
    __syncthreads();
    uint32_t a0 = smem_addr(xa_hi) + (uint32_t)(wg * 2 * kXCols * 16);
    uint32_t b0 = smem_addr(smem + s * kStage + kStageX);
    asm volatile("" : "+r"(a0), "+r"(b0));
    const uint32_t da0 = desc_lo(a0, kXCols * 16), db0 = desc_lo(b0, NB * 16);
    fence_all<kAcc>(Tl::kF32 ? part : acc);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const uint32_t da = da0 + (uint32_t)(ky * 2 * kXCols + kx);
      const uint32_t db = db0 + (uint32_t)(tap * 2 * NB);
      if constexpr (Tl::kF32) {
        mma_tf32<NB>(part, desc(da + kXa / 16), desc(db), tap > 0);
        mma_tf32<NB>(part, desc(da), desc(db + 9 * 2 * NB), 1);
        mma_tf32<NB>(part, desc(da), desc(db), 1);
      } else {
        mma_bf16<NB>(acc, desc(da), desc(db), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_all<kAcc>(Tl::kF32 ? part : acc);
    if constexpr (Tl::kF32) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* ot = reinterpret_cast<float*>(smem) + wg * NB * kOs;
  const int warp = warp_id % 4, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = 16 * warp + g + (q >= 2 ? 8 : 0);
      const int nn = 8 * j + 2 * t + (q & 1);
      const int co = co0 + nn;
      float v = acc[4 * j + q];
      if constexpr (sizeof(OutT) == sizeof(float) && sizeof(T) != sizeof(float)) {
        if (bias != nullptr && co < Co) v += bias[co];
      } else {
        v = round_to<T>(v);
        if (bias != nullptr && co < Co) v = round_to<T>(v + round_to<T>(bias[co]));
      }
      ot[nn * kOs + m] = v;
    }
  }
  __syncthreads();
  const int gy = y0 + wg;
  if (gy >= H) return;
  const int m = tid % kTW, gx = x0 + m;
  if (gx >= W) return;
  OutT* po = out + ((size_t)n * Co + co0) * plane + (size_t)gy * W + gx;
  for (int nn = (tid % 128) / kTW; nn < NB && co0 + nn < Co; nn += 128 / kTW)
    po[nn * plane] = from_float<OutT>(ot[nn * kOs + m]);
}

// The forward, and the same code launched as the backward (dx on dy with
// the flipped weight) under its own name, so that a profile tells them apart
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

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
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
