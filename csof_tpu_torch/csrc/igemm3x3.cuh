// The implicit-GEMM 3x3 convolution on wgmma that K6 (conv3x3.cu) and K3's
// conv pass (skipfuse.cu) share: the shared-memory descriptors, the wgmma
// wrappers (bf16 m64nNk16, tf32 m64nNk8), the block tiling, the main loop
// (a 2-stage cp.async ring of raw NCHW rows and the packed weight, the
// restage to channel-innermost, nine taps as descriptor offsets; float32 as
// 3xTF32 with a fresh accumulator a chunk) and the epilogue through shared
// memory. conv3x3.cu's header note gives the design and its reasons.
//
// The main loop reads its input channels through a source: src.channel(n, c)
// is the (H, W) plane of input channel c of sample n, so that K3 reads the
// channels of [q, m, corr] from three tensors, one row at a time, without a
// concat in device memory (a chunk may straddle two of them). The grid is
// (row tiles x column tiles, ceil(Co / NB), N), as Tiling gives it.
#pragma once

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


template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

// The source of K6: one NCHW tensor of Ci channels
template <typename T>
struct PlaneSource {
  const T* x;
  int Ci;
  size_t plane;
  __device__ __forceinline__ const T* channel(int n, int c) const {
    return x + ((size_t)n * Ci + c) * plane;
  }
};

// The main loop of one block: acc[NB / 2] gets the block's float32 sums
// (the wgmma accumulator fragment of its warpgroup's output row)
template <typename T, int NB, typename Src>
__device__ __forceinline__ void igemm3x3_mainloop(const Src& src,
                                                  const uint8_t* __restrict__ wpk, int Ci,
                                                  int H, int W, float* acc) {
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
  const int co_blk = blockIdx.y;
  const int n = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp_id = tid / 32;
  const int nchunks = (Ci + kChunk - 1) / kChunk;
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
        const uintptr_t a = reinterpret_cast<uintptr_t>(src.channel(n, c)) +
                            (uintptr_t)(((int64_t)gy * W + x0 - 1) * (int64_t)sizeof(T));
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
    const uint8_t* wsrc = wblk + (size_t)ck * kStageW;
    const uint32_t sw = sx + kStageX;
    for (int i = tid; i < kStageW / 16; i += kThreads) cp_async16(sw + i * 16, wsrc + i * 16);
  };

  // float32: each chunk's 27 products go into a fresh accumulator (part),
  // which is then added into acc by the FP32 cores; bf16 accumulates in acc
  constexpr int kAcc = NB / 2;
  float part[Tl::kF32 ? kAcc : 1];
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
}

// The accumulators through shared memory: each output value rounded as
// the kernel's caller asks (bias added in the dtype, or a float32 output),
// at ot[(wg * NB + channel) * kOs + column]; ends in a barrier, after which
// the tile is read from ot only. Returns ot.
template <typename T, typename OutT, int NB>
__device__ __forceinline__ const float* igemm3x3_epilogue(const float* acc,
                                                          const float* __restrict__ bias,
                                                          int Co) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp_id = tid / 32, wg = tid / 128;
  const int co0 = blockIdx.y * NB;
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
  return reinterpret_cast<const float*>(smem);
}

// The tile from ot to NCHW, coalesced along pixels
template <typename T, typename OutT, int NB>
__device__ __forceinline__ void igemm3x3_store(const float* ot_all, OutT* __restrict__ out,
                                               int H, int W, int Co) {
  constexpr int kNwg = Tiling<T, NB>::kNwg;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int y0 = (blockIdx.x / tiles_w) * kNwg, x0 = (blockIdx.x % tiles_w) * kTW;
  const int co0 = blockIdx.y * NB, n = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128;
  const size_t plane = (size_t)H * W;
  const float* ot = ot_all + wg * NB * kOs;
  const int gy = y0 + wg;
  if (gy >= H) return;
  const int m = tid % kTW, gx = x0 + m;
  if (gx >= W) return;
  OutT* po = out + ((size_t)n * Co + co0) * plane + (size_t)gy * W + gx;
  for (int nn = (tid % 128) / kTW; nn < NB && co0 + nn < Co; nn += 128 / kTW)
    po[nn * plane] = from_float<OutT>(ot[nn * kOs + m]);
}
}  // namespace
}  // namespace csof
