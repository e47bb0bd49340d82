// Hopper building blocks shared by the tensor-core attention kernels
// (flash_attn_sm90.cu, the forward; flash_attn_bwd_sm90.cu, its
// backward): mbarriers, 4-D TMA loads and 1-D bulk copies, wgmma
// descriptors for tiles in the 128-byte and the 64-byte swizzle, the wgmma
// forms the kernels use (shared x shared, both operands K-major, n64, in
// bf16 and fp16; registers x shared, B MN-major, n64, n96 and n128 in fp16,
// and B K-major, n64 in bf16), the column boxes of a 64-, 96- or 128-wide
// tile (Cols) with its TMA load, descriptors and products, fp16 fragments
// and power-of-two scales, a block's maximum, the SM count, and the
// host-side tensor-map encoding of a (batch, seq, heads, hd) bf16 or fp16
// tensor in boxes of 64 positions x 64 of hd (128-byte swizzle) or x 32 of
// hd (64-byte swizzle: MLA's 96 columns as three boxes).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace sm90 {

constexpr int BOX = 64;        // bf16 values in one 128-byte swizzled row
constexpr int BOX_ROWS = 64;   // positions in one TMA box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the barrier's phase `phase` to complete.  A copy that never
// lands traps after 2 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries % 1024 == 1) {
      if (t0 == 0) t0 = global_ns();
      else if (global_ns() - t0 > 2000000000ull) asm volatile("trap;\n");
    }
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar` (whose expect_tx counts them).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor layout types: the 128-byte swizzle (rows of 64 bf16,
// 8-row atoms of 1024 bytes) and the 64-byte one (rows of 32, 512 bytes).
constexpr uint64_t SW128 = 1, SW64 = 2;

// wgmma shared-memory descriptor of a swizzled tile; byte offsets in units
// of 16 bytes.
__device__ __forceinline__ uint64_t sw_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                            uint64_t layout) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
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
// Wait until at most N committed wgmma groups are pending (they complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64, f32) {= or +=} A (64 x 16, K-major, shared) * B (64 x 16, K-major, shared)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) {= or +=} A (64 x 16, bf16 registers) * B (64 x 16, K-major, shared)
__device__ __forceinline__ void wgmma_rs_n64_kmajor(float (&d)[32], const uint32_t* a, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// The same with fp16 operands, and d (64 x N) += A (fp16 registers) . B
// (16 x N, MN-major, shared).
__device__ __forceinline__ void wgmma_ss_n64_f16(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64_f16(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs_n96_f16(float (&d)[48], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs_n128_f16(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// 2^e as a float, e clamped to the normal range.
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((min(max(e, -126), 127) + 127) << 23);
}

// E with x < 2^E for x > 0 (x = m 2^(E-1), 1 <= m < 2), from its bits.
__device__ __forceinline__ int bits_exp(uint32_t bits) { return (int)((bits >> 23) & 0xff) - 126; }

// The largest of each thread's m over the block (blockDim.x a multiple of
// 32), returned to every thread; the same in any order.
__device__ __forceinline__ float block_max(float m) {
  __shared__ float warp_max[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < (int)blockDim.x / 32; ++w) m = fmaxf(m, warp_max[w]);
  return m;
}

// Two floats as an fp16 pair (the register A operand's element order).
__device__ __forceinline__ uint32_t half2_bits(float x, float y) {
  const __half2 h = __floats2half2_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The float32 fragment of a 64 x 64 accumulator, times `mul`, as the fp16
// register A fragment of a product contracted over its 64 columns.
__device__ __forceinline__ void half_fragment(const float (&x)[32], float mul, uint32_t (&a)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[2 * j] = half2_bits(x[4 * j] * mul, x[4 * j + 1] * mul);
    a[2 * j + 1] = half2_bits(x[4 * j + 2] * mul, x[4 * j + 3] * mul);
  }
}

// The column boxes of a tile W 16-bit values wide: at W = 64 or 128, boxes
// of 64 columns in the 128-byte swizzle; at MLA's 96, three boxes of 32 in
// the 64-byte swizzle, so that one n96 wgmma reads all 96 as its MN-major B
// operand (a 64-column box in the 128-byte swizzle beside a 32-column one
// in the 64-byte swizzle would take an n64 and an n32).  A tile of R rows
// keeps each box's R rows together, box i at i * R * ROW bytes.
template <int W>
struct Cols {
  static_assert(W == 64 || W == 96 || W == 128, "a tile is 64, 96 or 128 columns wide");
  static constexpr int BOX_COLS = W == 96 ? 32 : 64;
  static constexpr int ROW = 2 * BOX_COLS;  // bytes of a box's row
  static constexpr int BOXES = W / BOX_COLS;
  static constexpr int ATOM = 8 * ROW;      // an 8-row swizzle atom
  static constexpr uint64_t LAYOUT = W == 96 ? SW64 : SW128;
  __host__ __device__ static constexpr int tile(int rows) { return rows * 2 * W; }
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Copy rows [row, row + R) of head `head` of a W-column tensor into the
// tile at `dst`, completing on `bar` (one thread; the caller counts the
// bytes on the barrier).
template <int W, int R>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* m, uint64_t* bar,
                                          int head, int row, int b) {
  using C = Cols<W>;
#pragma unroll
  for (int rb = 0; rb < R / BOX_ROWS; ++rb)
#pragma unroll
    for (int i = 0; i < C::BOXES; ++i)
      tma_load_4d(dst + i * R * C::ROW + rb * BOX_ROWS * C::ROW, m, bar, i * C::BOX_COLS, head,
                  row + rb * BOX_ROWS, b);
}

// Descriptor of k-step kk (16 of W columns) of rows r0 .. r0 + 63 of an
// R-row tile read K-major: the wgmma A or B operand contracted along its
// columns.
template <int W, int R>
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile, int r0, int kk) {
  using C = Cols<W>;
  constexpr int STEPS = C::BOX_COLS / 16;  // k-steps a box
  return sw_desc(tile + (kk / STEPS) * R * C::ROW + r0 * C::ROW + (kk % STEPS) * 32, 16, C::ATOM,
                 C::LAYOUT);
}

// acc (64 x 64) = rows a_r0 .. a_r0 + 63 of an RA-row tile (64 x W) . a
// 64-row tile (64 x W)^T, contracted over W; both fp16, or both bf16.
template <int W, int RA, bool F16 = true>
__device__ __forceinline__ void product_nt(float (&acc)[32], const uint8_t* a, int a_r0,
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const uint64_t da = kmajor_desc<W, RA>(a, a_r0, kk), db = kmajor_desc<W, BOX_ROWS>(b, 0, kk);
    if constexpr (F16) {
      wgmma_ss_n64_f16(acc, da, db, kk > 0);
    } else {
      wgmma_ss_n64(acc, da, db, kk > 0);
    }
  }
}

// acc (64 x W) += A (64 x 64, fp16 registers) . a 64-row, W-column fp16
// tile read MN-major (N along its columns): one wgmma a k-step of 16 rows,
// the boxes BOX_ROWS * ROW bytes apart.
template <int W>
__device__ __forceinline__ void product_rs(float (&acc)[W / 2], const uint32_t (&a)[16],
                                           const uint8_t* tile) {
  using C = Cols<W>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc =
        sw_desc(tile + kk * 16 * C::ROW, BOX_ROWS * C::ROW, C::ATOM, C::LAYOUT);
    if constexpr (W == 128) {
      wgmma_rs_n128_f16(acc, a + 4 * kk, desc);
    } else if constexpr (W == 96) {
      wgmma_rs_n96_f16(acc, a + 4 * kk, desc);
    } else {
      wgmma_rs_n64_f16(acc, a + 4 * kk, desc);
    }
  }
}

// cuTensorMapEncodeTiled is a driver-API function: it is looked up through
// the runtime, so the library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// 4-D map of a (batch, seq, heads, hd) 16-bit tensor (bf16 unless `type`
// says fp16); a box is 64 positions x `cols` of hd (64 in the 128-byte
// swizzle, or 32 in the 64-byte one).
inline bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* base, int batch, int seq,
                int heads, int hd, int cols = BOX,
                CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B,
                CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)seq * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, BOX_ROWS, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device's SM count, read once (1 if the runtime cannot say).
inline int sm_count() {
  static std::atomic<int> count{0};
  int n = count.load();
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 1;
    count.store(n);
  }
  return n;
}

// The TMA map of a (B, seq, heads, W) 16-bit tensor in Cols<W>'s boxes.
template <int W>
bool encode_cols(EncodeTiled encode, CUtensorMap* m, const void* base, int B, int seq,
                 int heads, bool fp16) {
  return encode_map(encode, m, base, B, seq, heads, W, Cols<W>::BOX_COLS,
                    W == 96 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                    fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

}  // namespace sm90
