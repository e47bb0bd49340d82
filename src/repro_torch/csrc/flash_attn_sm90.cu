// Grouped-query softmax attention on Hopper's tensor cores (wgmma + TMA):
//   out[b, s, h*hd + d] = sum_t softmax_t(scale * q[b,s,h,:] . k[b,t,h/G,:]) v[b,t,h/G,d]
// with G = H / Hkv query heads for each KV head.  q (B, S, H, hd), k and v
// (B, T, Hkv, hd), all contiguous bfloat16 with hd 64 or 128; out
// (B, S, H*hd) float32.  Causal attention keeps row >= col, both counted
// from 0 (top-left aligned, also when S != T).  Other types and head dims
// take flash_attn.cu; kernels/flash_attn/ops.py chooses.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn/kernel.py
// (flash_attention), for the serving path's bf16 prefills.
//
// Bound on the H100: 4 B H hd flops for each (row, col) score the mask
// keeps, and q, k and v read once and the output written once.  At the
// long prompt (S = T = 4096, 32 heads, hd 128, causal) that is 137 GFLOP,
// 0.139 ms against the 989 TFLOP/s of the bf16 tensor cores; at short
// prompts the bytes bound it.  This kernel does the P.V product twice
// (below), 1.5x those flops.
//
// Design: one block of one warpgroup (128 threads) for each
// (b*H + h, 64-row query tile); warp w owns query rows 16w .. 16w + 15.
// * TMA.  The kernel reads the (B, S, H, hd) projections in place through
//   4-D tensor maps (hd, heads, positions, batch) encoded on the host for
//   each call and passed as __grid_constant__ parameters, so a call
//   captured in a CUDA graph stays valid.  The KV head h / G is a
//   coordinate of the map, and the maps' zero fill pads a ragged S and T:
//   nothing repeats, transposes or pads q, k or v.  A box is 64 rows of 64
//   bf16 (128 bytes, the 128-byte swizzle's width), so an hd = 128 tile is
//   two boxes side by side.  Q is loaded once; K and V go through a ring
//   of 2 stages, each with its own mbarrier for K and for V, so the scores
//   of a tile start before its V has landed, and the next tile's copies
//   run under this tile's products.
// * S = Q K^T: wgmma m64n64k16 with Q and K both K-major in shared memory
//   (the descriptor steps 32 bytes along hd inside a swizzled box), into a
//   float32 accumulator.  The scores are scaled into log2 units, masked
//   (col >= T, and col > row under the causal mask) only on tiles that
//   cross T or the diagonal, and the online softmax runs on the
//   accumulator fragment: a row lives in a quad of threads, so two
//   shuffles give its maximum.  NEG_INF = -1e30 stays finite, so
//   exp(m_old - m_new) is never inf - inf, and the denominator is clamped
//   at 1e-30.  The row sum is taken from the float32 probabilities.
// * O += P V: wgmma in register form.  The float32 score fragment,
//   converted to bf16 pairs, is wgmma's A register fragment as it stands;
//   V is the MN-major B operand (the transpose bit of 16-bit types).  One
//   bf16 P leaves errors up to 1.4x the 2e-3 check at Yi-6B's request
//   shape, so P is split into P_hi = bf16(p) and P_lo = bf16(p - P_hi), and
//   both products go into the same float32 accumulator: the error stays
//   near 1e-5.
// * Causal: the walk stops at the first key tile past the block's last
//   row, and the longest query tiles are launched first.
// * Shared memory: 80 KB at hd = 128 (Q 16 KB, two stages of K and V), two
//   blocks an SM; the dynamic limit is raised once per device at the first
//   launch, so a launch captured in a graph makes no attribute call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;      // query rows a block (one warpgroup)
constexpr int BK = 64;      // key rows a tile
constexpr int NT = 128;     // threads a block
constexpr int STAGES = 2;   // K/V ring
constexpr int BOX = 64;     // bf16 values in one 128-byte swizzled row
constexpr int ROW_BYTES = 128;
constexpr int KSTEPS = BK / 16;  // wgmma k-steps of the P.V product

template <int HD>
struct Smem {
  static constexpr int BOXES = HD / BOX;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // the barriers, and slack to align the tiles to 1024 bytes (the swizzle's period)
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

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

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle
// (layout type 1); byte offsets in units of 16 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
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

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
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

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}


template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2], const uint32_t* a, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t* a, uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t* a, uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

// Copy key tile `tile` of K and of V into ring stage `st` (thread 0 only).
template <int HD>
__device__ __forceinline__ void load_kv(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        uint8_t* Ks, uint8_t* Vs, uint64_t* k_bar,
                                        uint64_t* v_bar, int tile, int st, int kvh, int b) {
  using L = Smem<HD>;
  mbar_expect_tx(k_bar + st, L::KV_BYTES);
#pragma unroll
  for (int x = 0; x < L::BOXES; ++x)
    tma_load_4d(Ks + st * L::KV_BYTES + x * BK * ROW_BYTES, kmap, k_bar + st, x * BOX, kvh,
                tile * BK, b);
  mbar_expect_tx(v_bar + st, L::KV_BYTES);
#pragma unroll
  for (int x = 0; x < L::BOXES; ++x)
    tma_load_4d(Vs + st * L::KV_BYTES + x * BK * ROW_BYTES, vmap, v_bar + st, x * BOX, kvh,
                tile * BK, b);
}

template <int HD>
__global__ void __launch_bounds__(NT)
    flash_attn_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, float* __restrict__ out,
                           int S, int Tn, int H, int Hkv, float scale_log2, int causal) {
  using L = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* Ks = smem + L::K_OFF;
  uint8_t* Vs = smem + L::V_OFF;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* k_bar = q_bar + 1;
  uint64_t* v_bar = k_bar + STAGES;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal tiles first
  const int q_last = min(q0 + BQ, S) - 1;
  int n_tiles = (Tn + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, q_last / BK + 1);  // later tiles are dead

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&qmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&kmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&vmap)) : "memory");
    mbar_init(q_bar, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_bar + st, 1);
      mbar_init(v_bar + st, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, L::Q_BYTES);
#pragma unroll
    for (int x = 0; x < L::BOXES; ++x)
      tma_load_4d(Qs + x * BQ * ROW_BYTES, &qmap, q_bar, x * BOX, h, q0, b);
    for (int t = 0; t < STAGES && t < n_tiles; ++t)
      load_kv<HD>(&kmap, &vmap, Ks, Vs, k_bar, v_bar, t, t, kvh, b);
  }

  // This thread's rows of the tile, and its columns in each 8-column chunk.
  const int row0 = q0 + 16 * warp + lane / 4;
  const int row1 = row0 + 8;
  const int col_in = 2 * (lane % 4);

  float o[HD / 2];  // m64nHD accumulator: chunk j holds (row0, 8j + col_in + {0,1}), (row1, ...)
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running maxima (log2 units)
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the running sums

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const uint32_t phase = (t / STAGES) & 1;
    const int k0 = t * BK;

    // S = Q K^T
    float s[BK / 2];
    mbar_wait(k_bar + st, phase);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int box = kk / 4, off = (kk % 4) * 32;
      const uint64_t da = sw128_desc(Qs + box * BQ * ROW_BYTES + off, 16, 1024);
      const uint64_t db = sw128_desc(Ks + st * L::KV_BYTES + box * BK * ROW_BYTES + off, 16, 1024);
      wgmma_ss_n64(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale to log2 units, mask, and the tile's row maxima
    const bool edge = k0 + BK > Tn || (causal && k0 + BK - 1 > q0);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[4 * j + e] * scale_log2;
        float x1 = s[4 * j + 2 + e] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + col_in + e;
          if (col >= Tn || (causal && col > row0)) x0 = NEG_INF;
          if (col >= Tn || (causal && col > row1)) x1 = NEG_INF;
        }
        s[4 * j + e] = x0;
        s[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // probabilities, split into the bf16 A fragments of the two P.V products
    uint32_t p_hi[BK / 4], p_lo[BK / 4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p00 = exp2f(s[4 * j] - mn0), p01 = exp2f(s[4 * j + 1] - mn0);
      const float p10 = exp2f(s[4 * j + 2] - mn1), p11 = exp2f(s[4 * j + 3] - mn1);
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      split_bf16(p00, p01, p_hi[2 * j], p_lo[2 * j]);
      split_bf16(p10, p11, p_hi[2 * j + 1], p_lo[2 * j + 1]);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }

    // O += P_hi V + P_lo V
    mbar_wait(v_bar + st, phase);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint64_t db = sw128_desc(Vs + st * L::KV_BYTES + kk * 16 * ROW_BYTES,
                                     BK * ROW_BYTES, 1024);
      wgmma_rs<HD>(o, p_hi + 4 * kk, db);
      wgmma_rs<HD>(o, p_lo + 4 * kk, db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);

    __syncthreads();  // every warp is done with stage st
    if (tid == 0 && t + STAGES < n_tiles)
      load_kv<HD>(&kmap, &vmap, Ks, Vs, k_bar, v_bar, t + STAGES, st, kvh, b);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const size_t row_step = (size_t)H * HD;
  if (row0 < S) {
    float* dst = out + ((size_t)b * S + row0) * row_step + (size_t)h * HD + col_in;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
  }
  if (row1 < S) {
    float* dst = out + ((size_t)b * S + row1) * row_step + (size_t)h * HD + col_in;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// cuTensorMapEncodeTiled is a driver-API function: it is looked up through
// the runtime, so the library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

// 4-D map of a (batch, seq, heads, hd) bf16 tensor; a box is 64 positions x 64 of hd.
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* base, int batch, int seq,
                int heads, int hd) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)seq * heads * hd * 2};
  const cuuint32_t box[4] = {BOX, 1, BQ, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raise the kernel's dynamic shared memory limit once per device, at its
// first launch there, so that a launch captured into a CUDA graph later
// makes no attribute call.
template <int HD>
cudaError_t allow_smem() {
  static std::atomic<bool> done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attn_sm90_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HD>::BYTES);
  if (err == cudaSuccess && dev < 64) done[dev].store(true);
  return err;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, float* out, int B, int S, int Tn,
                   int H, int Hkv, float scale, int causal, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  cudaError_t err = allow_smem<HD>();
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, kmap, vmap;
  if (!encode_map(encode, &qmap, q, B, S, H, HD) || !encode_map(encode, &kmap, k, B, Tn, Hkv, HD) ||
      !encode_map(encode, &vmap, v, B, Tn, Hkv, HD))
    return cudaErrorInvalidValue;
  const dim3 grid(B * H, (S + BQ - 1) / BQ, 1);
  const float log2e = 1.4426950408889634f;
  flash_attn_sm90_kernel<HD><<<grid, NT, Smem<HD>::BYTES, stream>>>(
      qmap, kmap, vmap, out, S, Tn, H, Hkv, scale * log2e, causal);
  return cudaGetLastError();
}

}  // namespace

// bfloat16 q, k and v with hd 64 or 128; every pointer 16-byte aligned.
extern "C" int repro_flash_attn_sm90(const void* q, const void* k, const void* v, float* out,
                                     int B, int S, int T, int H, int Hkv, int hd, float scale,
                                     int causal, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (T <= 0 || Hkv <= 0 || H % Hkv != 0 || (S + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return (int)launch<64>(q, k, v, out, B, S, T, H, Hkv, scale, causal, st);
    case 128: return (int)launch<128>(q, k, v, out, B, S, T, H, Hkv, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
