// The gradient of grouped-query softmax attention on Hopper's tensor cores
// (wgmma + TMA): given q (B, S, H, hq), k (B, T, Hkv, hq) and v (B, T, Hkv,
// hv) in bfloat16, with (hq, hv) = (64, 64), (128, 128) or MLA's own (96,
// 64), the forward's output o and its gradient do (both (B, S, H*hv)
// float32) and the forward's row log-sum-exp lse (B, H, S)
// (flash_attn_sm90.cu writes it), it writes dq (B, S, H, hq), dk (B, T,
// Hkv, hq) and dv (B, T, Hkv, hv), all float32.  With P = exp(scale q.k -
// lse) under the forward's mask (causal keeps row >= col, top-left
// aligned) and D = rowsum(dO * O):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),  dQ = dS K scale,  dK = dS^T Q scale
// with each GQA group's G = H / Hkv query heads summed into its KV head.
// Other types and head dims take flash_attn_bwd.cu; kernels/flash_attn/ops.py
// chooses, as for the forward.  Like the forward (flash_attn_sm90.cu), it
// takes MLA's tensors unpadded, so it multiplies no padding's zeros (0.615
// of the work padded to 128).
//
// Replaces no TPU kernel: the Pallas flash_attention
// (src/repro/kernels/flash_attn/kernel.py) has no custom_vjp, and the
// reference trains through XLA's autodiff of chunked attention
// (src/repro/models/layers.py chunked_attention).  This kernel computes
// that gradient on the card for the training path's FlashAttention.
//
// Bound on the H100: five products for each (row, col) pair the mask
// keeps, a head (scores, dQ, dK of 2 hq flops; dV, dP of 2 hv), against the
// 16-bit tensor cores' 989 TFLOP/s; q, k, v, o and do read once and dq, dk,
// dv written once.  At Qwen1.5-0.5B's training call (B = 4, S = T = 2048,
// 16 heads, hd 64, causal) that is 86 GFLOP, 0.087 ms.
//
// Operands: fp16 with exact power-of-two scales, one product each.  The
// float32 dO, P and dS must be rounded to 16 bits for the tensor cores, and
// one bf16 rounding of any of them takes a gradient past the 2e-3 contract
// (max |d| / max |ref|) at the training shapes (tests/flash_bwd_rounding.py
// emulates each rounding on the CPU: dO up to 6.0e-3, dS 2.6e-3, P 2.4e-3).
// fp16 keeps 11 significant bits to bf16's 8: q, k, v and dO are each
// scaled by 2^(15 - E), max |x| < 2^E (exact for bf16 q, k, v), P in [0, 1]
// goes unscaled, and dS takes 2^(15 - E) for its bound 2 hv max|dO| max|v|;
// D is summed from the float32 dO.  The same emulation gives at most
// 6.8e-4 at every shape.  So each tile pair takes 7 products (S, dP, dV, dK;
// S, dP, dQ) where splitting each operand into bf16 hi + lo took 13.  The
// scales come from maxima the first pass reduces on the card: no host sync,
// and a CUDA graph replays the whole backward.
//
// Design, five launches (six where dQ is split) and a memset, no atomics on
// floats, so two calls on one input give the same bits.  plan_for picks the
// instance and its options from the shapes alone.
// * Maxima: max |q|, |k|, |v|, |dO|, one atomicMax of the float bits a
//   block each (the same in any order).
// * Convert: q (and, where the plan says kv16, k and v) to scaled fp16
//   copies.  Without kv16 (hd 64 with each K, V tile feeding at most two dQ
//   blocks: Whisper's cross attention) k and v arrive in bf16 and are
//   converted in shared memory, by the dK/dV kernel once a block and by the
//   one-warpgroup dQ kernel once a tile.
// * Rows: one warp a (b, s, h) row computes D = rowsum(dO * O) in float32 (a
//   fixed shuffle order), writes dO as scaled fp16, and writes D and lse *
//   log2(e) into (B, H, S_pad) tables (S_pad a multiple of 128, the rows
//   past S masked: lse = +1e30, so P = 0), which the other two kernels copy
//   a tile at a time.
// * dK/dV on the caller's stream and dQ on a second stream, forked after
//   the rows pass and joined after dQ (side_stream), so that where neither
//   grid fills the card the other's blocks take the idle SMs.
// * dK, dV: one block for each (b * Hkv + kv head, tile of 64 * NWG keys),
//   NWG consumer warpgroups (one at hd 64, and at hd 128 when the grid
//   would not fill the card; two otherwise); warpgroup g owns keys 64 g ..
//   64 g + 63 of the tile and warp w of it 16 of those.  K and V are loaded
//   once by TMA; the block then walks the G query heads of its group and,
//   for each, the query tiles that can see its keys (under the causal mask
//   from the tile that holds its first key), with Q, dO and the tile's lse
//   and D through a ring that all its warpgroups read (3 stages for two,
//   2 for one).  One warpgroup refills a stage after a block barrier; with
//   two, the last warp to finish a stage refills it, so neither waits for
//   the other and one's softmax math runs beside the other's products.  For
//   each query tile a warpgroup issues S^T = K Q^T, then dP^T = V dO^T
//   (wgmma, both operands K-major, as the forward's S = Q K^T), computes
//   P^T = exp2(S^T scale log2e - lse log2e) on the accumulator fragment
//   while dP^T's products run, issues dV += P^T dO, computes dS^T = P^T *
//   (dP^T - D) while those run, and issues dK += dS^T Q behind them: one
//   wait for both (the fragments are the register A operand, as the
//   forward's P; Q and dO the MN-major B operand, as the forward's V).  The
//   group's heads sum in the accumulators in a fixed order.
// * dQ: one block for each (b * H + h, tile of 64 * NWG query rows; NWG 2
//   at hq >= 96), longest causal tiles first: Q and dO loaded once, K and V
//   through the ring; it recomputes S and dP (7 products a tile pair in all
//   instead of 5, for a result with no atomics) and accumulates dQ += dS K.
//   Where its grid would not fill the card, the plan splits each block's
//   key tiles into ranges whose partial dQ a last pass sums in order.
// * Tiles 96 columns wide (MLA's q.k) are three 32-column boxes in the
//   64-byte swizzle (64 and 128 wide, 64-column boxes in the 128-byte one),
//   so dK += dS^T Q and dQ += dS K are one n96 wgmma a k-step.
// * Masks: rows >= S take lse = +1e30 (P = 0); keys >= T and, on the tiles
//   that cross the diagonal, col > row take P = 0; a warpgroup skips a tile
//   its mask zeroes whole.  TMA's zero fill pads the ragged S and T
//   (Whisper's T = 1500); stores of dK and dV rows >= T and of dQ rows >= S
//   are masked.
// * Shared memory, dK/dV: K, V (64 * NWG rows), the ring of Q, dO and the
//   statistics: 160 KB at hd 128 with two warpgroups, 100 KB at MLA's (96,
//   64); dQ: Q, dO (64 * NWG rows), the ring of K and V: 160 and 96 KB.
//   Registers: a dK/dV warpgroup holds both 64 x h float32 accumulators.
//   repro_flash_attn_bwd_sm90_instances reports each instance's blocks per
//   SM, registers, shared bytes and spills as the card's runtime gives them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <mutex>
#include <type_traits>

#include "sm90.cuh"
#include "smem.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 64;      // query rows a warpgroup's tile
constexpr int BK = 64;      // key rows a warpgroup's tile
constexpr int PAD = 128;    // the statistics tables' rows: a multiple of the largest tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED_LSE = 1e30f;  // lse of a row past S: exp2(x - 1e30) = 0
static_assert(BQ == BOX_ROWS && BK == BOX_ROWS, "a warpgroup's tile is one TMA box of rows");

// The maxima the first pass reduces: q, k, v, dO (float bits).
enum { AMAX_Q, AMAX_K, AMAX_V, AMAX_DO, N_AMAX };

// The power-of-two scales of the operands, from the maxima: q, k, v and dO
// by 2^(15 - E) (max |x| * scale < 2^15, inside fp16's 65504); dS by the
// same for its bound 2 hv max|dO| max|v|.
struct Scales {
  float q, k, v, dO, dS;

  __device__ Scales(const uint32_t* amax, int hv) {
    auto scale = [](uint32_t bits) { return bits == 0 ? 1.f : pow2(15 - bits_exp(bits)); };
    q = scale(amax[AMAX_Q]);
    k = scale(amax[AMAX_K]);
    v = scale(amax[AMAX_V]);
    dO = scale(amax[AMAX_DO]);
    const int log2_hv = 32 - __clz(hv - 1);  // ceil(log2 hv)
    dS = amax[AMAX_DO] == 0 || amax[AMAX_V] == 0
             ? 1.f
             : pow2(15 - (1 + log2_hv + bits_exp(amax[AMAX_DO]) + bits_exp(amax[AMAX_V])));
  }
};

// The bf16 values of `bytes` of shared memory to fp16 times `mul`, in
// place (a tile's swizzled layout is the same for both 16-bit types), 16
// bytes at a time by `threads` threads from thread `t`; then the writes are
// made visible to wgmma's reads, which the caller's barrier orders.
__device__ __forceinline__ void convert_smem(uint8_t* p, int bytes, float mul, int t,
                                             int threads) {
  for (int i = 16 * t; i < bytes; i += 16 * threads) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    uint32_t out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[j] = half2_bits(f.x * mul, f.y * mul);
    }
    *reinterpret_cast<uint4*>(p + i) = make_uint4(out[0], out[1], out[2], out[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The ring's depth: 3 stages where two warpgroups share it (one may run
// ahead of the other by up to two tiles), 2 for one.
template <int NWG>
__host__ __device__ constexpr int ring_stages() { return NWG == 2 ? 3 : 2; }

// dK/dV block: K, V, then STAGES x (Q, dO), each stage's lse and D, the
// barriers (K/V, then one a stage) and a counter a stage.
template <int HQ, int HV, int NWG>
struct KvSmem {
  static constexpr int STAGES = ring_stages<NWG>();
  static constexpr int ROWS = 64 * NWG;
  static constexpr int V_OFF = Cols<HQ>::tile(ROWS);
  static constexpr int RING_OFF = V_OFF + Cols<HV>::tile(ROWS);
  static constexpr int Q_TILE = Cols<HQ>::tile(BQ);
  static constexpr int STAGE_BYTES = Q_TILE + Cols<HV>::tile(BQ);
  static constexpr int STAT_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * BQ * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(V_OFF % 1024 == 0 && RING_OFF % 1024 == 0 && STAGE_BYTES % 1024 == 0 &&
                Q_TILE % 1024 == 0, "each tile starts a 1024-byte swizzle atom");
};

// dQ block: Q, dO, then STAGES x (K, V), the barriers and counters.
template <int HQ, int HV, int NWG>
struct QSmem {
  static constexpr int STAGES = ring_stages<NWG>();
  static constexpr int ROWS = 64 * NWG;
  static constexpr int DO_OFF = Cols<HQ>::tile(ROWS);
  static constexpr int RING_OFF = DO_OFF + Cols<HV>::tile(ROWS);
  static constexpr int K_TILE = Cols<HQ>::tile(BK);
  static constexpr int STAGE_BYTES = K_TILE + Cols<HV>::tile(BK);
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(DO_OFF % 1024 == 0 && RING_OFF % 1024 == 0 && STAGE_BYTES % 1024 == 0 &&
                K_TILE % 1024 == 0, "each tile starts a 1024-byte swizzle atom");
};

// Store a 64 x W float32 accumulator (its 8-column chunks in order), times
// `mul`, to rows r0 + (this thread's rows) of dst (row stride `stride`
// floats), rows < n_rows only.
template <int W>
__device__ __forceinline__ void store_rows(const float (&acc)[W / 2], float* dst, size_t stride,
                                           int r0, int n_rows, float mul) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = r0 + 16 * warp + lane / 4, row1 = row0 + 8;
  const int col_in = 2 * (lane % 4);
  if (row0 < n_rows) {
    float* p = dst + (size_t)row0 * stride + col_in;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      *reinterpret_cast<float2*>(p + 8 * j) = make_float2(acc[4 * j] * mul, acc[4 * j + 1] * mul);
  }
  if (row1 < n_rows) {
    float* p = dst + (size_t)row1 * stride + col_in;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      *reinterpret_cast<float2*>(p + 8 * j) =
          make_float2(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// max |x| over a bf16 tensor (blockIdx.y 0..2: q, k, v; n a multiple of 8)
// or the float32 dO (blockIdx.y 3; a multiple of 4), 16-byte loads, one
// atomicMax of the float bits a block (order-independent).
__global__ void __launch_bounds__(256)
    bwd_amax_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const float* __restrict__ dout,
                    size_t nq, size_t nk, size_t nv, size_t ndo, uint32_t* __restrict__ amax) {
  const int which = blockIdx.y;
  float m = 0.f;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  if (which < AMAX_DO) {
    const __nv_bfloat16* x = which == AMAX_Q ? q : which == AMAX_K ? k : v;
    const size_t n = (which == AMAX_Q ? nq : which == AMAX_K ? nk : nv) / 8;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
      const uint4 u = reinterpret_cast<const uint4*>(x)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
  } else {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < ndo / 4; i += stride) {
      const float4 f = reinterpret_cast<const float4*>(dout)[i];
      m = fmaxf(m, fmaxf(fmaxf(fabsf(f.x), fabsf(f.y)), fmaxf(fabsf(f.z), fabsf(f.w))));
    }
  }
  m = block_max(m);
  if (threadIdx.x == 0) atomicMax(amax + which, __float_as_uint(m));
}

// q, k, v (blockIdx.y 0..2; k and v only where the dQ kernel streams fp16
// copies) to fp16 copies scaled by their powers of two: exact for bf16
// values inside fp16's normal range.
__global__ void __launch_bounds__(256)
    bwd_convert_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, size_t nq, size_t nk, size_t nv,
                       const uint32_t* __restrict__ amax, int hv, __half* __restrict__ q16,
                       __half* __restrict__ k16, __half* __restrict__ v16) {
  const int which = blockIdx.y;
  const Scales sc(amax, hv);
  const __nv_bfloat16* x = which == AMAX_Q ? q : which == AMAX_K ? k : v;
  __half* y = which == AMAX_Q ? q16 : which == AMAX_K ? k16 : v16;
  const size_t n = (which == AMAX_Q ? nq : which == AMAX_K ? nk : nv) / 8;
  const float mul = which == AMAX_Q ? sc.q : which == AMAX_K ? sc.k : sc.v;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint4 u = reinterpret_cast<const uint4*>(x)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    uint32_t out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[j] = half2_bits(f.x * mul, f.y * mul);
    }
    reinterpret_cast<uint4*>(y)[i] = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// A (b, s, h) row, s < S_pad: D = rowsum(dO * O) and lse in log2 units into
// (B, H, S_pad), and dO as scaled fp16; rows past S take D = 0 and the
// masked lse.  One warp a row, HV / 32 consecutive values a lane (16- or
// 8-byte loads: the pass is bound by its bytes).
template <int HV>
__global__ void __launch_bounds__(256)
    bwd_rows_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                    const float* __restrict__ lse, const uint32_t* __restrict__ amax,
                    float* __restrict__ D, float* __restrict__ lse2, __half* __restrict__ do16,
                    int rows, int S, int S_pad, int H) {
  constexpr int VEC = HV / 32;
  static_assert(VEC == 2 || VEC == 4, "hv is 64 or 128");
  using Vec = typename std::conditional<VEC == 4, float4, float2>::type;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;  // (b * S_pad + s) * H + h
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int h = row % H, s = (row / H) % S_pad, b = row / (H * S_pad);
  float sum = 0.f;
  if (s < S) {
    const float mul = Scales(amax, HV).dO;
    const size_t base = (((size_t)b * S + s) * H + h) * HV + lane * VEC;
    const Vec xv = *reinterpret_cast<const Vec*>(dout + base);
    const Vec ov = *reinterpret_cast<const Vec*>(o + base);
    const float* x = reinterpret_cast<const float*>(&xv);
    const float* y = reinterpret_cast<const float*>(&ov);
    uint32_t out[VEC / 2];
#pragma unroll
    for (int i = 0; i < VEC; ++i) sum = fmaf(x[i], y[i], sum);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) out[i] = half2_bits(x[2 * i] * mul, x[2 * i + 1] * mul);
    if constexpr (VEC == 4) {
      *reinterpret_cast<uint2*>(do16 + base) = make_uint2(out[0], out[1]);
    } else {
      *reinterpret_cast<uint32_t*>(do16 + base) = out[0];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (lane == 0) {
    const size_t at = ((size_t)b * H + h) * S_pad + s;
    D[at] = sum;
    lse2[at] = s < S ? lse[((size_t)b * H + h) * S + s] * LOG2E : MASKED_LSE;
  }
}

// Stage `st` of a ring is free once every warp of the block is done with
// it; then `load` refills it (if `more`).  One warpgroup passes a block
// barrier and thread 0 loads.  Two count their warps in `done[st]`, and
// the last warp to finish the stage loads: neither warpgroup waits for
// the other (a thread waiting on an mbarrier for the other warps' arrivals
// was slower at every training shape measured, tests/flash_bwd_probe.py).
template <int NWG, typename Load>
__device__ __forceinline__ void refill_stage(int* done, int st, bool more, Load&& load) {
  if constexpr (NWG == 1) {
    __syncthreads();
    if (threadIdx.x == 0 && more) load();
  } else {
    __syncwarp();  // this warp is done with stage st
    if (threadIdx.x % 32 == 0) {
      __threadfence_block();
      if ((atomicAdd(done + st, 1) + 1) % (4 * NWG) == 0 && more) {
        __threadfence_block();
        load();
      }
    }
  }
}

// At hd 64 a block keeps to 168 registers, so that three fit an SM (their
// shared memory does).
template <int HQ>
__host__ __device__ constexpr int min_blocks() { return HQ == 64 ? 3 : 1; }

// KV16: K and V arrive as the convert pass's fp16 copies; else in bf16,
// converted in shared memory (loaded once a block, they need no copy but
// where the dQ kernel streams one).
template <int HQ, int HV, int NWG, bool KV16>
__global__ void __launch_bounds__(128 * NWG, min_blocks<HQ>())
    bwd_dkdv_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
                    const float* __restrict__ lse2, const float* __restrict__ D,
                    const uint32_t* __restrict__ amax, float* __restrict__ dk,
                    float* __restrict__ dv, int S, int S_pad, int Tn, int H, int Hkv,
                    float scale_log2, float scale, int causal) {
  using L = KvSmem<HQ, HV, NWG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Ks = smem;
  uint8_t* Vs = smem + L::V_OFF;
  float* stats = reinterpret_cast<float*>(smem + L::STAT_OFF);  // a stage: lse2[64], D[64]
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_bar + 1;
  int* done = reinterpret_cast<int*>(full + L::STAGES);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.y * L::ROWS;  // the block's first key
  const int kw = k0 + 64 * wg;          // this warpgroup's first key
  const int n_q = (S + BQ - 1) / BQ;
  const int q_first = causal ? k0 / BQ : 0;  // the first query tile that sees these keys
  const int per_head = max(n_q - q_first, 0);
  const int n_it = G * per_head;

  // stage `st` <- query tile `it` of the walk: Q, dO, lse2, D
  auto load_stage = [&](int it, int st) {
    const int h = kvh * G + it / per_head;
    const int q0 = (q_first + it % per_head) * BQ;
    uint8_t* dst = smem + L::RING_OFF + st * L::STAGE_BYTES;
    float* st_stats = stats + st * 2 * BQ;
    const size_t at = ((size_t)b * H + h) * S_pad + q0;
    mbar_expect_tx(full + st, L::STAGE_BYTES + 2 * BQ * 4);
    load_tile<HQ, BQ>(dst, &qmap, full + st, h, q0, b);
    load_tile<HV, BQ>(dst + L::Q_TILE, &domap, full + st, h, q0, b);
    bulk_load(st_stats, lse2 + at, BQ * 4, full + st);
    bulk_load(st_stats + BQ, D + at, BQ * 4, full + st);
  };

  if (tid == 0 && n_it > 0) {
    mbar_init(kv_bar, 1);
#pragma unroll
    for (int st = 0; st < L::STAGES; ++st) {
      mbar_init(full + st, 1);
      done[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_it > 0) {
    mbar_expect_tx(kv_bar, Cols<HQ>::tile(L::ROWS) + Cols<HV>::tile(L::ROWS));
    load_tile<HQ, L::ROWS>(smem, &kmap, kv_bar, kvh, k0, b);
    load_tile<HV, L::ROWS>(smem + L::V_OFF, &vmap, kv_bar, kvh, k0, b);
    for (int it = 0; it < L::STAGES && it < n_it; ++it) load_stage(it, it);
  }

  // S^T and dP^T come out scaled by the operands' powers of two
  const Scales sc(amax, HV);
  const float s_mul = scale_log2 / (sc.q * sc.k);
  const float dp_mul = 1.f / (sc.v * sc.dO);

  if (n_it > 0) {
    mbar_wait(kv_bar, 0);
    if constexpr (!KV16) {
      convert_smem(Ks, Cols<HQ>::tile(L::ROWS), sc.k, tid, 128 * NWG);
      convert_smem(Vs, Cols<HV>::tile(L::ROWS), sc.v, tid, 128 * NWG);
      __syncthreads();
    }
  }

  // this thread's key rows of the tile, and its query columns in each 8-column chunk
  const int krow0 = kw + 16 * warp + lane / 4;
  const int krow1 = krow0 + 8;
  const int col_in = 2 * (lane % 4);

  float dk_acc[HQ / 2], dv_acc[HV / 2];
#pragma unroll
  for (int i = 0; i < HQ / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HV / 2; ++i) dv_acc[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % L::STAGES;
    const uint32_t phase = (it / L::STAGES) & 1;
    const int q0 = (q_first + it % per_head) * BQ;
    const uint8_t* Qs = smem + L::RING_OFF + st * L::STAGE_BYTES;
    const uint8_t* dOs = Qs + L::Q_TILE;
    const float* lse_s = stats + st * 2 * BQ;
    const float* d_s = lse_s + BQ;
    mbar_wait(full + st, phase);

    // a tile the mask zeroes whole for these keys: no query of it sees them
    if (kw < Tn && !(causal && q0 + BQ - 1 < kw)) {
      // S^T = K Q^T, then dP^T = V dO^T, two groups: P is computed while
      // dP's products run
      float s[32], dp[32];
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      product_nt<HQ, L::ROWS>(s, Ks, 64 * wg, Qs);
      wgmma_commit();
      product_nt<HV, L::ROWS>(dp, Vs, 64 * wg, dOs);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P^T on the fragment: element (key row, query column)
      const bool edge = kw + BK > Tn || (causal && q0 < kw + BK - 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + col_in + e;
          const float l2 = lse_s[c];
          float p0 = exp2f(s[4 * j + e] * s_mul - l2);
          float p1 = exp2f(s[4 * j + 2 + e] * s_mul - l2);
          if (edge) {
            const int q = q0 + c;
            if (krow0 >= Tn || (causal && q < krow0)) p0 = 0.f;
            if (krow1 >= Tn || (causal && q < krow1)) p1 = 0.f;
          }
          s[4 * j + e] = p0;
          s[4 * j + 2 + e] = p1;
        }
      }

      // dV += P^T dO (scaled by dO's power of two, undone at the end)
      uint32_t p16[16], ds16[16];
      half_fragment(s, 1.f, p16);
      fence_regs(dv_acc);
      wgmma_fence();
      product_rs<HV>(dv_acc, p16, dOs);
      wgmma_commit();
      wgmma_wait<1>();  // dP's products end; dV's may run on
      fence_regs(dp);

      // dS^T = P^T * (dP^T - D) while they run, then dK += dS^T Q (scaled
      // at the end) behind the same wait
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dd = d_s[8 * j + col_in + e];
          dp[4 * j + e] = s[4 * j + e] * fmaf(dp[4 * j + e], dp_mul, -dd);
          dp[4 * j + 2 + e] = s[4 * j + 2 + e] * fmaf(dp[4 * j + 2 + e], dp_mul, -dd);
        }
      }
      half_fragment(dp, sc.dS, ds16);
      fence_regs(dk_acc);
      wgmma_fence();
      product_rs<HQ>(dk_acc, ds16, Qs);
      wgmma_commit();
      wgmma_wait<0>();
      // the register operands stay untouched until the products that read them end
      fence_regs(p16);
      fence_regs(ds16);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }

    refill_stage<NWG>(done, st, it + L::STAGES < n_it, [&] { load_stage(it + L::STAGES, st); });
  }

  const size_t stride = (size_t)Hkv * HQ;
  const size_t stride_v = (size_t)Hkv * HV;
  store_rows<HQ>(dk_acc, dk + (size_t)b * Tn * stride + (size_t)kvh * HQ, stride, kw, Tn,
                 scale / sc.dS / sc.q);
  store_rows<HV>(dv_acc, dv + (size_t)b * Tn * stride_v + (size_t)kvh * HV, stride_v, kw, Tn,
                 1.f / sc.dO);
}

// KV16: the ring streams K and V as the convert pass's fp16 copies; else in
// bf16, each tile converted in shared memory (one warpgroup only, whose
// block barrier orders the conversion).  With one warpgroup, blockIdx.z of
// gridDim.z splits the key tiles into contiguous ranges, each block
// writing its partial dQ to dq + blockIdx.z * (B S H hq) for
// bwd_sum_kernel.
template <int HQ, int HV, int NWG, bool KV16>
__global__ void __launch_bounds__(128 * NWG, min_blocks<HQ>())
    bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
                  const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                  const float* __restrict__ lse2, const float* __restrict__ D,
                  const uint32_t* __restrict__ amax, float* __restrict__ dq, int S, int S_pad,
                  int Tn, int H, int Hkv, float scale_log2, float scale, int causal) {
  static_assert(KV16 || NWG == 1, "two warpgroups take fp16 copies of K and V");
  using L = QSmem<HQ, HV, NWG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint8_t* Qs = smem;
  const uint8_t* dOs = smem + L::DO_OFF;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_bar + 1;
  int* done = reinterpret_cast<int*>(full + L::STAGES);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::ROWS;  // longest causal tiles first
  const int qw = q0 + 64 * wg;                            // this warpgroup's first row
  const int q_last = min(q0 + L::ROWS, S) - 1;
  int n_kt = (Tn + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, q_last / BK + 1);
  // this block's key tiles
  const int per_split = NWG == 1 ? (n_kt + gridDim.z - 1) / gridDim.z : n_kt;
  const int t_lo = NWG == 1 ? min((int)blockIdx.z * per_split, n_kt) : 0;
  const int n_it = NWG == 1 ? min(per_split, n_kt - t_lo) : n_kt;

  auto load_stage = [&](int t, int st) {
    uint8_t* dst = smem + L::RING_OFF + st * L::STAGE_BYTES;
    mbar_expect_tx(full + st, L::STAGE_BYTES);
    load_tile<HQ, BK>(dst, &kmap, full + st, kvh, t * BK, b);
    load_tile<HV, BK>(dst + L::K_TILE, &vmap, full + st, kvh, t * BK, b);
  };

  if (tid == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int st = 0; st < L::STAGES; ++st) {
      mbar_init(full + st, 1);
      done[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, L::RING_OFF);
    load_tile<HQ, L::ROWS>(smem, &qmap, q_bar, h, q0, b);
    load_tile<HV, L::ROWS>(smem + L::DO_OFF, &domap, q_bar, h, q0, b);
    for (int it = 0; it < L::STAGES && it < n_it; ++it) load_stage(t_lo + it, it);
  }

  const Scales sc(amax, HV);
  const float s_mul = scale_log2 / (sc.q * sc.k);
  const float dp_mul = 1.f / (sc.v * sc.dO);

  // this thread's query rows, their statistics, and its key columns in each chunk
  const int row0 = qw + 16 * warp + lane / 4;
  const int row1 = row0 + 8;
  const int col_in = 2 * (lane % 4);
  const size_t stat = ((size_t)b * H + h) * S_pad;
  const float l2_0 = lse2[stat + row0], l2_1 = lse2[stat + row1];
  const float d0 = D[stat + row0], d1 = D[stat + row1];

  float dq_acc[HQ / 2];
#pragma unroll
  for (int i = 0; i < HQ / 2; ++i) dq_acc[i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % L::STAGES;
    const uint32_t phase = (it / L::STAGES) & 1;
    const int k0 = (t_lo + it) * BK;
    const uint8_t* Ks = smem + L::RING_OFF + st * L::STAGE_BYTES;
    const uint8_t* Vs = Ks + L::K_TILE;
    mbar_wait(full + st, phase);
    if constexpr (!KV16) {  // a K, V tile in bf16: converted here
      convert_smem(smem + L::RING_OFF + st * L::STAGE_BYTES, L::K_TILE, sc.k, tid, 128);
      convert_smem(smem + L::RING_OFF + st * L::STAGE_BYTES + L::K_TILE,
                   L::STAGE_BYTES - L::K_TILE, sc.v, tid, 128);
      __syncthreads();
    }

    // a tile the mask zeroes whole for these rows: every key after the last
    if (qw < S && !(causal && k0 > qw + BQ - 1)) {
      // S = Q K^T, then dP = dO V^T, two groups: P is computed while dP's
      // products run
      float s[32], dp[32];
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      product_nt<HQ, L::ROWS>(s, Qs, 64 * wg, Ks);
      wgmma_commit();
      product_nt<HV, L::ROWS>(dp, dOs, 64 * wg, Vs);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P, then dS, on the fragments: element (query row, key column)
      const bool edge = k0 + BK > Tn || (causal && k0 + BK - 1 > qw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = exp2f(s[4 * j + e] * s_mul - l2_0);
          float p1 = exp2f(s[4 * j + 2 + e] * s_mul - l2_1);
          if (edge) {
            const int col = k0 + 8 * j + col_in + e;
            if (col >= Tn || (causal && col > row0)) p0 = 0.f;
            if (col >= Tn || (causal && col > row1)) p1 = 0.f;
          }
          s[4 * j + e] = p0;
          s[4 * j + 2 + e] = p1;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dp[4 * j + e] = s[4 * j + e] * fmaf(dp[4 * j + e], dp_mul, -d0);
          dp[4 * j + 2 + e] = s[4 * j + 2 + e] * fmaf(dp[4 * j + 2 + e], dp_mul, -d1);
        }
      }

      // dQ += dS K (scaled at the end)
      uint32_t ds16[16];
      half_fragment(dp, sc.dS, ds16);
      fence_regs(dq_acc);
      wgmma_fence();
      product_rs<HQ>(dq_acc, ds16, Ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(ds16);
      fence_regs(dq_acc);
    }

    refill_stage<NWG>(done, st, it + L::STAGES < n_it,
                      [&] { load_stage(t_lo + it + L::STAGES, st); });
  }

  const size_t stride = (size_t)H * HQ;
  float* out = NWG == 1 ? dq + blockIdx.z * ((size_t)gridDim.x / H * S * stride) : dq;
  store_rows<HQ>(dq_acc, out + (size_t)b * S * stride + (size_t)h * HQ, stride, qw, S,
                 scale / sc.dS / sc.k);
}

// dq = the sum of its n partials (n4 float4s apart), in their order.
__global__ void __launch_bounds__(256)
    bwd_sum_kernel(const float4* __restrict__ parts, float4* __restrict__ dq, size_t n4, int n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 acc = parts[i];
    for (int s = 1; s < n; ++s) {
      const float4 x = parts[s * n4 + i];
      acc = make_float4(acc.x + x.x, acc.y + x.y, acc.z + x.z, acc.w + x.w);
    }
    dq[i] = acc;
  }
}

// Blocks of 256 threads for a grid-stride pass of n elements, per a thread:
// at most 8 an SM of the H100's 132.
int stride_blocks(size_t n, int per) {
  return (int)std::max<size_t>(1, std::min<size_t>((n / per + 255) / 256, 132 * 8));
}

// A second stream a device, with its fork and join events, on which the dQ
// kernel runs beside the dK/dV kernel: both read only what the passes
// before them wrote, and where neither grid fills the card (the card-vs-CPU
// shapes, Yi-6B's 128 dK/dV blocks) the other's blocks take the idle SMs.
// Made at a device's first call, which must not be inside a CUDA graph
// capture (as allow_smem's attribute call).
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

cudaError_t side_stream(Side** out) {
  static Side sides[64];
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lock);
  Side& side = sides[dev];
  if (side.stream == nullptr) {
    err = cudaStreamCreateWithFlags(&side.stream, cudaStreamNonBlocking);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&side.fork, cudaEventDisableTiming);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&side.join, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
  }
  *out = &side;
  return cudaSuccess;
}

// How a call runs, from its shapes alone:
// * kv_wg, q_wg: the dK/dV and dQ kernels' warpgroups a block: two at hq >=
//   96, but one for dK/dV at hd 128 when its grid would not fill the card
//   (Yi-6B's 4 KV heads); one at hd 64, where up to three one-warpgroup
//   blocks share an SM.
// * kv16: the dQ kernel streams fp16 copies of K and V (the convert pass
//   writes them) rather than converting bf16 tiles in shared memory: where
//   each K, V tile feeds more than two dQ blocks (G = H / Hkv query heads
//   times the query tiles), so the copies cost less than the conversions,
//   and always with two warpgroups.
// * dq_split: contiguous ranges of key tiles a (b, h, query tile), summed
//   by bwd_sum_kernel, where a one-warpgroup dQ grid would not fill the card
//   (Whisper's cross attention, S = 32 against T = 1,500: 64 blocks).
// The dK/dV kernel reads the fp16 copies of K and V where kv16 has them
// written, and converts bf16 K and V in shared memory where not.
struct Plan {
  int kv_wg, q_wg, kv16, dq_split;
};

Plan plan_for(int B, int S, int T, int H, int Hkv, int hq) {
  const int sms = sm_count();
  Plan p;
  p.q_wg = hq >= 96 ? 2 : 1;
  p.kv_wg = hq == 64 ? 1 : hq == 128 && B * Hkv * ((T + 127) / 128) < sms ? 1 : 2;
  p.kv16 = p.q_wg == 2 || (H / Hkv) * ((S + 63) / 64) > 2;
  const int q_blocks = B * H * ((S + 64 * p.q_wg - 1) / (64 * p.q_wg));
  const int n_kt = (T + BK - 1) / BK;
  p.dq_split = q_blocks >= sms || p.q_wg == 2
                   ? 1
                   : std::max(1, std::min((2 * sms + q_blocks - 1) / q_blocks, n_kt / 4));
  return p;
}

template <int HQ, int HV, int NKV, int NQ, bool KV16>
cudaError_t launch(const void* q, const void* k, const void* v, const float* o,
                   const float* dout, const float* lse, float* D, float* lse2, void* q16,
                   void* k16, void* v16, void* do16, uint32_t* amax, float* dq_out,
                   float* dq_parts, int dq_split, float* dk, float* dv, int B, int S, int Tn,
                   int H, int Hkv, float scale, int causal, cudaStream_t stream) {
  using KL = KvSmem<HQ, HV, NKV>;
  using QL = QSmem<HQ, HV, NQ>;
  static std::atomic<bool> kv_done[64], q_done[64];
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  cudaError_t err = repro::allow_smem(bwd_dkdv_kernel<HQ, HV, NKV, KV16>, KL::BYTES, kv_done);
  if (err != cudaSuccess) return err;
  err = repro::allow_smem(bwd_dq_kernel<HQ, HV, NQ, KV16>, QL::BYTES, q_done);
  if (err != cudaSuccess) return err;
  // q and dO as fp16 copies; k and v as fp16 copies or in bf16 (KV16)
  CUtensorMap qmap, domap, kmap, vmap;
  if (!encode_cols<HQ>(encode, &qmap, q16, B, S, H, true) ||
      !encode_cols<HV>(encode, &domap, do16, B, S, H, true) ||
      !encode_cols<HQ>(encode, &kmap, KV16 ? k16 : k, B, Tn, Hkv, KV16) ||
      !encode_cols<HV>(encode, &vmap, KV16 ? v16 : v, B, Tn, Hkv, KV16))
    return cudaErrorInvalidValue;
  const size_t nq = (size_t)B * S * H * HQ, nk = (size_t)B * Tn * Hkv * HQ,
               nv = (size_t)B * Tn * Hkv * HV, ndo = (size_t)B * S * H * HV;
  err = cudaMemsetAsync(amax, 0, N_AMAX * sizeof(uint32_t), stream);
  if (err != cudaSuccess) return err;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  bwd_amax_kernel<<<dim3(stride_blocks(std::max(nq, nk), 8), N_AMAX), 256, 0, stream>>>(
      qb, kb, vb, dout, nq, nk, nv, ndo, amax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_convert_kernel<<<dim3(stride_blocks(KV16 ? std::max(nq, nk) : nq, 8), KV16 ? 3 : 1), 256,
                       0, stream>>>(qb, kb, vb, nq, nk, nv, amax, HV, static_cast<__half*>(q16),
                                    static_cast<__half*>(k16), static_cast<__half*>(v16));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int S_pad = (S + PAD - 1) / PAD * PAD;
  const int rows = B * S_pad * H;
  bwd_rows_kernel<HV><<<(rows + 7) / 8, 256, 0, stream>>>(o, dout, lse, amax, D, lse2,
                                                          static_cast<__half*>(do16), rows, S,
                                                          S_pad, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * LOG2E;
  // dQ on the side stream, forked after the passes and joined back
  Side* side = nullptr;
  err = side_stream(&side);
  if (err != cudaSuccess) return err;
  static std::mutex fork_join;  // one fork and join at a time on a device's side stream
  std::lock_guard<std::mutex> hold(fork_join);
  err = cudaEventRecord(side->fork, stream);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(side->stream, side->fork, 0);
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<HQ, HV, NKV, KV16>
      <<<dim3(B * Hkv, (Tn + KL::ROWS - 1) / KL::ROWS), 128 * NKV, KL::BYTES, stream>>>(
          kmap, vmap, qmap, domap, lse2, D, amax, dk, dv, S, S_pad, Tn, H, Hkv, scale_log2, scale,
          causal);
  const cudaError_t kv_err = cudaGetLastError();
  bwd_dq_kernel<HQ, HV, NQ, KV16>
      <<<dim3(B * H, (S + QL::ROWS - 1) / QL::ROWS, dq_split), 128 * NQ, QL::BYTES,
         side->stream>>>(qmap, domap, kmap, vmap, lse2, D, amax,
                         dq_split > 1 ? dq_parts : dq_out, S, S_pad, Tn, H, Hkv, scale_log2,
                         scale, causal);
  err = cudaGetLastError();
  if (err == cudaSuccess && dq_split > 1) {
    bwd_sum_kernel<<<stride_blocks(nq, 4), 256, 0, side->stream>>>(
        reinterpret_cast<const float4*>(dq_parts), reinterpret_cast<float4*>(dq_out), nq / 4,
        dq_split);
    err = cudaGetLastError();
  }
  // join even after a failed launch, so that the caller's stream never runs ahead of dQ
  const cudaError_t join_err = cudaEventRecord(side->join, side->stream);
  const cudaError_t wait_err =
      join_err == cudaSuccess ? cudaStreamWaitEvent(stream, side->join, 0) : join_err;
  return kv_err != cudaSuccess ? kv_err : err != cudaSuccess ? err : wait_err;
}

// One kernel's occupancy as the runtime gives it: blocks per SM, registers
// a thread, shared bytes a block, local (spilled) bytes a thread.
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, int threads, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = blocks;
  out[1] = a.numRegs;
  out[2] = smem + (int)a.sharedSizeBytes;
  out[3] = (int)a.localSizeBytes;
  return err;
}

template <int HQ, int HV, int NKV, bool KV16>
cudaError_t kv_row(int* out) {
  const int head[4] = {HQ, HV, KV16 ? 0 : 3, NKV};
  for (int i = 0; i < 4; ++i) out[i] = head[i];
  return kernel_info(bwd_dkdv_kernel<HQ, HV, NKV, KV16>, 128 * NKV, KvSmem<HQ, HV, NKV>::BYTES,
                     out + 4);
}

template <int HQ, int HV, int NQ, bool KV16>
cudaError_t q_row(int* out) {
  const int head[4] = {HQ, HV, KV16 ? 1 : 2, NQ};
  for (int i = 0; i < 4; ++i) out[i] = head[i];
  return kernel_info(bwd_dq_kernel<HQ, HV, NQ, KV16>, 128 * NQ, QSmem<HQ, HV, NQ>::BYTES,
                     out + 4);
}

}  // namespace

// The plan of a call (see Plan): out[0] = whether k16 and v16 are needed,
// out[1] = dQ's split, so that the caller sizes the scratch.
extern "C" int repro_flash_attn_bwd_sm90_plan(int B, int S, int T, int H, int Hkv, int hq,
                                              int* out) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0) {
    out[0] = 0;
    out[1] = 1;
    return 0;
  }
  const Plan p = plan_for(B, S, T, H, Hkv, hq);
  out[0] = p.kv16;
  out[1] = p.dq_split;
  return 0;
}

// bfloat16 q, k (hq) and v (hv) with (hq, hv) = (64, 64), (128, 128) or
// (96, 64); o, do (B, S, H*hv), lse (B, H, S) float32; scratch: D and lse2
// (B, H, S_pad) float32 with S_pad = S rounded up to a multiple of 128, the
// fp16 copies q16 and do16 (q's and (B, S, H, hv)) and, where the plan says
// so, k16 and v16 (else null), amax (4 uint32) and, where dQ is split,
// dq_parts (split x B x S x H x hq float32, else null); outputs dq (B, S, H,
// hq), dk (B, T, Hkv, hq) and dv (B, T, Hkv, hv) float32.  Every pointer
// 16-byte aligned.
extern "C" int repro_flash_attn_bwd_sm90(const void* q, const void* k, const void* v,
                                         const float* o, const float* dout, const float* lse,
                                         float* D, float* lse2, void* q16, void* k16, void* v16,
                                         void* do16, void* amax, float* dq_parts, float* dq,
                                         float* dk, float* dv, int B, int S, int T, int H,
                                         int Hkv, int hq, int hv, float scale, int causal,
                                         void* stream) {
  if (B == 0 || S == 0 || H == 0 || T == 0) return 0;
  if (T < 0 || Hkv <= 0 || H % Hkv != 0 || (S + BQ - 1) / BQ > 65535 || (T + BK - 1) / BK > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dout |
       (uintptr_t)q16 | (uintptr_t)k16 | (uintptr_t)v16 | (uintptr_t)do16 | (uintptr_t)amax |
       (uintptr_t)dq_parts | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv | (uintptr_t)D |
       (uintptr_t)lse2) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const Plan p = plan_for(B, S, T, H, Hkv, hq);
  if ((p.kv16 && (k16 == nullptr || v16 == nullptr)) || (p.dq_split > 1 && dq_parts == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<uint32_t*>(amax);
#define REPRO_BWD_LAUNCH(HQ, HV, NKV, NQ, KV16)                                                 \
  (int)launch<HQ, HV, NKV, NQ, KV16>(q, k, v, o, dout, lse, D, lse2, q16, k16, v16, do16, m, dq, \
                                     dq_parts, p.dq_split, dk, dv, B, S, T, H, Hkv, scale,       \
                                     causal, st)
  if (hq == 64 && hv == 64)
    return p.kv16 ? REPRO_BWD_LAUNCH(64, 64, 1, 1, true) : REPRO_BWD_LAUNCH(64, 64, 1, 1, false);
  if (hq == 96 && hv == 64) return REPRO_BWD_LAUNCH(96, 64, 2, 2, true);
  if (hq == 128 && hv == 128)
    return p.kv_wg == 2 ? REPRO_BWD_LAUNCH(128, 128, 2, 2, true)
                        : REPRO_BWD_LAUNCH(128, 128, 1, 2, true);
#undef REPRO_BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Rows of 8 ints, one for each kernel instance (at most max_rows): hq, hv,
// kernel (0 dK/dV and 1 dQ on fp16 copies of K and V; 3 dK/dV and 2 dQ
// converting bf16 K and V in shared memory), warpgroups a block, blocks
// per SM, registers a thread, shared bytes a block, local (spill) bytes a
// thread.  Returns the number of rows written, or minus a CUDA error.
extern "C" int repro_flash_attn_bwd_sm90_instances(int* out, int max_rows) {
  if (max_rows < 9) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  int n = 0;
  for (auto row : {kv_row<64, 64, 1, true>, kv_row<64, 64, 1, false>, kv_row<128, 128, 1, true>,
                   kv_row<128, 128, 2, true>, kv_row<96, 64, 2, true>})
    if (err == cudaSuccess) err = row(out + 8 * n++);
  for (auto row : {q_row<64, 64, 1, true>, q_row<64, 64, 1, false>, q_row<128, 128, 2, true>,
                   q_row<96, 64, 2, true>})
    if (err == cudaSuccess) err = row(out + 8 * n++);
  return err == cudaSuccess ? n : -(int)err;
}
