// The gradient of grouped-query softmax attention on Hopper's tensor cores
// (wgmma + TMA): given q (B, S, H, hd), k and v (B, T, Hkv, hd) in bfloat16
// with hd 64 or 128, the forward's output o and its gradient do (both
// (B, S, H*hd) float32) and the forward's row log-sum-exp lse (B, H, S)
// (flash_attn_sm90.cu writes it), it writes dq (B, S, H, hd), dk and dv
// (B, T, Hkv, hd), all float32.  With P = exp(scale q.k - lse) under the
// forward's mask (causal keeps row >= col, top-left aligned) and
// D = rowsum(dO * O):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),  dQ = dS K scale,  dK = dS^T Q scale
// with each GQA group's G = H / Hkv query heads summed into its KV head.
// Other types and head dims take flash_attn_bwd.cu; kernels/flash_attn/ops.py
// chooses, as for the forward.
//
// Replaces no TPU kernel: the Pallas flash_attention
// (src/repro/kernels/flash_attn/kernel.py) has no custom_vjp, and the
// reference trains through XLA's autodiff of chunked attention
// (src/repro/models/layers.py chunked_attention).  This kernel computes
// that gradient on the card for the training path's FlashAttention.
//
// Bound on the H100: five products of 2 hd flops for each (row, col) pair
// the mask keeps, a head (scores, dV, dP, dQ, dK), against the bf16 tensor
// cores' 989 TFLOP/s; q, k, v, o and do read once and dq, dk, dv written
// once.  At Qwen1.5-0.5B's training call (B = 4, S = T = 2048, 16 heads,
// hd 64, causal) that is 86 GFLOP, 0.087 ms.
//
// Design, three launches on the caller's stream, no atomics, so two calls on
// one input give the same bits:
// * Preprocess: one warp a (b, s, h) row computes D = rowsum(dO * O) in
//   float32 (a fixed shuffle order) and writes dO once as two bf16 tensors,
//   dO_hi = bf16(dO) and dO_lo = bf16(dO - dO_hi), the products' operands.
// * dK, dV: one block of one warpgroup (128 threads) for each (b * Hkv + kv
//   head, 64-key tile); warp w owns key rows 16w .. 16w + 15.  K and V are
//   loaded once by TMA; the block then walks the G query heads of its group
//   and, for each, the query tiles that can see its keys (under the causal
//   mask from the tile that holds its first key), with Q, dO_hi and dO_lo
//   through a ring of 2 stages.  For each query tile it recomputes
//   S^T = K Q^T (wgmma, both operands K-major, as the forward's S = Q K^T),
//   P^T = exp2(S^T scale log2e - lse log2e) on the accumulator fragment,
//   dP^T = V dO^T, dS^T = P^T * (dP^T - D), then dV += P^T dO and
//   dK += dS^T Q in register form (the fragments as the forward's P, Q and
//   dO the MN-major B operand, as the forward's V).  The group's heads sum
//   in the accumulators in a fixed order.
// * dQ: one block for each (b * H + h, 64-row query tile), longest causal
//   tiles first: Q, dO_hi and dO_lo loaded once, K and V through the ring;
//   it recomputes S and dP (7 products a tile pair in all instead of 5, for
//   a result with no atomics) and accumulates dQ += dS K.
// * Precision.  q, k and v are bf16 already, so S is exact in float32.  The
//   float32 operands are not: rounding dO, P or dS to one bf16 each comes
//   near or past the 2e-3 contract (max |d| / max |ref|) at the training
//   shapes (tests/flash_bwd_rounding.py emulates each rounding on the CPU:
//   dO takes dQ or dK up to 6.0e-3 from the exact gradient, dS up to
//   2.9e-3, P takes dV up to 2.4e-3), so each is split into hi and lo bf16 parts
//   and both products go into the float32 accumulator: dP = dO_hi V +
//   dO_lo V, dV += P_hi dO_hi + P_hi dO_lo + P_lo dO_hi, dK += dS_hi Q +
//   dS_lo Q, dQ += dS_hi K + dS_lo K.  The error stays near 1e-5.
// * Masks: rows >= S take lse = +1e30 (P = 0); keys >= T and, on the tiles
//   that cross the diagonal, col > row take P = 0.  TMA's zero fill pads the
//   ragged S and T (Whisper's T = 1500); stores of dK and dV rows >= T and
//   of dQ rows >= S are masked.
// * Shared memory: dK/dV 128 KB at hd = 128 (K, V, and two stages of Q,
//   dO_hi, dO_lo), dQ 112 KB (Q, dO_hi, dO_lo, two stages of K and V).
//   Registers: the dK/dV block holds both 64 x hd float32 accumulators.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90.cuh"
#include "smem.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 64;      // query rows a tile
constexpr int BK = 64;      // key rows a tile
constexpr int NT = 128;     // threads a block (one warpgroup)
constexpr int STAGES = 2;   // ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED_LSE = 1e30f;  // lse of a row past S: exp2(x - 1e30) = 0
static_assert(BQ == BOX_ROWS && BK == BOX_ROWS, "a tile is one TMA box of rows");

template <int HD>
struct Tiles {
  static constexpr int BOXES = HD / BOX;
  static constexpr int TILE = 64 * HD * 2;  // one 64-row bf16 tile
};

// dK/dV block: K, V, then STAGES x (Q, dO_hi, dO_lo), the stage's lse and D,
// and the barriers (K/V, then one a stage).
template <int HD>
struct KvSmem {
  static constexpr int TILE = Tiles<HD>::TILE;
  static constexpr int V_OFF = TILE;
  static constexpr int RING_OFF = 2 * TILE;
  static constexpr int STAGE_BYTES = 3 * TILE;
  static constexpr int STAT_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = STAT_OFF + 2 * BQ * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + STAGES) + 1024;
};

// dQ block: Q, dO_hi, dO_lo, then STAGES x (K, V), and the barriers.
template <int HD>
struct QSmem {
  static constexpr int TILE = Tiles<HD>::TILE;
  static constexpr int RING_OFF = 3 * TILE;
  static constexpr int STAGE_BYTES = 2 * TILE;
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + STAGES) + 1024;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Copy rows [row, row + 64) of head `head` of each map (the third may be
// null) into consecutive tiles from `dst`, all completing on `bar`
// (thread 0 only).
template <int HD>
__device__ __forceinline__ void load_tiles(uint8_t* dst, const CUtensorMap* m0,
                                           const CUtensorMap* m1, const CUtensorMap* m2,
                                           uint64_t* bar, int head, int row, int b) {
  const CUtensorMap* maps[3] = {m0, m1, m2};
  const int n = m2 == nullptr ? 2 : 3;
  mbar_expect_tx(bar, n * Tiles<HD>::TILE);
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int x = 0; x < Tiles<HD>::BOXES; ++x)
      tma_load_4d(dst + i * Tiles<HD>::TILE + x * BOX_ROWS * ROW_BYTES, maps[i], bar, x * BOX,
                  head, row, b);
  }
}

// Descriptor of k-step kk (16 of hd) of a K-major 64-row tile: the wgmma A
// or B operand whose contraction runs along hd.
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile, int kk) {
  return sw128_desc(tile + (kk / 4) * BOX_ROWS * ROW_BYTES + (kk % 4) * 32, 16, 1024);
}

// Descriptor of k-step kk (16 rows) of a 64-row tile read MN-major: the B
// operand whose contraction runs along the tile's rows, N along hd.
__device__ __forceinline__ uint64_t mnmajor_desc(const uint8_t* tile, int kk) {
  return sw128_desc(tile + kk * 16 * ROW_BYTES, BOX_ROWS * ROW_BYTES, 1024);
}

// acc (64 x 64) = A tile (64 x HD) . B tile (64 x HD)^T, contracted over hd
template <int HD>
__device__ __forceinline__ void product_nt(float (&acc)[32], const uint8_t* a, const uint8_t* b,
                                           bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_n64(acc, kmajor_desc(a, kk), kmajor_desc(b, kk), accumulate || kk > 0);
}

// The float32 fragment of a 64 x 64 accumulator as the bf16 hi and lo A
// register fragments of a product contracted over its 64 columns.
__device__ __forceinline__ void split_fragment(const float (&x)[32], uint32_t (&hi)[16],
                                               uint32_t (&lo)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    split_bf16(x[4 * j], x[4 * j + 1], hi[2 * j], lo[2 * j]);
    split_bf16(x[4 * j + 2], x[4 * j + 3], hi[2 * j + 1], lo[2 * j + 1]);
  }
}

// Store a 64 x HD float32 accumulator, times `mul`, to rows r0 + (this
// thread's rows) of dst (row stride `stride` floats), rows < n_rows only.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2], float* dst, size_t stride,
                                           int r0, int n_rows, float mul) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = r0 + 16 * warp + lane / 4, row1 = row0 + 8;
  const int col_in = 2 * (lane % 4);
  if (row0 < n_rows) {
    float* p = dst + (size_t)row0 * stride + col_in;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(p + 8 * j) = make_float2(acc[4 * j] * mul, acc[4 * j + 1] * mul);
  }
  if (row1 < n_rows) {
    float* p = dst + (size_t)row1 * stride + col_in;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(p + 8 * j) =
          make_float2(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// D = rowsum(dO * O) a (b, s, h) row into (B, H, S), and dO as bf16 hi + lo.
__global__ void __launch_bounds__(128)
    bwd_preprocess_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                          float* __restrict__ D, __nv_bfloat16* __restrict__ do_hi,
                          __nv_bfloat16* __restrict__ do_lo, int rows, int S, int H, int hd) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32;  // (b * S + s) * H + h
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = (size_t)row * hd;
  float sum = 0.f;
  for (int i = lane; i < hd; i += 32) {
    const float x = dout[base + i];
    sum = fmaf(x, o[base + i], sum);
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    do_hi[base + i] = hi;
    do_lo[base + i] = __float2bfloat16_rn(x - __bfloat162float(hi));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = row % H, s = (row / H) % S, b = row / (H * S);
    D[((size_t)b * H + h) * S + s] = sum;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
    bwd_dkdv_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap dohi_map,
                    const __grid_constant__ CUtensorMap dolo_map, const float* __restrict__ lse,
                    const float* __restrict__ D, float* __restrict__ dk, float* __restrict__ dv,
                    int S, int Tn, int H, int Hkv, float scale_log2, float scale, int causal) {
  using L = KvSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Ks = smem;
  uint8_t* Vs = smem + L::V_OFF;
  float* lse_s = reinterpret_cast<float*>(smem + L::STAT_OFF);  // log2 units
  float* d_s = lse_s + BQ;
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* ring_bar = kv_bar + 1;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.y * BK;
  const int n_q = (S + BQ - 1) / BQ;
  const int q_first = causal ? k0 / BQ : 0;  // the first query tile that sees these keys
  const int per_head = max(n_q - q_first, 0);
  const int n_it = G * per_head;

  if (tid == 0 && n_it > 0) {
    mbar_init(kv_bar, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) mbar_init(ring_bar + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_it > 0) {
    load_tiles<HD>(Ks, &kmap, &vmap, nullptr, kv_bar, kvh, k0, b);
    for (int it = 0; it < STAGES && it < n_it; ++it)
      load_tiles<HD>(smem + L::RING_OFF + it * L::STAGE_BYTES, &qmap, &dohi_map, &dolo_map,
                     ring_bar + it, kvh * G + it / per_head, (q_first + it % per_head) * BQ, b);
  }

  // this thread's key rows of the tile, and its query columns in each 8-column chunk
  const int krow0 = k0 + 16 * warp + lane / 4;
  const int krow1 = krow0 + 8;
  const int col_in = 2 * (lane % 4);

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  if (n_it > 0) mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1;
    const int h = kvh * G + it / per_head;
    const int q0 = (q_first + it % per_head) * BQ;
    const uint8_t* Qs = smem + L::RING_OFF + st * L::STAGE_BYTES;
    const uint8_t* dOh = Qs + L::TILE;
    const uint8_t* dOl = Qs + 2 * L::TILE;

    if (tid < BQ) {  // this query tile's statistics
      const int q = q0 + tid;
      const size_t at = ((size_t)b * H + h) * S + q;
      lse_s[tid] = q < S ? lse[at] * LOG2E : MASKED_LSE;
      d_s[tid] = q < S ? D[at] : 0.f;
    }
    __syncthreads();
    mbar_wait(ring_bar + st, phase);

    // S^T = K Q^T and dP^T = V dO^T (dO_hi, then dO_lo)
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    product_nt<HD>(s, Ks, Qs, false);
    product_nt<HD>(dp, Vs, dOh, false);
    product_nt<HD>(dp, Vs, dOl, true);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T on the fragments: element (key row, query column)
    const bool edge = k0 + BK > Tn || (causal && q0 < k0 + BK - 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + col_in + e;
        const float l2 = lse_s[c], dd = d_s[c];
        float p0 = exp2f(s[4 * j + e] * scale_log2 - l2);
        float p1 = exp2f(s[4 * j + 2 + e] * scale_log2 - l2);
        if (edge) {
          const int q = q0 + c;
          if (krow0 >= Tn || (causal && q < krow0)) p0 = 0.f;
          if (krow1 >= Tn || (causal && q < krow1)) p1 = 0.f;
        }
        s[4 * j + e] = p0;
        s[4 * j + 2 + e] = p1;
        dp[4 * j + e] = p0 * (dp[4 * j + e] - dd);
        dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dd);
      }
    }

    // dV += P^T (dO_hi + dO_lo), P split (lo x lo dropped)
    uint32_t hi[16], lo[16];
    split_fragment(s, hi, lo);
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<HD>(dv_acc, hi + 4 * kk, mnmajor_desc(dOh, kk));
      wgmma_rs<HD>(dv_acc, hi + 4 * kk, mnmajor_desc(dOl, kk));
      wgmma_rs<HD>(dv_acc, lo + 4 * kk, mnmajor_desc(dOh, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);

    // dK += dS^T Q (scaled at the end), dS split
    split_fragment(dp, hi, lo);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<HD>(dk_acc, hi + 4 * kk, mnmajor_desc(Qs, kk));
      wgmma_rs<HD>(dk_acc, lo + 4 * kk, mnmajor_desc(Qs, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk_acc);

    __syncthreads();  // every warp is done with stage st and the statistics
    const int next = it + STAGES;
    if (tid == 0 && next < n_it)
      load_tiles<HD>(smem + L::RING_OFF + st * L::STAGE_BYTES, &qmap, &dohi_map, &dolo_map,
                     ring_bar + st, kvh * G + next / per_head, (q_first + next % per_head) * BQ,
                     b);
  }

  const size_t stride = (size_t)Hkv * HD;
  const size_t base = (size_t)b * Tn * stride + (size_t)kvh * HD;
  store_rows<HD>(dk_acc, dk + base, stride, k0, Tn, scale);
  store_rows<HD>(dv_acc, dv + base, stride, k0, Tn, 1.f);
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap dohi_map,
                  const __grid_constant__ CUtensorMap dolo_map,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const float* __restrict__ lse,
                  const float* __restrict__ D, float* __restrict__ dq, int S, int Tn, int H,
                  int Hkv, float scale_log2, float scale, int causal) {
  using L = QSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* dOh = smem + L::TILE;
  uint8_t* dOl = smem + 2 * L::TILE;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* kv_bar = q_bar + 1;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal tiles first
  const int q_last = min(q0 + BQ, S) - 1;
  int n_kt = (Tn + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, q_last / BK + 1);

  if (tid == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) mbar_init(kv_bar + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_tiles<HD>(Qs, &qmap, &dohi_map, &dolo_map, q_bar, h, q0, b);
    for (int t = 0; t < STAGES && t < n_kt; ++t)
      load_tiles<HD>(smem + L::RING_OFF + t * L::STAGE_BYTES, &kmap, &vmap, nullptr,
                     kv_bar + t, kvh, t * BK, b);
  }

  // this thread's query rows, their statistics, and its key columns in each chunk
  const int row0 = q0 + 16 * warp + lane / 4;
  const int row1 = row0 + 8;
  const int col_in = 2 * (lane % 4);
  const size_t stat = ((size_t)b * H + h) * S;
  const float l2_0 = row0 < S ? lse[stat + row0] * LOG2E : MASKED_LSE;
  const float l2_1 = row1 < S ? lse[stat + row1] * LOG2E : MASKED_LSE;
  const float d0 = row0 < S ? D[stat + row0] : 0.f;
  const float d1 = row1 < S ? D[stat + row1] : 0.f;

  float dq_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_kt; ++t) {
    const int st = t % STAGES;
    const uint32_t phase = (t / STAGES) & 1;
    const int k0 = t * BK;
    const uint8_t* Ks = smem + L::RING_OFF + st * L::STAGE_BYTES;
    const uint8_t* Vs = Ks + L::TILE;
    mbar_wait(kv_bar + st, phase);

    // S = Q K^T and dP = dO V^T (dO_hi, then dO_lo)
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    product_nt<HD>(s, Qs, Ks, false);
    product_nt<HD>(dp, dOh, Vs, false);
    product_nt<HD>(dp, dOl, Vs, true);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS on the fragments: element (query row, key column)
    const bool edge = k0 + BK > Tn || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = exp2f(s[4 * j + e] * scale_log2 - l2_0);
        float p1 = exp2f(s[4 * j + 2 + e] * scale_log2 - l2_1);
        if (edge) {
          const int col = k0 + 8 * j + col_in + e;
          if (col >= Tn || (causal && col > row0)) p0 = 0.f;
          if (col >= Tn || (causal && col > row1)) p1 = 0.f;
        }
        dp[4 * j + e] = p0 * (dp[4 * j + e] - d0);
        dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - d1);
      }
    }

    // dQ += dS K (scaled at the end), dS split
    uint32_t hi[16], lo[16];
    split_fragment(dp, hi, lo);
    fence_regs(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs<HD>(dq_acc, hi + 4 * kk, mnmajor_desc(Ks, kk));
      wgmma_rs<HD>(dq_acc, lo + 4 * kk, mnmajor_desc(Ks, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq_acc);

    __syncthreads();  // every warp is done with stage st
    if (tid == 0 && t + STAGES < n_kt)
      load_tiles<HD>(smem + L::RING_OFF + st * L::STAGE_BYTES, &kmap, &vmap, nullptr,
                     kv_bar + st, kvh, (t + STAGES) * BK, b);
  }

  const size_t stride = (size_t)H * HD;
  store_rows<HD>(dq_acc, dq + (size_t)b * S * stride + (size_t)h * HD, stride, q0, S, scale);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const float* o,
                   const float* dout, const float* lse, float* D, void* do_hi, void* do_lo,
                   float* dq, float* dk, float* dv, int B, int S, int Tn, int H, int Hkv,
                   float scale, int causal, cudaStream_t stream) {
  static std::atomic<bool> kv_done[64], q_done[64];
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  cudaError_t err = repro::allow_smem(bwd_dkdv_kernel<HD>, KvSmem<HD>::BYTES, kv_done);
  if (err != cudaSuccess) return err;
  err = repro::allow_smem(bwd_dq_kernel<HD>, QSmem<HD>::BYTES, q_done);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, kmap, vmap, dohi_map, dolo_map;
  if (!encode_map(encode, &qmap, q, B, S, H, HD) || !encode_map(encode, &kmap, k, B, Tn, Hkv, HD) ||
      !encode_map(encode, &vmap, v, B, Tn, Hkv, HD) ||
      !encode_map(encode, &dohi_map, do_hi, B, S, H, HD) ||
      !encode_map(encode, &dolo_map, do_lo, B, S, H, HD))
    return cudaErrorInvalidValue;
  const int rows = B * S * H;
  bwd_preprocess_kernel<<<(rows + 3) / 4, 128, 0, stream>>>(
      o, dout, D, static_cast<__nv_bfloat16*>(do_hi), static_cast<__nv_bfloat16*>(do_lo), rows,
      S, H, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * LOG2E;
  bwd_dkdv_kernel<HD><<<dim3(B * Hkv, (Tn + BK - 1) / BK), NT, KvSmem<HD>::BYTES, stream>>>(
      kmap, vmap, qmap, dohi_map, dolo_map, lse, D, dk, dv, S, Tn, H, Hkv, scale_log2, scale,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<HD><<<dim3(B * H, (S + BQ - 1) / BQ), NT, QSmem<HD>::BYTES, stream>>>(
      qmap, dohi_map, dolo_map, kmap, vmap, lse, D, dq, S, Tn, H, Hkv, scale_log2, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// bfloat16 q, k and v with hd 64 or 128; o, do (B, S, H*hd), lse (B, H, S)
// float32; scratch D (B, H, S) float32 and do_hi, do_lo (B, S, H, hd)
// bfloat16; outputs dq (B, S, H, hd), dk and dv (B, T, Hkv, hd) float32.
// Every pointer 16-byte aligned.
extern "C" int repro_flash_attn_bwd_sm90(const void* q, const void* k, const void* v,
                                         const float* o, const float* dout, const float* lse,
                                         float* D, void* do_hi, void* do_lo, float* dq, float* dk,
                                         float* dv, int B, int S, int T, int H, int Hkv, int hd,
                                         float scale, int causal, void* stream) {
  if (B == 0 || S == 0 || H == 0 || T == 0) return 0;
  if (T < 0 || Hkv <= 0 || H % Hkv != 0 || (S + BQ - 1) / BQ > 65535 || (T + BK - 1) / BK > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)do_hi | (uintptr_t)do_lo |
       (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return (int)launch<64>(q, k, v, o, dout, lse, D, do_hi, do_lo, dq, dk, dv, B, S, T, H, Hkv,
                             scale, causal, st);
    case 128:
      return (int)launch<128>(q, k, v, o, dout, lse, D, do_hi, do_lo, dq, dk, dv, B, S, T, H,
                              Hkv, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
