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
// * Row statistics: given an lse buffer (the training path's forward,
//   kernels/flash_attn/ops.py FlashAttention), each row's natural
//   log-sum-exp is written from the final running maximum and sum, for the
//   backward (flash_attn_bwd_sm90.cu) to recompute P; the serving path
//   passes null and writes nothing more.  The Hopper building blocks this
//   kernel shares with the backward are in sm90.cuh.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90.cuh"
#include "smem.cuh"

namespace {

using namespace sm90;

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;      // query rows a block (one warpgroup)
constexpr int BK = 64;      // key rows a tile
constexpr int NT = 128;     // threads a block
constexpr int STAGES = 2;   // K/V ring
constexpr int KSTEPS = BK / 16;  // wgmma k-steps of the P.V product
static_assert(BQ == BOX_ROWS && BK == BOX_ROWS, "a tile is one TMA box of rows");

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
                           float* __restrict__ lse, int S, int Tn, int H, int Hkv,
                           float scale_log2, int causal) {
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
  if (lse != nullptr && lane % 4 == 0) {  // natural log-sum-exp of the scaled, masked row
    const float ln2 = 0.6931471805599453f;
    float* dst = lse + ((size_t)b * H + h) * S;
    if (row0 < S) dst[row0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * ln2;
    if (row1 < S) dst[row1] = (m1 + log2f(fmaxf(l1, 1e-30f))) * ln2;
  }
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

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, float* out, float* lse, int B,
                   int S, int Tn, int H, int Hkv, float scale, int causal, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  static std::atomic<bool> done[64];
  cudaError_t err = repro::allow_smem(flash_attn_sm90_kernel<HD>, Smem<HD>::BYTES, done);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, kmap, vmap;
  if (!encode_map(encode, &qmap, q, B, S, H, HD) || !encode_map(encode, &kmap, k, B, Tn, Hkv, HD) ||
      !encode_map(encode, &vmap, v, B, Tn, Hkv, HD))
    return cudaErrorInvalidValue;
  const dim3 grid(B * H, (S + BQ - 1) / BQ, 1);
  const float log2e = 1.4426950408889634f;
  flash_attn_sm90_kernel<HD><<<grid, NT, Smem<HD>::BYTES, stream>>>(
      qmap, kmap, vmap, out, lse, S, Tn, H, Hkv, scale * log2e, causal);
  return cudaGetLastError();
}

}  // namespace

// bfloat16 q, k and v with hd 64 or 128; every pointer 16-byte aligned.  lse,
// when not null, (B, H, S) float32: each row's natural log-sum-exp of its
// scaled, masked scores, which the backward (flash_attn_bwd_sm90.cu) reads.
extern "C" int repro_flash_attn_sm90(const void* q, const void* k, const void* v, float* out,
                                     float* lse, int B, int S, int T, int H, int Hkv, int hd,
                                     float scale, int causal, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (T <= 0 || Hkv <= 0 || H % Hkv != 0 || (S + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return (int)launch<64>(q, k, v, out, lse, B, S, T, H, Hkv, scale, causal, st);
    case 128: return (int)launch<128>(q, k, v, out, lse, B, S, T, H, Hkv, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
