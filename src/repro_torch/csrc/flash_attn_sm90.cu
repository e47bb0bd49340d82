// Grouped-query softmax attention on Hopper's tensor cores (wgmma + TMA):
//   out[b, s, h*hv + d] = sum_t softmax_t(scale * q[b,s,h,:] . k[b,t,h/G,:]) v[b,t,h/G,d]
// with G = H / Hkv query heads for each KV head.  q (B, S, H, hq), k (B, T,
// Hkv, hq) and v (B, T, Hkv, hv), all contiguous bfloat16 with (hq, hv) =
// (64, 64), (128, 128) or MLA's own (96, 64), unpadded; out (B, S, H*hv)
// float32.  Causal attention keeps row >= col, both counted from 0
// (top-left aligned, also when S != T).  Other types and head dims take
// flash_attn.cu; kernels/flash_attn/ops.py chooses.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn/kernel.py
// (flash_attention), for the serving path's bf16 prefills and the training
// path's forward.
//
// Bound on the H100: 2 B H (hq + hv) flops for each (row, col) score the
// mask keeps, and q, k and v read once and the output written once.  At
// Yi-6B's long prompt (S = T = 4096, 32 heads, hd 128, causal) that is 137
// GFLOP, 0.139 ms against the 989 TFLOP/s of the 16-bit tensor cores; at
// MiniCPM3's training call (B = 4, S = T = 2048, 40 heads, 96/64) 0.109 ms;
// at short prompts the bytes bound it.  Each product is done once.
//
// P.V in fp16: the product multiplies 16-bit operands, and one bf16 P passes
// the 2e-3 contract at short rows (tests/test_torch_flash_fwd_rounding.py
// emulates it: up to 1.4e-3 of the output's largest value); fp16 keeps 11
// significant bits to bf16's 8, and one fp16 P against V in fp16 stays
// within 1.6e-4 at every phase-2 shape.  P (in [0, 1]) goes unscaled; V
// takes 2^e, e = 15 - E with max |v| < 2^E over each 64-key tile of each
// (b, KV head), which converts bf16 values exactly.  A power-of-two scale
// changes no bit of a product, so the result is that of one scale for the
// whole tensor, with no pass to find its maximum and no atomics: the
// accumulator is kept in units of the current tile's scale (before a tile's
// product it is multiplied by 2^(e_t - e_(t-1)) with the softmax's
// rescaling, exactly, and the output by 2^-e of the last tile; it stays
// finite while no two tiles' largest |v| lie more than 2^90 apart).
//
// Design: plan_v16 picks one of two ways to V's fp16 tiles from the shapes.
// * A grid of more than 4 blocks an SM: a first launch, fwd_v16_kernel,
//   copies V to fp16 with each tile's scale and writes the exponents to a
//   table; each tile is then converted once, however many blocks read it.
//   The attention kernel is launched as its programmatic dependent, so its
//   blocks start (barriers, Q and K loads) while the copy ends, and wait for
//   it before their first V load.
// * A smaller grid (a few short prompts, Whisper's cross attention): each
//   block converts each V tile in shared memory after it lands (the tile's
//   maximum from one exchange between the warps), so one launch does it.
// * The attention kernel: one block of one warpgroup (128 threads) for each
//   (b*H + h, 64-row query tile); warp w owns query rows 16w .. 16w + 15.
//   It reads q and k (bf16) and V (the fp16 copy, or bf16) in place through
//   4-D tensor maps (hd, heads, positions, batch), encoded on the host for
//   each call and passed as __grid_constant__ parameters, so a call
//   captured in a CUDA graph stays valid.  The KV head h / G is a
//   coordinate of the map, and the maps' zero fill pads a ragged S and T.
//   A tile 64 or 128 wide is boxes of 64 columns in the 128-byte swizzle,
//   MLA's 96 three boxes of 32 in the 64-byte swizzle (sm90.cuh Cols, as the
//   backward's).  K and V go through rings of 2 stages, each stage with its
//   own mbarrier, refilled after the block barrier that ends the tile that
//   freed it.
// * S = Q K^T: wgmma m64n64k16 in bf16 into a float32 accumulator (hq / 16
//   k-steps), K K-major in shared memory; Q, loaded once, is K-major in
//   shared memory too, but at hd 128 with the fp16 copy it is wgmma's
//   register A operand, read from global memory: the k-steps then read only
//   K from shared memory, and without Q's tile three blocks fit an SM.  The
//   scores are scaled into log2 units, masked (col >= T, and col > row
//   under the causal mask) only on tiles that cross T or the diagonal, and
//   the online softmax runs on the accumulator fragment: a row lives in a
//   quad of threads, so two shuffles give its maximum.  NEG_INF = -1e30
//   stays finite, so exp(m_old - m_new) is never inf - inf, and the
//   denominator is clamped at 1e-30.  The row sum is taken from the float32
//   probabilities.
// * O += P V: wgmma in register form, fp16: the probabilities' fragment,
//   converted to fp16 pairs, is wgmma's A register fragment as it stands;
//   the V tile is the MN-major B operand, n = hv.
// * Overlap: tile t + 1's scores are issued before tile t's P.V, and tile
//   t + 1's softmax runs while P.V's products do.  Tried and slower
//   (PERF.md §6): each step to completion; two warpgroups a block on
//   128 query rows sharing each K, V tile; a refill by the last warp in
//   place of the block barrier; 3 stages at hv 64; a fifth block an SM.
// * Order: the grid walks groups of 16 heads (all heads where S > 2048),
//   in each the longest causal tiles first, so that the K and V tiles the
//   running blocks read stay in L2; the walk stops at the first key tile
//   past the block's last row.
// * Shared memory: two stages of K and two of V, and Q's tile but at hd 128
//   with the copy: 64 KB at hd 128 (three blocks an SM; 80 KB with Q, two),
//   52 KB at MLA's (96, 64), 40 KB at hd 64 (four); the dynamic limit is
//   raised once per device at the first launch, so a launch captured in a
//   graph makes no attribute call.  repro_flash_attn_sm90_instances reports
//   each instance's blocks per SM, registers, shared bytes and spills as
//   the card's runtime gives them.
// * Row statistics: given an lse buffer (the training path's forward,
//   kernels/flash_attn/ops.py FlashAttention), each row's natural
//   log-sum-exp is written from the final running maximum and sum, for the
//   backward (flash_attn_bwd_sm90.cu) to recompute P; the serving path
//   passes null and writes nothing more.  No float atomics: two calls on one
//   input give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <climits>

#include "sm90.cuh"
#include "smem.cuh"

namespace {

using namespace sm90;

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;      // query rows a block (one warpgroup)
constexpr int BK = 64;      // key rows a tile
constexpr int NT = 128;     // threads a block
constexpr int STAGES = 2;   // K and V rings
constexpr int V16_THREADS = 256;  // threads a block of the copy (one key tile)
// |e| of a tile's scale at most 60 (a tile's max |v| >= 2^-45 keeps its
// bits), so that the change 2^(e - e') between two tiles is a normal float
constexpr int E_RANGE = 60;
static_assert(BQ == BOX_ROWS && BK == BOX_ROWS, "a tile is one TMA box of rows");

// Q as the scores' register A operand, not a shared-memory tile (above)
template <int HQ, bool V16>
__host__ __device__ constexpr bool q_in_registers() { return HQ == 128 && V16; }

template <int HQ, int HV, bool V16>
struct Smem {
  static constexpr int Q_BYTES = q_in_registers<HQ, V16>() ? 0 : Cols<HQ>::tile(BQ);
  static constexpr int K_TILE = Cols<HQ>::tile(BK);
  static constexpr int V_TILE = Cols<HV>::tile(BK);
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * V_TILE;
  // the barriers, and slack to align the tiles to 1024 bytes (the swizzle's period)
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(K_OFF % 1024 == 0 && V_OFF % 1024 == 0 && K_TILE % 1024 == 0 &&
                V_TILE % 1024 == 0, "each tile starts a 1024-byte swizzle atom");
};

// Blocks an SM the compiler plans registers for: three (at most 168
// registers a thread), but two at hd 128 without the fp16 copy, where
// shared memory allows no more (and the small grids that take that
// instance do not fill three).
template <int HV, bool V16>
__host__ __device__ constexpr int min_blocks() { return HV == 128 && !V16 ? 2 : 3; }

// 2^x on the special function unit (subnormal results flush to 0: a
// probability under 2^-126 adds nothing)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// V (B, T, Hkv, HV) bf16 -> v16, the same layout in fp16, each 64-key tile
// of each (b, KV head) times 2^e (e = 15 - E, max |v| < 2^E over the tile;
// 0 for an all-zero tile) into vexp[(b * Hkv + kvh) * n_tiles + tile].  One
// block a tile (blockIdx.x) of a (b, KV head) (blockIdx.y); 16-byte loads.
// Its blocks let the attention kernel start at once: that waits for the
// whole grid before it reads a V tile.
template <int HV>
__global__ void __launch_bounds__(V16_THREADS)
    fwd_v16_kernel(const __nv_bfloat16* __restrict__ v, __half* __restrict__ v16,
                   int* __restrict__ vexp, int Tn, int Hkv) {
  constexpr int PER_ROW = HV / 8;                  // 16-byte pieces of a row
  constexpr int PER_THREAD = BK * PER_ROW / V16_THREADS;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tile = blockIdx.x;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  uint4 x[PER_THREAD];
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int idx = threadIdx.x + V16_THREADS * i;
    const int r = tile * BK + idx / PER_ROW;
    x[i] = make_uint4(0, 0, 0, 0);
    if (r < Tn) {
      x[i] = *reinterpret_cast<const uint4*>(v + (((size_t)b * Tn + r) * Hkv + kvh) * HV +
                                             8 * (idx % PER_ROW));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
  }
  m = block_max(m);
  const int e = m == 0.f ? 0 : max(-E_RANGE, min(E_RANGE, 15 - bits_exp(__float_as_uint(m))));
  const float mul = pow2(e);
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int idx = threadIdx.x + V16_THREADS * i;
    const int r = tile * BK + idx / PER_ROW;
    if (r < Tn) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x[i]);
      uint32_t out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        out[j] = half2_bits(f.x * mul, f.y * mul);
      }
      *reinterpret_cast<uint4*>(v16 + (((size_t)b * Tn + r) * Hkv + kvh) * HV +
                                8 * (idx % PER_ROW)) = make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
  if (threadIdx.x == 0) vexp[(size_t)blockIdx.y * gridDim.x + tile] = e;
}

template <int HQ, int HV, bool V16>
__global__ void __launch_bounds__(NT, min_blocks<HV, V16>())
    flash_attn_sm90_kernel(const __grid_constant__ CUtensorMap qmap, const uint32_t* qg,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, const int* vexp,
                           float* __restrict__ out, float* __restrict__ lse, int S, int Tn,
                           int H, int Hkv, float scale_log2, int causal, int group) {
  using L = Smem<HQ, HV, V16>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* Ks = smem + L::K_OFF;
  uint8_t* Vs = smem + L::V_OFF;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* k_bar = q_bar + 1;
  uint64_t* v_bar = k_bar + STAGES;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // the block's (b * H + h, query tile): groups of `group` heads in turn,
  // in each the longest causal tiles first, the group's heads side by side
  const int nq = (S + BQ - 1) / BQ;
  const int g0 = blockIdx.x / (group * nq) * group;      // the group's first head
  const int gh = min(group, (int)(gridDim.x / nq) - g0);  // heads in the group
  const int r = blockIdx.x - g0 * nq;
  const int qt = r / gh;
  const int bh = g0 + r % gh;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = (nq - 1 - qt) * BQ;  // longest causal tiles first
  const int q_last = min(q0 + BQ, S) - 1;
  const int n_kt = (Tn + BK - 1) / BK;  // key tiles of the tensor: vexp's rows
  const int n_tiles = causal ? min(n_kt, q_last / BK + 1) : n_kt;  // later tiles are dead
  const int* exps = V16 ? vexp + (size_t)(b * Hkv + kvh) * n_kt : nullptr;

  // key tile t of K, or of V, into its ring stage (thread 0 only)
  auto load_k = [&](int t) {
    mbar_expect_tx(k_bar + t % STAGES, L::K_TILE);
    load_tile<HQ, BK>(Ks + (t % STAGES) * L::K_TILE, &kmap, k_bar + t % STAGES, kvh, t * BK, b);
  };
  auto load_v = [&](int t) {
    mbar_expect_tx(v_bar + t % STAGES, L::V_TILE);
    load_tile<HV, BK>(Vs + (t % STAGES) * L::V_TILE, &vmap, v_bar + t % STAGES, kvh, t * BK, b);
  };

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
    if constexpr (!q_in_registers<HQ, V16>()) {
      mbar_expect_tx(q_bar, L::Q_BYTES);
      load_tile<HQ, BQ>(Qs, &qmap, q_bar, h, q0, b);
    }
    for (int t = 0; t < STAGES && t < n_tiles; ++t) load_k(t);
  }
  // the copy's launch runs ahead of this one (programmatic dependent
  // launch): its V tiles and scales are complete past this wait
  if constexpr (V16) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (tid == 0)
    for (int t = 0; t < STAGES && t < n_tiles; ++t) load_v(t);

  // This thread's rows of the tile, and its columns in each 8-column chunk.
  const int row0 = q0 + 16 * warp + lane / 4;
  const int row1 = row0 + 8;
  const int col_in = 2 * (lane % 4);

  float o[HV / 2];  // m64nHV accumulator: chunk j holds (row0, 8j + col_in + {0,1}), (row1, ...)
#pragma unroll
  for (int i = 0; i < HV / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running maxima (log2 units)
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the running sums
  float s[BK / 2];                   // a tile's scores, then its probabilities
  uint32_t p16[BK / 4];              // the probabilities as P.V's fp16 A fragment
  int e_prev = 0;                    // the scale exponent o is kept in

  // with Q in registers: its rows row0, row1 as the A fragment of the
  // scores' k-steps (bf16 pairs: k-step kk holds chunks 2 kk, 2 kk + 1)
  uint32_t qf[q_in_registers<HQ, V16>() ? HQ / 4 : 1];
  if constexpr (q_in_registers<HQ, V16>()) {
    const uint32_t* r0p = qg + (((size_t)b * S + row0) * H + h) * (HQ / 2);
    const uint32_t* r1p = qg + (((size_t)b * S + row1) * H + h) * (HQ / 2);
#pragma unroll
    for (int c = 0; c < HQ / 8; ++c) {
      qf[2 * c] = row0 < S ? r0p[(8 * c + col_in) / 2] : 0u;
      qf[2 * c + 1] = row1 < S ? r1p[(8 * c + col_in) / 2] : 0u;
    }
  }
  // S = Q K^T of tile t into s, and O += P V of tile t (each issued and
  // committed, not waited for; the caller waited for the tile to land)
  auto issue_scores = [&](int t) {
    if constexpr (q_in_registers<HQ, V16>()) {
      const uint8_t* kt = Ks + (t % STAGES) * L::K_TILE;
#pragma unroll
      for (int kk = 0; kk < HQ / 16; ++kk)
        wgmma_rs_n64_kmajor(s, qf + 4 * kk, kmajor_desc<HQ, BK>(kt, 0, kk), kk > 0);
    } else {
      product_nt<HQ, BQ, false>(s, Qs, 0, Ks + (t % STAGES) * L::K_TILE);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int t) {
    product_rs<HV>(o, p16, Vs + (t % STAGES) * L::V_TILE);
    wgmma_commit();
  };
  auto k_landed = [&](int t) { mbar_wait(k_bar + t % STAGES, (t / STAGES) & 1); };
  auto v_landed = [&](int t) { mbar_wait(v_bar + t % STAGES, (t / STAGES) & 1); };
  // tile t's scores in s -> its probabilities (in s), the running maxima
  // and sums updated; returns o's rescaling for the new maxima
  auto softmax = [&](int t) {
    const int k0 = t * BK;
    const bool edge = k0 + BK > Tn || (causal && k0 + BK - 1 > q0);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x0 = s[4 * j + c] * scale_log2;
        float x1 = s[4 * j + 2 + c] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + col_in + c;
          if (col >= Tn || (causal && col > row0)) x0 = NEG_INF;
          if (col >= Tn || (causal && col > row1)) x1 = NEG_INF;
        }
        s[4 * j + c] = x0;
        s[4 * j + 2 + c] = x1;
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
    const float a0 = fast_exp2(m0 - mn0), a1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[4 * j] = fast_exp2(s[4 * j] - mn0);
      s[4 * j + 1] = fast_exp2(s[4 * j + 1] - mn0);
      s[4 * j + 2] = fast_exp2(s[4 * j + 2] - mn1);
      s[4 * j + 3] = fast_exp2(s[4 * j + 3] - mn1);
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    return make_float2(a0, a1);
  };
  // o's rescaling before a tile's product: the softmax's, times the change
  // to the tile's V scale exponent e (powers of two: exact); then p16 <- P
  auto rescale = [&](int e, float2 a) {
    const float r = pow2(e - e_prev);
    e_prev = e;
    const float r0 = a.x * r, r1 = a.y * r;
#pragma unroll
    for (int j = 0; j < HV / 8; ++j) {
      o[4 * j] *= r0;
      o[4 * j + 1] *= r0;
      o[4 * j + 2] *= r1;
      o[4 * j + 3] *= r1;
    }
    half_fragment(s, 1.f, p16);
  };

  // Without the fp16 copy (!V16): V tile t as it landed (bf16) -> fp16
  // times 2^e in place, e from the tile's largest |v| (one exchange between
  // the warps); returns e.  The caller's next block barrier orders the
  // writes before wgmma reads them.
  __shared__ uint32_t warp_max[NT / 32];
  auto convert_v = [&](int t) {
    constexpr int N = L::V_TILE / 16 / NT;  // 16-byte pieces a thread
    uint8_t* tile = Vs + (t % STAGES) * L::V_TILE;
    uint4 x[N];
    uint32_t m = 0;  // |v|'s bf16 bits, two at a time
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[i] = *reinterpret_cast<const uint4*>(tile + 16 * (tid + NT * i));
      m = __vmaxu2(m, __vmaxu2(__vmaxu2(x[i].x & 0x7fff7fffu, x[i].y & 0x7fff7fffu),
                               __vmaxu2(x[i].z & 0x7fff7fffu, x[i].w & 0x7fff7fffu)));
    }
    m = __reduce_max_sync(0xffffffffu, max(m & 0xffffu, m >> 16));
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    m = warp_max[0];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) m = max(m, warp_max[w]);
    const int e = m == 0 ? 0 : max(-E_RANGE, min(E_RANGE, 15 - bits_exp(m << 16)));
    const float mul = pow2(e);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x[i]);
      uint32_t y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        y[j] = half2_bits(f.x * mul, f.y * mul);
      }
      *reinterpret_cast<uint4*>(tile + 16 * (tid + NT * i)) = make_uint4(y[0], y[1], y[2], y[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    return e;
  };

  // Tile 0's scores and probabilities; then, for each tile t, tile t + 1's
  // scores issued before tile t's P.V, and tile t + 1's softmax (and,
  // without the fp16 copy, its V's conversion) run while P.V's products do.
  if constexpr (!q_in_registers<HQ, V16>()) mbar_wait(q_bar, 0);
  int e_next = V16 ? exps[0] : 0;  // the next tile's V scale, loaded a tile ahead
  k_landed(0);
  fence_regs(s);
  wgmma_fence();
  issue_scores(0);
  wgmma_wait<0>();
  fence_regs(s);
  const float2 a0 = softmax(0);
  if constexpr (!V16) {
    v_landed(0);
    e_next = convert_v(0);
  }
  rescale(e_next, a0);
  __syncthreads();  // K stage 0 is free for tile 2
  if (tid == 0 && STAGES < n_tiles) load_k(STAGES);
  int t = 0;
  for (; t + 1 < n_tiles; ++t) {
    if constexpr (V16) e_next = exps[t + 1];
    k_landed(t + 1);
    v_landed(t);
    fence_regs(s);
    fence_regs(o);
    fence_regs(p16);
    wgmma_fence();
    issue_scores(t + 1);
    issue_pv(t);
    wgmma_wait<1>();
    fence_regs(s);
    const float2 a = softmax(t + 1);
    if constexpr (!V16) {
      v_landed(t + 1);
      e_next = convert_v(t + 1);
    }
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p16);
    rescale(e_next, a);
    __syncthreads();  // every warp is done with K stage of t + 1 and V stage of t
    if (tid == 0) {
      if (t + 1 + STAGES < n_tiles) load_k(t + 1 + STAGES);
      if (t + STAGES < n_tiles) load_v(t + STAGES);
    }
  }
  v_landed(t);  // the last tile's P.V
  fence_regs(o);
  fence_regs(p16);
  wgmma_fence();
  issue_pv(t);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(p16);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float unscale = pow2(-e_prev);
  const float inv0 = unscale / fmaxf(l0, 1e-30f), inv1 = unscale / fmaxf(l1, 1e-30f);
  if (lse != nullptr && lane % 4 == 0) {  // natural log-sum-exp of the scaled, masked row
    const float ln2 = 0.6931471805599453f;
    float* dst = lse + ((size_t)b * H + h) * S;
    if (row0 < S) dst[row0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * ln2;
    if (row1 < S) dst[row1] = (m1 + log2f(fmaxf(l1, 1e-30f))) * ln2;
  }
  const size_t row_step = (size_t)H * HV;
  if (row0 < S) {
    float* dst = out + ((size_t)b * S + row0) * row_step + (size_t)h * HV + col_in;
#pragma unroll
    for (int j = 0; j < HV / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
  }
  if (row1 < S) {
    float* dst = out + ((size_t)b * S + row1) * row_step + (size_t)h * HV + col_in;
#pragma unroll
    for (int j = 0; j < HV / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// Whether a call takes the fp16 copy of V, from its shapes alone: a grid of
// more than 4 blocks an SM does; a smaller one converts each V tile in
// shared memory, where the copy's launch would cost more than it saves.
bool plan_v16(int B, int S, int H) {
  return (long)B * H * ((S + BQ - 1) / BQ) > 4L * sm_count();
}

// The heads whose blocks run side by side (the grid's order: a group's
// query tiles, longest first, then the next group's): 16 where a head has
// at most 32 query tiles, so that the K and V tiles the running blocks read
// stay in the 50 MB L2; all heads for longer ones, where a group's longest
// tiles, started late, would end after the rest.
int head_group(int B, int H, int nq) { return nq <= 32 ? std::min(16, B * H) : B * H; }

template <int HQ, int HV, bool V16>
cudaError_t launch_with(const void* q, const void* k, const void* v, void* v16, int* vexp,
                        float* out, float* lse, int B, int S, int Tn, int H, int Hkv,
                        float scale, int causal, cudaStream_t stream) {
  using L = Smem<HQ, HV, V16>;
  const auto kernel = flash_attn_sm90_kernel<HQ, HV, V16>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  static std::atomic<bool> done[64];
  cudaError_t err = repro::allow_smem(kernel, L::BYTES, done);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, kmap, vmap;
  if (!encode_cols<HQ>(encode, &qmap, q, B, S, H, false) ||
      !encode_cols<HQ>(encode, &kmap, k, B, Tn, Hkv, false) ||
      !encode_cols<HV>(encode, &vmap, V16 ? v16 : v, B, Tn, Hkv, V16))
    return cudaErrorInvalidValue;
  if (V16) {
    const int n_kt = (Tn + BK - 1) / BK;
    fwd_v16_kernel<HV><<<dim3(n_kt, B * Hkv), V16_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(v), static_cast<__half*>(v16), vexp, Tn, Hkv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const float log2e = 1.4426950408889634f;
  const int nq = (S + BQ - 1) / BQ;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H * nq);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = V16 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, qmap, static_cast<const uint32_t*>(q), kmap, vmap,
                            static_cast<const int*>(vexp), out,
                            lse, S, Tn, H, Hkv, scale * log2e, causal, head_group(B, H, nq));
}

template <int HQ, int HV>
cudaError_t launch(const void* q, const void* k, const void* v, void* v16, int* vexp,
                   float* out, float* lse, int B, int S, int Tn, int H, int Hkv, float scale,
                   int causal, cudaStream_t stream) {
  return plan_v16(B, S, H)
             ? launch_with<HQ, HV, true>(q, k, v, v16, vexp, out, lse, B, S, Tn, H, Hkv, scale,
                                         causal, stream)
             : launch_with<HQ, HV, false>(q, k, v, v16, vexp, out, lse, B, S, Tn, H, Hkv, scale,
                                          causal, stream);
}

// One kernel's occupancy as the runtime gives it: blocks per SM, registers
// a thread, shared bytes a block, local (spilled) bytes a thread.
template <int HQ, int HV, bool V16>
cudaError_t instance_row(int* out) {
  using L = Smem<HQ, HV, V16>;
  const auto kernel = flash_attn_sm90_kernel<HQ, HV, V16>;
  out[0] = HQ;
  out[1] = HV;
  out[2] = V16;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::BYTES);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, NT, L::BYTES);
  out[4] = a.numRegs;
  out[5] = L::BYTES + (int)a.sharedSizeBytes;
  out[6] = (int)a.localSizeBytes;
  return err;
}

}  // namespace

// Whether a call of these shapes takes the fp16 copy of v (1) or converts
// v in shared memory (0), so that the caller allocates the copy only where
// it is written.
extern "C" int repro_flash_attn_sm90_plan(int B, int S, int H) { return plan_v16(B, S, H); }

// bfloat16 q, k (hq) and v (hv) with (hq, hv) = (64, 64), (128, 128) or
// (96, 64); where the plan takes the copy, scratch v16 (v's shape, fp16) and
// vexp (B * Hkv * ceil(T / 64) int32), else both may be null; out (B, S,
// H*hv) float32; lse, when not null, (B, H, S) float32: each row's natural
// log-sum-exp of its scaled, masked scores, which the backward
// (flash_attn_bwd_sm90.cu) reads.  Every pointer 16-byte aligned.
extern "C" int repro_flash_attn_sm90(const void* q, const void* k, const void* v, void* v16,
                                     int* vexp, float* out, float* lse, int B, int S, int T,
                                     int H, int Hkv, int hq, int hv, float scale, int causal,
                                     void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (T <= 0 || Hkv <= 0 || H % Hkv != 0 || (long)B * H * ((S + BQ - 1) / BQ) > INT_MAX ||
      B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (plan_v16(B, S, H) && (v16 == nullptr || vexp == nullptr))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)v16 | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hq == 64 && hv == 64)
    return (int)launch<64, 64>(q, k, v, v16, vexp, out, lse, B, S, T, H, Hkv, scale, causal, st);
  if (hq == 128 && hv == 128)
    return (int)launch<128, 128>(q, k, v, v16, vexp, out, lse, B, S, T, H, Hkv, scale, causal,
                                 st);
  if (hq == 96 && hv == 64)
    return (int)launch<96, 64>(q, k, v, v16, vexp, out, lse, B, S, T, H, Hkv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// Rows of 7 ints, one for each kernel instance (at most max_rows): hq, hv,
// whether it reads the fp16 copy, blocks per SM, registers a thread, shared
// bytes a block, local (spill) bytes a thread.  Returns the number of rows
// written, or minus a CUDA error.
extern "C" int repro_flash_attn_sm90_instances(int* out, int max_rows) {
  if (max_rows < 6) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  int n = 0;
  for (auto row : {instance_row<64, 64, true>, instance_row<128, 128, true>,
                   instance_row<96, 64, true>, instance_row<64, 64, false>,
                   instance_row<128, 128, false>, instance_row<96, 64, false>})
    if (err == cudaSuccess) err = row(out + 7 * n++);
  return err == cudaSuccess ? n : -(int)err;
}
