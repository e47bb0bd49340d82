// ICM conditional-delta sweep: out[b, s, p] = u[b, p] + sum_q X[b, s, q] C[b, q, p].
//
// Replaces the Pallas TPU kernel src/repro/kernels/icm_sweep/kernel.py
// (sweep_matrix, and sweep / sweep_batch, which are its S = 1 cases).
//
// Bound on the H100: at the main path's shapes (P <= 496) the S = 1
// sweep of the MLN closure reads C once (about 1 MB) and does 2 P^2
// flops, so it is bound by bytes, and at B = 1 by launch latency and the
// latency of one read of C, mostly from L2.  The S = P sweep of the
// entailment matrix does 2 P^3 flops on 2 MB, so it is bound by float32
// operations (no TF32: decisions are taken against TIE_EPS = 1e-5, and
// TF32 would round w_co and the unaries).
//
// Two designs, both true float32 FMAs in one fixed summation order (no
// atomics, no tensor cores), so a launch is bit-reproducible:
//
// * S <= 8 (the closure and batch sweeps, nearly every launch): a
//   mat-vec.  One block of 256 threads for each (32-column slice of p,
//   b).  X[b] is staged once in shared memory.  Thread t reads the
//   columns 4 (t % 8) .. + 3 of the rows q = t / 8 + 32 i with one
//   16-byte load a row, so eight threads read one 128-byte line and a
//   warp four rows; the loads of 8 rows are issued before their FMAs, so
//   a block keeps 32 KB of C in flight.  The 32 partial sums of each
//   output are then added as a tree: two shuffles inside a warp, then
//   the 8 warps in order through shared memory, and u last.  Every
//   thread loads and adds; at P = 496 and B = 1 that is 16 blocks.
// * S > 8 (the entailment matrix, S = P): a register-tiled product.  One
//   block of 128 threads for each 32 x 64 tile of the output (128 blocks
//   at P = 496, about one wave on 132 SMs), 4 x 4 outputs a thread, the
//   X and C tiles brought in by a 3-stage cp.async ring of 32-deep k
//   steps and read from shared memory as 16-byte vectors.  Every output
//   is summed in ascending q.
//
// Rows start 16-byte aligned only when P % 4 == 0 (every bin of the main
// path); other P take the same designs with 4-byte loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

// ---------------------------------------------------------------- S <= 8

constexpr int GV_COLS = 32;             // columns of p a block
constexpr int GV_THREADS = 256;
constexpr int GV_CT = GV_COLS / 4;      // threads along p, 4 columns each
constexpr int GV_RT = GV_THREADS / GV_CT;  // row groups (threads along q)
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_BATCH = 8;             // rows of C in flight a thread
constexpr int GV_MAX_S = 8;
constexpr int GV_SMEM = 40 * 1024;      // X[b] staged whole (S * P * 4 bytes), beside red

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int p, int P) {
  if (VEC) return p < P ? __ldg(reinterpret_cast<const float4*>(row + p)) : make_float4(0, 0, 0, 0);
  float4 v;
  v.x = p < P ? __ldg(row + p) : 0.f;
  v.y = p + 1 < P ? __ldg(row + p + 1) : 0.f;
  v.z = p + 2 < P ? __ldg(row + p + 2) : 0.f;
  v.w = p + 3 < P ? __ldg(row + p + 3) : 0.f;
  return v;
}

template <int SM, bool VEC>
__global__ void __launch_bounds__(GV_THREADS)
    icm_gemv_kernel(const float* __restrict__ u, const float* __restrict__ C,
                    const float* __restrict__ X, float* __restrict__ out, int S, int P) {
  extern __shared__ float xs[];  // X[b]: S x P
  __shared__ float4 red[GV_WARPS][SM][GV_CT];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ct = tid % GV_CT;
  const int rt = tid / GV_CT;
  const int p = blockIdx.x * GV_COLS + 4 * ct;
  const float* Cb = C + (size_t)b * P * P;
  const float* Xb = X + (size_t)b * S * P;

  for (int i = tid; i < S * P; i += GV_THREADS) xs[i] = Xb[i];
  __syncthreads();

  float4 acc[SM];
#pragma unroll
  for (int s = 0; s < SM; ++s) acc[s] = make_float4(0, 0, 0, 0);

  for (int q0 = rt; q0 < P; q0 += GV_RT * GV_BATCH) {
    float4 c[GV_BATCH];
#pragma unroll
    for (int i = 0; i < GV_BATCH; ++i) {
      const int q = q0 + i * GV_RT;
      c[i] = q < P ? load4<VEC>(Cb + (size_t)q * P, p, P) : make_float4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < GV_BATCH; ++i) {
      const int q = q0 + i * GV_RT;
      if (q < P) {
#pragma unroll
        for (int s = 0; s < SM; ++s) {
          if (s < S) {
            const float x = xs[s * P + q];
            acc[s].x = fmaf(x, c[i].x, acc[s].x);
            acc[s].y = fmaf(x, c[i].y, acc[s].y);
            acc[s].z = fmaf(x, c[i].z, acc[s].z);
            acc[s].w = fmaf(x, c[i].w, acc[s].w);
          }
        }
      }
    }
  }

  // the 4 row groups of a warp (lanes 8 apart), then the warps in order
#pragma unroll
  for (int s = 0; s < SM; ++s) {
#pragma unroll
    for (int off = GV_CT; off < 32; off <<= 1) {
      acc[s].x += __shfl_xor_sync(0xffffffffu, acc[s].x, off);
      acc[s].y += __shfl_xor_sync(0xffffffffu, acc[s].y, off);
      acc[s].z += __shfl_xor_sync(0xffffffffu, acc[s].z, off);
      acc[s].w += __shfl_xor_sync(0xffffffffu, acc[s].w, off);
    }
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane < GV_CT) {
#pragma unroll
    for (int s = 0; s < SM; ++s) red[warp][s][lane] = acc[s];
  }
  __syncthreads();
  if (tid < S * GV_CT) {
    const int s = tid / GV_CT, c4 = tid % GV_CT;
    float4 t = red[0][s][c4];
#pragma unroll
    for (int w = 1; w < GV_WARPS; ++w) {
      const float4 r = red[w][s][c4];
      t.x += r.x; t.y += r.y; t.z += r.z; t.w += r.w;
    }
    const int pc = blockIdx.x * GV_COLS + 4 * c4;
    const float4 ub = load4<VEC>(u + (size_t)b * P, pc, P);
    float* o = out + ((size_t)b * S + s) * P;
    const float4 v = make_float4(ub.x + t.x, ub.y + t.y, ub.z + t.z, ub.w + t.w);
    if (VEC) {
      if (pc < P) *reinterpret_cast<float4*>(o + pc) = v;
    } else {
      if (pc < P) o[pc] = v.x;
      if (pc + 1 < P) o[pc + 1] = v.y;
      if (pc + 2 < P) o[pc + 2] = v.z;
      if (pc + 3 < P) o[pc + 3] = v.w;
    }
  }
}

// ----------------------------------------------------------------- S > 8

constexpr int GM_BM = 32;  // rows of the output (s) a block
constexpr int GM_BN = 64;  // columns (p) a block
constexpr int GM_BK = 32;  // depth (q) of a stage
constexpr int GM_STAGES = 3;
constexpr int GM_THREADS = 128;  // 16 along p x 8 along s, 4 x 4 outputs each
constexpr int GM_AS = GM_BK + 4;  // padded row of the X tile (floats)

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;

struct GemmSmem {
  float As[GM_STAGES][GM_BM][GM_AS];  // X tile, [s][q]
  float Bs[GM_STAGES][GM_BK][GM_BN];  // C tile, [q][p]
};

// Stage k-tile kt of X (rows m0.., depth k0..) and C (rows k0.., columns n0..).
template <bool VEC>
__device__ __forceinline__ void gemm_load(GemmSmem& sm, int slot, const float* __restrict__ Xb,
                                          const float* __restrict__ Cb, int S, int P, int m0,
                                          int n0, int k0) {
  const int tid = threadIdx.x;
  if (VEC) {
    // X: 32 rows x 8 vectors; C: 32 rows x 16 vectors
    for (int i = tid; i < GM_BM * (GM_BK / 4); i += GM_THREADS) {
      const int r = i / (GM_BK / 4), c = 4 * (i % (GM_BK / 4));
      const bool live = m0 + r < S && k0 + c < P;
      cp_async16(&sm.As[slot][r][c], live ? Xb + (size_t)(m0 + r) * P + k0 + c : Xb, live);
    }
    for (int i = tid; i < GM_BK * (GM_BN / 4); i += GM_THREADS) {
      const int r = i / (GM_BN / 4), c = 4 * (i % (GM_BN / 4));
      const bool live = k0 + r < P && n0 + c < P;
      cp_async16(&sm.Bs[slot][r][c], live ? Cb + (size_t)(k0 + r) * P + n0 + c : Cb, live);
    }
  } else {
    for (int i = tid; i < GM_BM * GM_BK; i += GM_THREADS) {
      const int r = i / GM_BK, c = i % GM_BK;
      const bool live = m0 + r < S && k0 + c < P;
      cp_async4(&sm.As[slot][r][c], live ? Xb + (size_t)(m0 + r) * P + k0 + c : Xb, live);
    }
    for (int i = tid; i < GM_BK * GM_BN; i += GM_THREADS) {
      const int r = i / GM_BN, c = i % GM_BN;
      const bool live = k0 + r < P && n0 + c < P;
      cp_async4(&sm.Bs[slot][r][c], live ? Cb + (size_t)(k0 + r) * P + n0 + c : Cb, live);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(GM_THREADS)
    icm_gemm_kernel(const float* __restrict__ u, const float* __restrict__ C,
                    const float* __restrict__ X, float* __restrict__ out, int S, int P) {
  __shared__ __align__(16) GemmSmem sm;
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * GM_BM;
  const int n0 = blockIdx.x * GM_BN;
  const int tx = threadIdx.x % 16;  // columns n0 + 4 tx .. + 3
  const int ty = threadIdx.x / 16;  // rows m0 + 4 ty .. + 3
  const float* Xb = X + (size_t)b * S * P;
  const float* Cb = C + (size_t)b * P * P;
  const int nk = (P + GM_BK - 1) / GM_BK;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

#pragma unroll
  for (int st = 0; st < GM_STAGES - 1; ++st) {
    if (st < nk) gemm_load<VEC>(sm, st, Xb, Cb, S, P, m0, n0, st * GM_BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GM_STAGES - 2>();
    __syncthreads();  // tile kt is in; every thread is done with tile kt - 1
    const int next = kt + GM_STAGES - 1;
    if (next < nk) gemm_load<VEC>(sm, next % GM_STAGES, Xb, Cb, S, P, m0, n0, next * GM_BK);
    cp_async_commit();

    const int slot = kt % GM_STAGES;
#pragma unroll
    for (int kk = 0; kk < GM_BK; kk += 4) {
      float4 a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&sm.As[slot][4 * ty + i][kk]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bv[q] = *reinterpret_cast<const float4*>(&sm.Bs[slot][kk + q][4 * tx]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(x, bv[q].x, acc[i][0]);
          acc[i][1] = fmaf(x, bv[q].y, acc[i][1]);
          acc[i][2] = fmaf(x, bv[q].z, acc[i][2]);
          acc[i][3] = fmaf(x, bv[q].w, acc[i][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int n = n0 + 4 * tx;
  const float4 ub = load4<VEC>(u + (size_t)b * P, n, P);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= S) continue;
    float* o = out + ((size_t)b * S + m) * P;
    const float4 v = make_float4(ub.x + acc[i][0], ub.y + acc[i][1], ub.z + acc[i][2],
                                 ub.w + acc[i][3]);
    if (VEC) {
      if (n < P) *reinterpret_cast<float4*>(o + n) = v;
    } else {
      if (n < P) o[n] = v.x;
      if (n + 1 < P) o[n + 1] = v.y;
      if (n + 2 < P) o[n + 2] = v.z;
      if (n + 3 < P) o[n + 3] = v.w;
    }
  }
}

template <int SM, bool VEC>
int launch_gemv(const float* u, const float* C, const float* X, float* out, int B, int S,
                int P, cudaStream_t stream) {
  const dim3 grid((P + GV_COLS - 1) / GV_COLS, B, 1);
  const size_t smem = sizeof(float) * (size_t)S * P;
  icm_gemv_kernel<SM, VEC><<<grid, GV_THREADS, smem, stream>>>(u, C, X, out, S, P);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch(const float* u, const float* C, const float* X, float* out, int B, int S, int P,
           cudaStream_t stream) {
  if (S <= GV_MAX_S && sizeof(float) * (size_t)S * P <= GV_SMEM) {
    if (S == 1) return launch_gemv<1, VEC>(u, C, X, out, B, S, P, stream);
    return launch_gemv<GV_MAX_S, VEC>(u, C, X, out, B, S, P, stream);
  }
  const dim3 grid((P + GM_BN - 1) / GM_BN, (S + GM_BM - 1) / GM_BM, B);
  icm_gemm_kernel<VEC><<<grid, GM_THREADS, 0, stream>>>(u, C, X, out, S, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_icm_sweep(const float* u, const float* C, const float* X,
                               float* out, int B, int S, int P, void* stream) {
  if (B == 0 || S == 0 || P == 0) return 0;
  if (B > 65535 || (S + GM_BM - 1) / GM_BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = P % 4 == 0 && ((uintptr_t)u | (uintptr_t)C | (uintptr_t)X |
                                      (uintptr_t)out) % 16 == 0;
  return aligned ? launch<true>(u, C, X, out, B, S, P, st)
                 : launch<false>(u, C, X, out, B, S, P, st);
}
