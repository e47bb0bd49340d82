// Thresholded n-gram cosine similarity: out[m, n] = s if s >= threshold else 0,
// s = sum_f A[m, f] B[n, f].  A (M, F), B (N, F), out (M, N), all float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ngram_sim/kernel.py
// (sim_above, and sim_matrix, which is its threshold = -2 case).
//
// Bound on the H100: the paths' calls are small.  The canopy probe is
// M = 1 against N = 818 or 1,024 rows of F = 128: it reads B once (420-
// 512 KB, 0.16 us at 3.35 TB/s).  The stream's probe is M = 59-68 against
// N = 65-1,697: at most 0.4 us of float32 FMAs.  Both are far below the
// time of a launch, so what bounds them is latency: how many SMs a launch
// reaches, how many loads each block has in flight at once, and the chain
// of F dependent FMAs that every output sums.  The all-pairs form (M and
// N ~ 10^3, on no path) is a float32 GEMM, bound by operations.
//
// Precision: every output is summed in ascending f with fmaf, from 0, in
// true float32 (no TF32, no tensor cores, no split over f, no atomics).
// The order is part of the contract: canopy membership and the stream's
// probe edges are decided at t_loose and t_tight, and a cosine one ulp to
// either side of one changes a canopy and the exact batch and stream
// tables.  A zero-filled f beyond F adds fmaf(0, 0, acc) == acc.
//
// Design: one tile kernel.  A block owns a BM x BN tile of the output and
// stages its A and B rows in shared memory, 128 f at a time, with 16-byte
// cp.async copies (at F = 128 that is the whole row: one wait and one
// barrier a launch).  A staged row is padded to 132 floats, so the 8 lanes of a
// quarter warp that read 16 bytes of 8 consecutive rows hit distinct
// banks.  Each thread owns TM rows and TN columns of the tile (rows
// ty + i * BM / TM, columns tx + j * BN / TN, so neighbouring threads
// store neighbouring columns) and reads 4 f of each with one 16-byte
// shared load.  The tile is sized so that the paths' shapes fill the card:
// * M <= 8 (the canopy probe): 8 x 8 tiles of 32 threads, so N = 1,024
//   gives 128 blocks on 132 SMs;
// * 8 < M < 256 (the stream's probe): 16 x 32 tiles of 128 threads, 4
//   outputs a thread: 120 blocks at M = 64, N = 936;
// * M >= 256 (all pairs): 64 x 64 tiles of 256 threads, 4 x 4 outputs a
//   thread, 67,584 bytes of shared memory a block.
// The copies are 16 bytes wide when F % 4 == 0 and A and B start 16-byte
// aligned (rows of F = 128 floats are 512 bytes, so the paths' row slices
// are); otherwise the same kernel stages its tiles with 4-byte copies.

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int FK = 128;      // f staged at once
constexpr int ROW = FK + 4;  // a staged row, padded (floats)

template <int BM, int BN, int TM, int TN>
struct Tile {
  static constexpr int TX = BN / TN;  // threads along n
  static constexpr int TY = BM / TM;  // threads along m
  static constexpr int THREADS = TX * TY;
  static constexpr int SMEM = (int)sizeof(float) * (BM + BN) * ROW;
};

// Stage f0 .. f0 + FK - 1 of rows r0 .. r0 + R - 1 of X (rows of F floats)
// in S[R][ROW], zero past the last row and past F.
template <int R, int NT, bool VEC>
__device__ __forceinline__ void stage(float* S, const float* __restrict__ X, int rows,
                                      int F, int r0, int f0) {
  constexpr int W = VEC ? 4 : 1;  // floats a copy
  static_assert(R * FK % (W * NT) == 0, "a tile's copies split evenly over its threads");
#pragma unroll
  for (int it = 0; it < R * FK / (W * NT); ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / (FK / W), c = W * (i % (FK / W));
    const bool live = r0 + r < rows && f0 + c < F;
    const float* src = live ? X + (size_t)(r0 + r) * F + f0 + c : X;
    if (VEC) {
      repro::cp_async16(S + r * ROW + c, src, live);
    } else {
      repro::cp_async4(S + r * ROW + c, src, live);
    }
  }
}

template <int BM, int BN, int TM, int TN, bool VEC>
__global__ void __launch_bounds__(Tile<BM, BN, TM, TN>::THREADS)
    ngram_sim_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ out, int M, int N, int F, float threshold) {
  using T = Tile<BM, BN, TM, TN>;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;             // [BM][ROW]
  float* Bs = smem + BM * ROW;  // [BN][ROW]
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % T::TX;
  const int ty = threadIdx.x / T::TX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  for (int f0 = 0; f0 < F; f0 += FK) {
    if (f0 > 0) __syncthreads();  // every thread is done with the last slice
    stage<BM, T::THREADS, VEC>(As, A, M, F, m0, f0);
    stage<BN, T::THREADS, VEC>(Bs, B, N, F, n0, f0);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int k = 0; k < FK; k += 4) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + i * T::TY) * ROW + k);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const float4*>(Bs + (tx + j * T::TX) * ROW + k);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * T::TY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * T::TX;
      if (m < M && n < N) {
        const float s = acc[i][j];
        out[(size_t)m * N + n] = s >= threshold ? s : 0.f;
      }
    }
  }
}

// Raise a tile's dynamic shared memory limit once per device, at its first
// launch there, so that a launch captured into a CUDA graph later makes no
// attribute call.
template <int BM, int BN, int TM, int TN, bool VEC>
cudaError_t allow_smem() {
  static std::atomic<bool> done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(ngram_sim_kernel<BM, BN, TM, TN, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<BM, BN, TM, TN>::SMEM);
  if (err == cudaSuccess && dev < 64) done[dev].store(true);
  return err;
}

template <int BM, int BN, int TM, int TN, bool VEC>
cudaError_t launch(const float* A, const float* B, float* out, int M, int N, int F,
                   float threshold, cudaStream_t stream) {
  using T = Tile<BM, BN, TM, TN>;
  if ((M + BM - 1) / BM > 65535) return cudaErrorInvalidValue;
  if (T::SMEM > 48 * 1024) {
    const cudaError_t err = allow_smem<BM, BN, TM, TN, VEC>();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, 1);
  ngram_sim_kernel<BM, BN, TM, TN, VEC>
      <<<grid, T::THREADS, T::SMEM, stream>>>(A, B, out, M, N, F, threshold);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t route(const float* A, const float* B, float* out, int M, int N, int F,
                  float threshold, cudaStream_t stream) {
  if (M <= 8) return launch<8, 8, 2, 1, VEC>(A, B, out, M, N, F, threshold, stream);
  if (M < 256) return launch<16, 32, 4, 1, VEC>(A, B, out, M, N, F, threshold, stream);
  return launch<64, 64, 4, 4, VEC>(A, B, out, M, N, F, threshold, stream);
}

}  // namespace

extern "C" int repro_ngram_sim(const float* A, const float* B, float* out,
                               int M, int N, int F, float threshold,
                               void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = F % 4 == 0 && ((uintptr_t)A | (uintptr_t)B) % 16 == 0;
  return (int)(vec ? route<true>(A, B, out, M, N, F, threshold, st)
                   : route<false>(A, B, out, M, N, F, threshold, st));
}
